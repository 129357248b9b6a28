"""Port parity: the flash attention's plain version and the LM's
gradient-free attention path.

The same numpy inputs go through the JAX package (its Pallas kernel in
interpret mode, its dense reference, its model with the chunked eager
attention) and through the port (``kernels/ref.py::flash_attention_ref``,
which the wrapper in ``kernels/ops.py`` takes for CPU tensors, and the
model with its flash path). Tolerances: f32 2e-5 (summation order: XLA's
dot against torch's einsum) and bf16 2e-2 (a bf16 ulp of |o| ~ 1), as
``tests/test_flash_attn.py`` holds the Pallas kernel to its reference;
the LM within the port's LM tolerance (``tests/test_torch_train.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import LaneConfig as JLane  # noqa: E402
from repro.configs import ShapeConfig, reduced as jreduced  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attn import flash_attention as jflash  # noqa: E402
from repro.sharding.rules import ShardingRules  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import LaneConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import api, zo  # noqa: E402
from repro_torch.data.synthetic import token_batch  # noqa: E402
from repro_torch.kernels import flash_attn, ops  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.serve import Engine, SamplingParams, ServeConfig  # noqa: E402
from repro_torch.train.train_loop import init_state  # noqa: E402

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
LM_TOL = dict(rtol=1e-3, atol=1e-4)


def _qkv(B, H, Hkv, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Sq, D)).astype(np.float32) * 0.3,
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32) * 0.3,
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32))


def _port(q, k, v, **kw):
    t = [torch.from_numpy(a) for a in (q, k, v)]
    return ops.flash_attention(*t, **kw).numpy()


# ------------------------------------------------------------------ #
# the plain version against the Pallas kernel and JAX's reference
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,win", [
    (1, 2, 128, 128, 64, True, 0),
    (2, 1, 256, 256, 128, True, 0),
    (1, 1, 128, 256, 64, False, 0),      # cross-attention shape
    (1, 2, 256, 256, 64, True, 128),     # sliding window
    (1, 1, 384, 384, 128, True, 0),
])
def test_flash_ref_matches_pallas_kernel(B, H, Sq, Sk, D, causal, win):
    q, k, v = _qkv(B, H, H, Sq, Sk, D, Sq + Sk + D)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=win, interpret=True)
    got = _port(q, k, v, causal=causal, window=win)
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)


def test_flash_ref_bf16_matches_pallas_kernel():
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(1, 2, 128, 64)).astype(np.float32)
               for _ in range(3))
    want = jflash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                  interpret=True)
    got = ops.flash_attention(*(torch.from_numpy(a).bfloat16()
                                for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


@pytest.mark.parametrize("causal,win", [(True, 0), (True, 5), (False, 0)])
def test_flash_ref_gqa_matches_jax_with_repeated_kv(causal, win):
    """H 4 over Hkv 2: q head h reads kv head h // 2, JAX's reference on
    K/V repeated along the heads."""
    q, k, v = _qkv(2, 4, 2, 33, 33, 16, 7)
    want = jref.flash_attention_ref(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, axis=1),
        jnp.repeat(jnp.asarray(v), 2, axis=1), causal=causal, window=win)
    got = _port(q, k, v, causal=causal, window=win)
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("Sq,Sk,causal,win", [
    (100, 100, True, 0), (100, 100, True, 17), (100, 77, False, 0),
    (100, 40, True, 8),                  # rows past Sk + 7 see no key
])
def test_flash_ref_ragged_and_strided_views(Sq, Sk, causal, win):
    """Lengths off any tile size, and q/k/v as the model passes them:
    transposed views of [B, S, heads, D] tensors."""
    q, k, v = _qkv(1, 4, 2, Sq, Sk, 16, Sq * Sk)
    views = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
             .transpose(1, 2) for a in (q, k, v)]
    assert not views[0].is_contiguous() and views[0].stride(-1) == 1
    got = ops.flash_attention(*views, causal=causal, window=win).numpy()
    want = jref.flash_attention_ref(
        jnp.asarray(q), *(jnp.repeat(jnp.asarray(a), 2, axis=1)
                          for a in (k, v)), causal=causal, window=win)
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)


def test_flash_attention_refuses_inputs_that_require_grad():
    q, k, v = (torch.zeros(1, 2, 8, 16) for _ in range(3))
    with pytest.raises(ValueError, match="no backward"):
        ops.flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad(), pytest.raises(ValueError, match="no backward"):
        ops.flash_attention(q, k, v)
    assert not torch.isnan(ops.flash_attention(q.detach(), k, v)).any()


def test_flash_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises; it never computes on the
    CPU."""
    x = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attn.flash_attention(x, x, x)


# ------------------------------------------------------------------ #
# the LM: the flash path against JAX's chunked eager attention
# ------------------------------------------------------------------ #
def _lm(seq_len, kind):
    jcfg = jreduced(JARCHS["qwen3-4b"], dtype="float32")
    shape = ShapeConfig("t", seq_len=seq_len, global_batch=2, kind=kind)
    m = japi.build(jcfg, shape, JLane(lane="elastic_zo", bp_tail_layers=1),
                   ShardingRules(None, jcfg, shape))
    params = m.init(jax.random.key(0))
    cfg = configs.reduced(configs.ARCHS["qwen3-4b"], dtype="float32")
    return m, params, cfg, params_from_jax(jax.tree.map(np.asarray, params),
                                           "cpu", torch.float32)


class _Count:
    """Counts calls of ops.flash_attention and of the chunked attention,
    through the names the model looks up at call time."""

    def __init__(self, monkeypatch):
        self.flash = self.chunked = 0
        flash, chunked = ops.flash_attention, layers._chunked_self_attention

        def f(*a, **k):
            self.flash += 1
            return flash(*a, **k)

        def c(*a, **k):
            self.chunked += 1
            return chunked(*a, **k)
        monkeypatch.setattr(ops, "flash_attention", f)
        monkeypatch.setattr(layers, "_chunked_self_attention", c)


def test_reduced_lm_prefill_flash_path_matches_jax(monkeypatch):
    m, jparams, cfg, params = _lm(12, "prefill")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    last = np.array([11, 6], np.int32)
    jl, jdense = jax.jit(m.prefill_logits)(
        jparams, {"tokens": jnp.asarray(toks)}, jnp.asarray(last))
    count = _Count(monkeypatch)
    tl, tdense = api.prefill_logits(params, cfg, torch.from_numpy(toks),
                                    torch.from_numpy(last))
    assert (count.flash, count.chunked) == (cfg.num_layers, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LM_TOL)
    for half in ("zo", "bp"):
        for entry, jentry in zip(tdense[half], jdense[half]):
            for name in ("k", "v"):
                np.testing.assert_allclose(entry[name].numpy(),
                                           np.asarray(jentry[name]), **LM_TOL)


def test_reduced_lm_train_forward_flash_path_matches_jax(monkeypatch):
    """The train-mode loss with every layer gradient-free (all flash) and
    with the tail differentiated (flash in the ZO head, the chunked path
    in the tail) against JAX's loss_fn, which attends eagerly."""
    m, jparams, cfg, params = _lm(16, "train")
    x, y, mk = token_batch(2, 16, cfg.vocab_size, seed=1, step=0)
    want = float(jax.jit(m.loss_fn)(jparams, {
        "tokens": jnp.asarray(x), "labels": jnp.asarray(y),
        "mask": jnp.asarray(mk)}))
    batch = {"tokens": torch.from_numpy(x), "labels": torch.from_numpy(y),
             "mask": torch.from_numpy(mk)}
    count = _Count(monkeypatch)
    with torch.no_grad():
        got = float(api.loss_fn(params, cfg, batch))
    assert (count.flash, count.chunked) == (cfg.num_layers, 0)
    np.testing.assert_allclose(got, want, **LM_TOL)
    tail = zo.map_with_path(
        lambda p, t: t.detach().requires_grad_(p[0] == "periods_bp"), params)
    count.flash = count.chunked = 0
    loss = api.loss_fn(tail, cfg, batch)
    loss.backward()
    assert (count.flash, count.chunked) == (cfg.num_layers - 1, 1)
    np.testing.assert_allclose(float(loss.detach()), want, **LM_TOL)


@pytest.mark.parametrize("lane_kw,flash,chunked", [
    (dict(lane="elastic_zo"), 2, 2),
    (dict(lane="elastic_zo", fused_probes=True), 2, 2),
    (dict(lane="elastic_zo", bp_grad_mode="clean"), 3, 3),
    (dict(lane="full_zo"), 4, 0),
    (dict(lane="full_bp"), 0, 2),
])
def test_attention_paths_per_probe(monkeypatch, lane_kw, flash, chunked):
    """Calls per probe on the reduced qwen3-4b (2 layers: 1 ZO period, 1
    tail period): the flash kernel twice per ZO period (the +eps and -eps
    forwards; a third for bp_grad_mode "clean"), none in the BP tail,
    whose attention autograd differentiates (full_bp: both layers)."""
    probes = 2 if lane_kw["lane"] != "full_bp" else 1
    lane = LaneConfig(bp_tail_layers=1, zo_num_probes=probes, **lane_kw)
    cfg = configs.reduced(configs.ARCHS["qwen3-4b"], dtype="float32")
    state = init_state(api.init(cfg, lane, seed=2, device="cpu"), seed=3)
    x, y, mk = token_batch(2, 16, cfg.vocab_size, seed=1, step=0)
    batch = {"tokens": torch.from_numpy(x), "labels": torch.from_numpy(y),
             "mask": torch.from_numpy(mk)}
    step = api.make_train_step(cfg, lane)
    count = _Count(monkeypatch)
    step(state, batch, np.ones((probes,), np.float32))
    assert (count.flash, count.chunked) == (flash * probes, chunked * probes)


def test_serving_prefills_through_flash(monkeypatch):
    """Layers x prefill calls: every prefill attends through the kernel;
    decode goes through the paged kernel."""
    cfg = configs.reduced(configs.ARCHS["qwen3-4b"], dtype="float32")
    eng = Engine(cfg, ServeConfig(page_size=4, num_pages=32,
                                  max_batch_slots=2, max_seq_len=32,
                                  max_new_tokens=5, megastep=2),
                 device="cpu")
    prefills = []
    prefill = api.prefill_logits

    def counted(*a, **k):
        prefills.append(a[2].shape)
        return prefill(*a, **k)
    monkeypatch.setattr(api, "prefill_logits", counted)
    count = _Count(monkeypatch)
    for n in (4, 9, 6):
        eng.submit(list(range(1, n + 1)), SamplingParams(), 5)
    out = eng.run()
    assert len(out) == 3 and len(prefills) >= 2
    assert count.flash == cfg.num_layers * len(prefills)
    assert count.chunked == 0
