"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. On the machine
with the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``. Imports nothing of JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.benchmarks.bench_util import ulps  # noqa: E402
from repro_torch.core import api, zo  # noqa: E402
from repro_torch.data.synthetic import token_batch  # noqa: E402
from repro_torch.kernels import (flash_attn, int8_matmul,  # noqa: E402
                                 paged_attn, ref, topk_mask, zo_fused_replay,
                                 zo_perturb)
from repro_torch.models.transformer import tree_map  # noqa: E402
from repro_torch.serve import Engine, SamplingParams, ServeConfig  # noqa: E402
from repro_torch.train.train_loop import init_state  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _paged_case(dev, dtype, B, KVd, G, Dh, ps, P, seq_lens, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    N = 1 + sum(-(-(n + 1) // ps) for n in seq_lens)
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dtype)  # noqa: E731
    table = torch.zeros((B, P), dtype=torch.int32)
    perm = (torch.randperm(N - 1, generator=g) + 1).tolist()
    for b, n in enumerate(seq_lens):
        if n:                                   # seq_len 0: inactive row
            for lp in range(n // ps + 1):
                table[b, lp] = perm.pop()
    return (rnd(B, KVd, G, Dh), rnd(B, KVd, Dh), rnd(B, KVd, Dh),
            rnd(N, ps, KVd, Dh), rnd(N, ps, KVd, Dh), table.to(dev),
            torch.tensor(seq_lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("shape", [(2, 2, 16, 4), (8, 4, 128, 16)])
def test_paged_kernel_matches_plain(dev, dtype, tol, window, shape):
    KVd, G, Dh, ps = shape
    lens = [0, 3, 17, 40, 1, 63]
    q, kn, vn, kp, vp, table, sl = _paged_case(dev, dtype, len(lens), KVd, G,
                                               Dh, ps, 64 // ps + 1, lens)
    if window:                       # reclaim pages fully out of window
        for b, n in enumerate(lens):
            for lp in range(n // ps + 1):
                if (lp + 1) * ps - 1 <= n - window:
                    table[b, lp] = 0
    kp2, vp2 = kp.clone(), vp.clone()
    o = paged_attn.paged_attention_step(q, kn, vn, kp, vp, table, sl,
                                        scale=Dh ** -0.5, window=window)
    want = ref.paged_attn_step_ref(q, kn, vn, kp2, vp2, table, sl,
                                   scale=Dh ** -0.5, window=window)
    torch.cuda.synchronize()
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)
    assert (o[1:].float() - want[1:].float()).abs().max().item() <= tol
    assert o[0].abs().max().item() == 0.0       # inactive row


@pytest.mark.parametrize("V", [256, 51968, 64000, 65536, 152064])
def test_topk_kernel_matches_plain(dev, V):
    g = torch.Generator(device="cpu").manual_seed(V)
    x = torch.randn(6, V, generator=g) * 3
    x[2] = torch.round(x[2])
    x[3, ::5] = -0.0
    x = x.to(dev)
    k = torch.tensor([50, 0, 20, 1, 0, V], dtype=torch.int32, device=dev)
    p = torch.tensor([0.95, 1.0, 0.8, 1.0, 0.5, 0.3], device=dev)
    got = topk_mask.topk_topp_mask(x, k, p)
    again = topk_mask.topk_topp_mask(x, k, p)
    want = ref.topk_topp_mask_ref(x, k, p)
    assert torch.equal(got, again)               # fixed reduction order
    assert torch.equal(got > -5e29, want > -5e29)
    assert torch.equal(got, want)


def _paged_check(dev, dtype, KVd, G, Dh, ps, P, lens, window=0, nan=False):
    """The cluster kernel against its plain version: the KV write bitwise,
    active rows within the dtype's tolerance, inactive rows 0, o bitwise
    the same on a second call. With ``nan``, every pool slot that is not
    a live position of some row (reclaimed pages, the null page, slots
    past seq_len or before the window) holds NaN for the kernel and 0 for
    the plain version, which reads them under a mask."""
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    q, kn, vn, kp, vp, table, sl = _paged_case(dev, dtype, len(lens), KVd, G,
                                               Dh, ps, P, lens)
    if window:                       # reclaim pages fully out of window
        for b, n in enumerate(lens):
            for lp in range(n // ps + 1):
                if (lp + 1) * ps - 1 <= n - window:
                    table[b, lp] = 0
    if nan:
        live = torch.zeros(kp.shape[:2], dtype=torch.bool, device=dev)
        for b, n in enumerate(lens):
            lo = max(0, n - window + 1) if window else 0
            for t in range(lo, n + 1):
                page = int(table[b, t // ps])
                if page:
                    live[page, t % ps] = True
        dead = ~live[:, :, None, None]
        kp.masked_fill_(dead, float("nan"))
        vp.masked_fill_(dead, float("nan"))
    kp2, vp2 = kp.nan_to_num(0.0), vp.nan_to_num(0.0)
    kp3, vp3 = kp.clone(), vp.clone()
    o = paged_attn.paged_attention_step(q, kn, vn, kp, vp, table, sl,
                                        scale=Dh ** -0.5, window=window)
    again = paged_attn.paged_attention_step(q, kn, vn, kp3, vp3, table, sl,
                                            scale=Dh ** -0.5, window=window)
    want = ref.paged_attn_step_ref(q, kn, vn, kp2, vp2, table, sl,
                                   scale=Dh ** -0.5, window=window)
    torch.cuda.synchronize()
    assert torch.equal(kp.nan_to_num(0.0), kp2)
    assert torch.equal(vp.nan_to_num(0.0), vp2)
    assert torch.equal(o, again)                # fixed combine order
    active = [b for b, n in enumerate(lens) if n]
    assert bool(torch.isfinite(o).all())
    assert (o[active].float() - want[active].float()).abs().max().item() \
        <= tol
    for b, n in enumerate(lens):
        if not n:
            assert o[b].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("positions,lens", [
    (4096, [0, 4095, 2049, 511, 512, 3000]),      # full clusters of 8
    (32768, [32767, 20000, 0]),                   # many tiles a warp
])
def test_paged_cluster_long_tables(dev, dtype, positions, lens):
    plan = paged_attn.plan(positions // 16, 16, 4, 128, 2)
    assert plan.cluster == 8
    _paged_check(dev, dtype, 2, 4, 128, 16, positions // 16, lens)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_cluster_split_boundaries(dev, dtype):
    P = 34                                        # the serve path's table
    split = paged_attn.plan(P, 16, 4, 128, 2).split
    lens = [split - 1, split, split + 1, 2 * split - 1, 2 * split,
            2 * split + 1, 1, 0]
    _paged_check(dev, dtype, 2, 4, 128, 16, P, lens)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Dh", [(1, 128), (8, 64), (8, 256)])
def test_paged_cluster_group_sizes(dev, dtype, G, Dh):
    _paged_check(dev, dtype, 3, G, Dh, 16, 20, [0, 5, 100, 319, 64])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 37])
def test_paged_cluster_never_reads_dead_slots(dev, dtype, window):
    _paged_check(dev, dtype, 4, 4, 128, 16, 34, [0, 140, 270, 400, 530, 31],
                 window=window, nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KVd,G,Dh,P,lens", [
    (12, 1, 64, 29, [0, 70, 140, 200, 270, 330, 390, 447]),       # Whisper
    (8, 7, 128, 215, [0, 3010, 3100, 3200, 3300, 3050, 3390, 3423]),
], ids=["whisper", "llava"])
def test_paged_cluster_encdec_geometries(dev, dtype, KVd, G, Dh, P, lens):
    """The serve decode steps of whisper-small (12 KV heads, one query
    head each, Dh 64, 448 positions) and LLaVA (G = 7, which the kernel
    computes as 8 with a zero head, behind 2,880 image tokens)."""
    _paged_check(dev, dtype, KVd, G, Dh, 16, P, lens)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_cluster_equal_lengths(dev, dtype):
    _paged_check(dev, dtype, 8, 4, 128, 16, 34, [300] * 8)


def _topk_case(dev, B, V, k, p, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(B, V, generator=g) * 3 / 0.8
    x[::3] = torch.round(x[::3])                  # long tied runs
    x[1::4, ::7] = -0.0
    x[1::4, 1::7] = 0.0
    x = x.to(dev)
    k = torch.tensor(k, dtype=torch.int32, device=dev)
    p = torch.tensor(p, dtype=torch.float32, device=dev)
    got = topk_mask.topk_topp_mask(x, k, p)
    again = topk_mask.topk_topp_mask(x, k, p)
    want = ref.topk_topp_mask_ref(x, k, p)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got > -5e29, want > -5e29)
    assert torch.equal(got, want)


@pytest.mark.parametrize("V", [200064, 152101, 13313])
@pytest.mark.parametrize("B", [1, 16])
def test_topk_cluster_vocab_and_batch(dev, B, V):
    """200,064: phi4-mini's vocab; 152,101: not a multiple of 4 (the
    scalar path) with an uneven last slice; 13,313: one entry past a
    single CTA's slice, a cluster of 2."""
    plan = topk_mask.plan(V)
    assert plan.cluster == (2 if V == 13313 else 16)
    ks = [50, 0, 20, 1, 0, V, 1000, 7] * 2
    ps = [0.95, 1.0, 0.8, 1.0, 0.5, 0.3, 0.99, 0.9] * 2
    _topk_case(dev, B, V, ks[:B], ps[:B], seed=V + B)


@pytest.mark.parametrize("knobs", ["greedy", "sampled"])
def test_topk_cluster_uniform_batches(dev, knobs):
    k, p = (0, 1.0) if knobs == "greedy" else (50, 0.95)
    _topk_case(dev, 8, 152064, [k] * 8, [p] * 8, seed=3)


def _zo_records(dev, steps=3, probes=2, seed=0):
    rng = np.random.default_rng(seed)
    seeds = zo.device_seeds(rng.integers(0, 2**32, steps * probes), dev)
    coeffs = torch.from_numpy((rng.normal(size=(steps, probes)) * 1e-3)
                              .astype(np.float32)).to(dev)
    return seeds.reshape(steps, probes), coeffs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,skip", [(4099, 0), (4099, 1), (3, 0)])
def test_zo_kernels_match_plain_bitwise(dev, dtype, n, skip):
    """skip = 1 starts the leaf off 16-byte alignment (the scalar path)."""
    g = torch.Generator(device=dev).manual_seed(n)
    theta = torch.randn(n + skip, generator=g, device=dev, dtype=dtype)[skip:]
    seeds, coeffs = _zo_records(dev)
    assert torch.equal(zo_perturb.zo_perturb(theta, seeds[0, :1], 77, -1e-3),
                       ref.zo_perturb_ref(theta, seeds[0, :1], 77, -1e-3))
    fused = zo_fused_replay.zo_fused_replay(theta, seeds, coeffs, 77)
    assert torch.equal(fused, ref.zo_fused_replay_ref(theta, seeds, coeffs,
                                                      77))
    live = theta.clone()
    for s in range(seeds.shape[0]):
        zo_fused_replay.zo_fused_replay(live, seeds[s:s + 1],
                                        coeffs[s:s + 1], 77, out=live)
    assert torch.equal(live, fused)


def test_zo_kernels_refuse_what_they_do_not_take(dev):
    seeds, coeffs = _zo_records(dev)
    x = torch.zeros(8, 8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        zo_perturb.zo_perturb(x.t(), seeds[0, :1], 1, 1e-3)
    with pytest.raises(ValueError, match="dtype"):
        zo_perturb.zo_perturb(x.half(), seeds[0, :1], 1, 1e-3)
    with pytest.raises(ValueError, match="int32"):
        zo_fused_replay.zo_fused_replay(x, seeds.cpu(), coeffs, 1)
    with pytest.raises(ValueError, match="coeffs"):
        zo_fused_replay.zo_fused_replay(x, seeds, coeffs[:1], 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zo_perturb_offset_slices_equal_the_whole_leaf(dev, dtype):
    """A period's slice perturbed at offset p * size is bitwise the whole
    stacked leaf's perturbation of that slice, and its plain version."""
    g = torch.Generator(device=dev).manual_seed(3)
    stacked = torch.randn(5, 37, 11, generator=g, device=dev, dtype=dtype)
    seeds, _ = _zo_records(dev)
    whole = zo_perturb.zo_perturb(stacked, seeds[0, :1], 91, 1e-3)
    size = stacked[0].numel()
    for p in range(5):
        got = zo_perturb.zo_perturb(stacked[p], seeds[0, :1], 91, 1e-3,
                                    p * size)
        assert torch.equal(got, whole[p])
        assert torch.equal(got, ref.zo_perturb_ref(stacked[p], seeds[0, :1],
                                                   91, 1e-3, p * size))
    with pytest.raises(ValueError, match="2\\*\\*32"):
        zo_perturb.zo_perturb(stacked[0], seeds[0, :1], 91, 1e-3,
                              2**32 - size + 1)


# a rank's shard of a leaf: (global shape, spec, mesh sizes, coordinates),
# giving index maps of one level (a contiguous run, the offset form), one
# strided level, two and three levels, runs the 16-byte vector does and
# does not divide, and an innermost stride of 2
SHARD_CASES = [
    ((8, 64), ("data", None), {"data": 4, "model": 1},
     {"data": 2, "model": 0}, 1),
    ((4, 8, 2), (None, None, "model"), {"data": 1, "model": 2},
     {"data": 0, "model": 1}, 1),
    ((64, 48), ("model", "data"), {"data": 2, "model": 2},
     {"data": 1, "model": 1}, 2),
    ((64, 40), (None, "model"), {"data": 1, "model": 4},
     {"data": 0, "model": 3}, 2),
    ((6, 40, 24), (None, "data", "model"), {"data": 2, "model": 2},
     {"data": 1, "model": 1}, 3),
    ((5, 16, 12, 20), (None, "data", "model", None),
     {"data": 2, "model": 2}, {"data": 0, "model": 1}, 3),
    ((3, 8, 16, 64), (None, "model", None, "data"),
     {"data": 2, "model": 2}, {"data": 1, "model": 0}, 3),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(SHARD_CASES)))
def test_zo_kernels_shard_form_matches_plain_bitwise(dev, dtype, case):
    """The shard forms (an index map, sharding/params.py::shard_desc)
    bitwise their plain versions, and the whole leaf's kernel output
    sliced."""
    from repro_torch.sharding.params import shard_desc
    shape, spec, sizes, coords, levels = SHARD_CASES[case]
    d = shard_desc(shape, spec, coords, sizes)
    assert len(d.index.levels) == levels
    g = torch.Generator(device=dev).manual_seed(case)
    whole = torch.randn(shape, generator=g, device=dev, dtype=dtype)
    theta = whole[d.slices].contiguous()
    seeds, coeffs = _zo_records(dev)
    got = zo_perturb.zo_perturb(theta, seeds[0, :1], 77, -1e-3, index=d.index)
    assert torch.equal(got, ref.zo_perturb_ref(theta, seeds[0, :1], 77, -1e-3,
                                               index=d.index))
    assert torch.equal(got, zo_perturb.zo_perturb(whole, seeds[0, :1], 77,
                                                  -1e-3)[d.slices])
    fused = zo_fused_replay.zo_fused_replay(theta, seeds, coeffs, 77,
                                            index=d.index)
    assert torch.equal(fused, ref.zo_fused_replay_ref(theta, seeds, coeffs,
                                                      77, index=d.index))
    assert torch.equal(fused, zo_fused_replay.zo_fused_replay(
        whole, seeds, coeffs, 77)[d.slices])
    live = theta.clone()
    for s in range(seeds.shape[0]):
        zo_fused_replay.zo_fused_replay(live, seeds[s:s + 1], coeffs[s:s + 1],
                                        77, out=live, index=d.index)
    assert torch.equal(live, fused)


def test_zo_kernels_refuse_a_map_past_2_32(dev):
    from repro_torch.core.prng import IndexMap
    seeds, coeffs = _zo_records(dev)
    x = torch.zeros(4, 8, device=dev)
    with pytest.raises(ValueError, match="elements"):
        zo_perturb.zo_perturb(x, seeds[0, :1], 1, 1e-3,
                              index=IndexMap(0, ((4, 16), (4, 1))))
    with pytest.raises(ValueError, match="three levels"):
        zo_fused_replay.zo_fused_replay(
            x, seeds, coeffs, 1,
            index=IndexMap(0, ((2, 999), (2, 99), (2, 9), (4, 1))))
    # a map past 2**32 wraps (prng.IndexMap): the shard form draws at
    # each index mod 2**32, as the plain version does
    past = IndexMap(2**32 - 8, ((4, 8), (8, 1)))
    x = torch.randn(4, 8, device=dev)
    assert torch.equal(
        zo_perturb.zo_perturb(x, seeds[0, :1], 1, 1e-3, index=past),
        ref.zo_perturb_ref(x, seeds[0, :1], 1, 1e-3, index=past))
    assert torch.equal(
        zo_fused_replay.zo_fused_replay(x, seeds, coeffs, 1, index=past),
        ref.zo_fused_replay_ref(x, seeds, coeffs, 1, index=past))


# (B, H, Hkv, Sq, Sk, D, causal, window); q/k/v are transposed views of
# [B, S, heads, D] tensors, as the model passes them, but in the last case
FLASH_CASES = [
    (1, 4, 2, 100, 100, 16, True, 0),     # the reduced model, ragged S
    (2, 4, 2, 100, 77, 16, False, 0),     # Sq != Sk, no mask
    (1, 2, 2, 256, 256, 64, True, 0),
    (1, 4, 1, 130, 130, 64, True, 33),    # GQA 4:1, window, ragged
    (1, 8, 2, 200, 200, 128, True, 0),
    (1, 2, 2, 100, 40, 128, True, 8),     # rows past Sk + 7 see no key
    (2, 4, 4, 64, 300, 128, False, 50),   # a window without causality
    (1, 4, 2, 192, 192, 128, True, 0),    # contiguous [B, H, S, D]
]


# Whisper (12 heads of 64): the encoder over 1,500 frames, the prefill's
# cross-attention, the decode tick's one query a slot; LLaVA's prefill
# (56 / 8 heads of 128) behind 2,880 image tokens
FLASH_ENCDEC_CASES = [
    (1, 12, 12, 1500, 1500, 64, False, 0),
    (2, 12, 12, 128, 1500, 64, False, 0),
    (8, 12, 12, 1, 1500, 64, False, 0),
    (1, 56, 8, 3008, 3008, 128, True, 0),
]


def _bf16_ulp_close(got, want):
    """Both round one f32 result to bf16 once; the f32 sums differ only in
    order, so the two differ by at most one bf16 ulp of |o|."""
    return bool(((got.float() - want.float()).abs()
                 <= 2.0**-7 * want.float().abs() + 1e-6).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(dev, dtype, case):
    B, H, Hkv, Sq, Sk, D, causal, window = case
    g = torch.Generator(device="cpu").manual_seed(Sq * Sk + D)
    model_layout = case is not FLASH_CASES[-1]

    def make(heads, S):
        if model_layout:
            return torch.randn(B, S, heads, D, generator=g).to(
                dev, dtype).transpose(1, 2)
        return torch.randn(B, heads, S, D, generator=g).to(dev, dtype)
    q, k, v = make(H, Sq), make(Hkv, Sk), make(Hkv, Sk)
    got = flash_attn.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    assert got.stride() == q.stride()         # q's layout, no copy back
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        assert _bf16_ulp_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_ENCDEC_CASES)
def test_flash_kernel_matches_plain_encdec_shapes(dev, dtype, case):
    B, H, Hkv, Sq, Sk, D, causal, window = case
    g = torch.Generator(device="cpu").manual_seed(Sq + Sk)
    q, k, v = (torch.randn(B, S, heads, D, generator=g).to(dev, dtype)
               .transpose(1, 2) for heads, S in ((H, Sq), (Hkv, Sk),
                                                 (Hkv, Sk)))
    got = flash_attn.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.stride() == q.stride()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        assert _bf16_ulp_close(got, want)


def _attention_f64(q, k, v, causal, window):
    """The plain version's function evaluated in float64."""
    Sq, Sk, D = q.shape[2], k.shape[2], q.shape[3]
    G = q.shape[1] // k.shape[1]
    k, v = (t.double().repeat_interleave(G, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k) / D ** 0.5
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    seen = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        seen &= k_pos <= q_pos
    if window > 0:
        seen &= k_pos > q_pos - window
    s = torch.where(seen, s, -1e30)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)


@pytest.mark.parametrize("case", [
    (1, 8, 2, 200, 200, 128, True, 0),
    (2, 4, 4, 64, 300, 128, False, 50),
    (1, 4, 1, 130, 130, 64, True, 33),
    (2, 4, 2, 100, 77, 16, False, 0),
])
def test_flash_bf16_large_scores(dev, case):
    """q scaled by 8: scores of large magnitude move the running max often,
    so the rescale of the output accumulator is exercised. The yardstick
    is the attention in float64, within one bf16 ulp of |o|: at these
    scores an f32 score carries an absolute error near 2e-6, so where
    the weighted sum cancels to |o| ~ 1e-5 the f32 plain version itself
    can land more than one ulp from the float64 result (chip_smoke.py
    counts such outputs at seq 4096), and the kernel cannot be held to
    it there."""
    B, H, Hkv, Sq, Sk, D, causal, window = case
    g = torch.Generator(device="cpu").manual_seed(Sq + Sk + D)

    def make(heads, S, s=1.0):
        return (torch.randn(B, S, heads, D, generator=g) * s).to(
            dev, torch.bfloat16).transpose(1, 2)
    q, k, v = make(H, Sq, 8.0), make(Hkv, Sk), make(Hkv, Sk)
    got = flash_attn.flash_attention(q, k, v, causal=causal, window=window)
    want = _attention_f64(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert bool(((got.double() - want).abs()
                 <= 2.0**-7 * want.abs() + 1e-6).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_one_query_row_gqa(dev, dtype):
    """B > 1, H / Hkv = 4, D 128 and Sq = 1: the smallest tile edge."""
    g = torch.Generator(device="cpu").manual_seed(11)
    q = torch.randn(3, 1, 16, 128, generator=g).to(dev, dtype).transpose(1, 2)
    k, v = (torch.randn(3, 45, 4, 128, generator=g).to(dev, dtype)
            .transpose(1, 2) for _ in range(2))
    for causal in (True, False):
        got = flash_attn.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert got.stride() == q.stride()
        if dtype == torch.float32:
            assert (got - want).abs().max().item() <= 1e-5
        else:
            assert _bf16_ulp_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,tp,window", [(4096, 4, 0), (18, 4, 0),
                                         (300, 4, 100), (6, 4, 0)])
def test_flash_query_offset_matches_plain(dev, dtype, S, tp, window):
    """The seq plan's calls: rank r's rows [lo, hi) (blocks of ceil(S /
    tp); 6 rows leave the last rank none, which launches nothing) at
    ``q_offset = lo`` against keys 0 .. hi - 1, each within the plain
    version's tolerance, and at offset 0 bitwise the kernel without an
    offset; where every offset is a multiple of the 128-row query tile
    (S 4096, bf16) the chunks are bitwise the whole call's rows."""
    g = torch.Generator(device="cpu").manual_seed(S + window)
    H, Hkv, D = (32, 8, 128) if S == 4096 else (6, 2, 16)

    def make(heads):
        return torch.randn(1, S, heads, D, generator=g).to(
            dev, dtype).transpose(1, 2)
    q, k, v = make(H), make(Hkv), make(Hkv)
    whole = flash_attn.flash_attention(q, k, v, window=window)
    assert torch.equal(whole, flash_attn.flash_attention(
        q, k, v, window=window, q_offset=0))
    c = -(-S // tp)
    parts = []
    for r in range(tp):
        lo, hi = min(r * c, S), min((r + 1) * c, S)
        if hi == lo:
            continue
        args = (q[:, :, lo:hi], k[:, :, :hi], v[:, :, :hi])
        got = flash_attn.flash_attention(*args, window=window, q_offset=lo)
        want = ref.flash_attention_ref(*args, window=window, q_offset=lo)
        if dtype == torch.float32:
            assert (got - want).abs().max().item() <= 1e-5
        else:
            assert _bf16_ulp_close(got, want)
        parts.append(got)
    if c % 128 == 0 and dtype == torch.bfloat16:
        assert torch.equal(torch.cat(parts, dim=2), whole)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,causal,window", [(300, 300, True, 0),
                                                 (1, 1500, False, 0),
                                                 (100, 40, True, 8)])
def test_flash_lse_matches_plain(dev, dtype, Sq, Sk, causal, window):
    """``return_lse``: the output bitwise the call without it, and each
    row's log-sum-exp within 1e-5 of the plain version's (relative to
    max(1, |lse|); rows that see no key at -1e30 in both)."""
    g = torch.Generator(device="cpu").manual_seed(Sq + Sk)
    H, Hkv, D = (12, 12, 64) if Sq == 1 else (6, 2, 16)

    def make(heads, S):
        return torch.randn(2, S, heads, D, generator=g).to(
            dev, dtype).transpose(1, 2)
    q, k, v = make(H, Sq), make(Hkv, Sk), make(Hkv, Sk)
    kw = dict(causal=causal, window=window)
    o, lse = flash_attn.flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, flash_attn.flash_attention(q, k, v, **kw))
    _, want = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert lse.shape == (2, H, Sq) and lse.dtype == torch.float32
    assert ((lse - want).abs() / lse.abs().clamp(min=1.0)).max() <= 1e-5


def test_flash_kernel_refuses_what_it_does_not_take(dev):
    x = torch.zeros(1, 2, 8, 64, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attn.flash_attention(x[..., :32], x[..., :32], x[..., :32])
    with pytest.raises(ValueError, match="dtypes"):
        flash_attn.flash_attention(x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="Hkv divides H"):
        flash_attn.flash_attention(torch.zeros(1, 3, 8, 64, device=dev), x, x)
    with pytest.raises(ValueError, match="contiguous"):
        y = torch.zeros(1, 2, 64, 8, device=dev).transpose(2, 3)
        flash_attn.flash_attention(y, y, y)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attn.flash_attention(x, x, x, q_offset=-1)
    with pytest.raises(ValueError, match="no backward"):
        from repro_torch.kernels import ops
        ops.flash_attention(x.clone().requires_grad_(), x, x)


def test_fused_train_step_on_card_matches_cpu(dev):
    """Two fused-probe elastic_zo steps of a reduced qwen3-4b in f32: the
    card (the ZO kernels with offsets, the flash kernel) and the CPU
    (their plain versions) agree to matmul rounding."""
    cfg = configs.reduced(configs.ARCHS["qwen3-4b"], dtype="float32",
                          num_layers=3)
    lane = configs.LaneConfig(zo_num_probes=2, fused_probes=True)
    step = api.make_train_step(cfg, lane)
    out = []
    for d in ("cpu", dev):
        params = api.init(cfg, lane, seed=3, device="cpu")
        state = init_state(tree_map(lambda a: a.to(d), params), seed=0)
        for s in range(2):
            x, y, m = token_batch(2, 16, cfg.vocab_size, seed=1, step=s)
            batch = {k: torch.from_numpy(a).to(d)
                     for k, a in (("tokens", x), ("labels", y), ("mask", m))}
            state, metrics = step(state, batch, np.ones((2,), np.float32))
        out.append((state, metrics))
    (cs, cm), (gs, gm) = out
    assert abs(float(cm["loss"]) - float(gm["loss"])) <= 1e-4
    for (_, a), (_, b) in zip(zo.leaves_with_path(cs.params),
                              zo.leaves_with_path(gs.params)):
        assert (a - b.cpu()).abs().max().item() <= 1e-4


def test_train_step_on_card_matches_cpu(dev):
    """One elastic_zo step of a reduced qwen3-4b in f32: the card (the
    ZO kernels) and the CPU (their plain versions) agree to matmul
    rounding."""
    cfg = configs.reduced(configs.ARCHS["qwen3-4b"], dtype="float32")
    lane = configs.LaneConfig(zo_num_probes=2)
    step = api.make_train_step(cfg, lane)
    x, y, m = token_batch(2, 16, cfg.vocab_size, seed=1, step=0)
    out = []
    for d in ("cpu", dev):
        params = api.init(cfg, lane, seed=3, device="cpu")
        state = init_state(tree_map(lambda a: a.to(d), params), seed=0)
        batch = {k: torch.from_numpy(v).to(d)
                 for k, v in (("tokens", x), ("labels", y), ("mask", m))}
        out.append(step(state, batch, np.ones((2,), np.float32)))
    (cs, cm), (gs, gm) = out
    assert abs(float(cm["loss"]) - float(gm["loss"])) <= 1e-4
    for (_, a), (_, b) in zip(zo.leaves_with_path(cs.params),
                              zo.leaves_with_path(gs.params)):
        assert (a - b.cpu()).abs().max().item() <= 1e-4


def test_engine_on_card_matches_cpu(dev):
    cfg = configs.reduced(configs.ARCHS["qwen3-4b"], dtype="float32")
    serve = ServeConfig(page_size=4, num_pages=32, max_batch_slots=3,
                        max_seq_len=32, max_new_tokens=9, megastep=4)
    cpu = Engine(cfg, serve, device="cpu")
    card = Engine(cfg, serve, device=dev,
                  params=tree_map(lambda a: a.to(dev), cpu.params))
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, cfg.vocab_size, n)) for n in (4, 8, 5)]
    knobs = [SamplingParams(),
             SamplingParams(temperature=0.8, top_k=7, seed=11),
             SamplingParams(temperature=1.1, top_p=0.9, seed=23)]
    streams = []
    for eng in (cpu, card):
        rids = [eng.submit(p, sp, 9) for p, sp in zip(prompts, knobs)]
        out = eng.run()
        streams.append([out[r] for r in rids])
    assert streams[0] == streams[1]


def test_jamba_engine_on_card_matches_cpu(dev):
    """Reduced Jamba in f32 (Mamba, attention and MoE blocks; one period,
    so the BP tail is empty): equal streams and prefill logits within
    1e-4, card against CPU."""
    cfg = configs.reduced(configs.ARCHS["jamba-v0.1-52b"], dtype="float32")
    serve = ServeConfig(page_size=4, num_pages=32, max_batch_slots=3,
                        max_seq_len=32, max_new_tokens=9, megastep=4)
    cpu = Engine(cfg, serve, device="cpu")
    card = Engine(cfg, serve, device=dev,
                  params=tree_map(lambda a: a.to(dev), cpu.params))
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, cfg.vocab_size, n)) for n in (4, 8, 5, 7)]
    knobs = [SamplingParams(),
             SamplingParams(temperature=0.8, top_k=7, seed=11),
             SamplingParams(temperature=1.1, top_p=0.9, seed=23),
             SamplingParams(temperature=0.9, seed=3)]
    streams = []
    for eng in (cpu, card):
        rids = [eng.submit(p, sp, 9) for p, sp in zip(prompts, knobs)]
        out = eng.run()
        streams.append([out[r] for r in rids])
    assert streams[0] == streams[1]
    toks = torch.tensor([prompts[1]])
    last = torch.tensor([len(prompts[1]) - 1])
    want, _ = api.prefill_logits(cpu.params, cfg, toks, last)
    got, _ = api.prefill_logits(card.params, cfg, toks.to(dev), last.to(dev))
    assert (got.cpu() - want).abs().max().item() <= 1e-4


def _stubs(cfg, rows, device, seed=0):
    """Random frames (Whisper) or image embeddings (LLaVA)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    out = {}
    if cfg.encoder_layers:
        out["frames"] = torch.randn(rows, cfg.encoder_seq, cfg.d_model,
                                    generator=g).to(device)
    if cfg.num_image_tokens:
        out["img"] = torch.randn(rows, cfg.num_image_tokens, cfg.d_model,
                                 generator=g).to(device)
    return out


@pytest.mark.parametrize("arch", ["whisper-small", "llava-next-34b"])
def test_encdec_engine_on_card_matches_cpu(dev, arch):
    """Reduced Whisper and LLaVA in f32: equal streams (4 requests over 3
    slots, greedy and sampled), and prefill logits over random frames or
    image embeddings within 1e-4, card against CPU."""
    cfg = configs.reduced(configs.ARCHS[arch], dtype="float32")
    serve = ServeConfig(page_size=4, num_pages=32, max_batch_slots=3,
                        max_seq_len=40, max_new_tokens=9, megastep=4)
    cpu = Engine(cfg, serve, device="cpu")
    card = Engine(cfg, serve, device=dev,
                  params=tree_map(lambda a: a.to(dev), cpu.params))
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, cfg.vocab_size, n)) for n in (4, 8, 5, 7)]
    knobs = [SamplingParams(),
             SamplingParams(temperature=0.8, top_k=7, seed=11),
             SamplingParams(temperature=1.1, top_p=0.9, seed=23),
             SamplingParams(temperature=0.9, seed=3)]
    streams = []
    for eng in (cpu, card):
        rids = [eng.submit(p, sp, 9) for p, sp in zip(prompts, knobs)]
        out = eng.run()
        streams.append([out[r] for r in rids])
    assert streams[0] == streams[1]
    toks = torch.tensor([prompts[1]])
    last = torch.tensor([cfg.num_image_tokens + len(prompts[1]) - 1])
    stubs = _stubs(cfg, 1, "cpu")
    want, _ = api.prefill_logits(cpu.params, cfg, toks, last, **stubs)
    got, _ = api.prefill_logits(card.params, cfg, toks.to(dev), last.to(dev),
                                **tree_map(lambda a: a.to(dev), stubs))
    assert (got.cpu() - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("arch", ["whisper-small", "llava-next-34b"])
def test_encdec_train_step_on_card_matches_cpu(dev, arch, fused):
    """One elastic_zo step of reduced Whisper and LLaVA in f32 over random
    frames / image embeddings, unfused and fused: loss and every leaf
    within 1e-4, card against CPU."""
    cfg = configs.reduced(configs.ARCHS[arch], dtype="float32")
    lane = configs.LaneConfig(fused_probes=fused)
    step = api.make_train_step(cfg, lane)
    x, y, m = token_batch(2, 16, cfg.vocab_size, seed=1, step=0)
    out = []
    for d in ("cpu", dev):
        params = api.init(cfg, lane, seed=3, device="cpu", max_seq=16)
        state = init_state(tree_map(lambda a: a.to(d), params), seed=0)
        batch = {k: torch.from_numpy(v).to(d)
                 for k, v in (("tokens", x), ("labels", y), ("mask", m))}
        batch.update(_stubs(cfg, 2, d))
        out.append(step(state, batch, np.ones((1,), np.float32)))
    (cs, cm), (gs, gm) = out
    assert abs(float(cm["loss"]) - float(gm["loss"])) <= 1e-4
    for (_, a), (_, b) in zip(zo.leaves_with_path(cs.params),
                              zo.leaves_with_path(gs.params)):
        assert (a - b.cpu()).abs().max().item() <= 1e-4


def test_moe_tail_step_reruns_bitwise(dev):
    """Reduced Mixtral in f32 at two periods, so that the BP tail holds an
    MoE block whose dispatch the backward differentiates: two elastic_zo
    steps from the same init and seed on the card give bitwise equal
    parameters. The dispatch's gathers differentiate into an atomic
    scatter-add, but with top-2 routing a row receives at most two
    nonzero terms (the rest are exact zeros), and a sum of two floats
    into zero does not depend on their order."""
    cfg = configs.reduced(configs.ARCHS["mixtral-8x7b"], dtype="float32")
    lane = configs.LaneConfig()
    step = api.make_train_step(cfg, lane)
    x, y, m = token_batch(4, 64, cfg.vocab_size, seed=1, step=0)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in (("tokens", x), ("labels", y), ("mask", m))}
    runs = []
    for _ in range(2):
        state = init_state(api.init(cfg, lane, seed=3, device=dev), seed=0)
        state, _ = step(state, batch, np.ones((1,), np.float32))
        runs.append(list(zo.leaves_with_path(state.params)))
    for (path, a), (_, b) in zip(*runs):
        assert torch.equal(a, b), path


# ------------------------------------------------------------------ #
# the int8 lane's kernels
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("n,skip", [(4099, 0), (4099, 1), (3, 0), (94080, 0)])
def test_int8_noise_kernels_match_plain_bitwise(dev, n, skip):
    """skip = 1 starts the leaf off 16-byte alignment (the scalar path)."""
    g = torch.Generator(device="cpu").manual_seed(n)
    theta = torch.randint(-127, 128, (n + skip,), generator=g,
                          dtype=torch.int8).to(dev)[skip:]
    seeds, _ = _zo_records(dev)
    gs = torch.tensor([[1, -1], [0, 1], [-1, -1]], dtype=torch.int32,
                      device=dev)
    for k in (1, -1):
        assert torch.equal(
            zo_perturb.int8_perturb(theta, seeds[0, :1], 77, k, 3, 0.33),
            ref.int8_perturb_ref(theta, seeds[0, :1], 77, k, 3, 0.33))
    fused = zo_fused_replay.zo_fused_replay_int8(theta, seeds, gs, 77, 3,
                                                 0.33, 1)
    assert torch.equal(fused, ref.zo_fused_replay_int8_ref(
        theta, seeds, gs, 77, 3, 0.33, 1))
    live = theta.clone()
    for s in range(seeds.shape[0]):
        zo_fused_replay.zo_fused_replay_int8(live, seeds[s:s + 1],
                                             gs[s:s + 1], 77, 3, 0.33, 1,
                                             out=live)
    assert torch.equal(live, fused)


LENET_INT8 = [(5, 5, 1, 6), (5, 5, 6, 16), (784, 120), (120, 84), (84, 10)]


def _int8_model(dev, shapes, seed=0):
    """int8 leaves of ``shapes`` on the card, their salts, and the records
    of 8 steps x 4 probes with one g = 0."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    leaves = [torch.randint(-127, 128, s, generator=g, dtype=torch.int8)
              .to(dev) for s in shapes]
    salts = [(977 * i + 13) % 2**30 for i in range(len(shapes))]
    seeds, _ = _zo_records(dev, 8, 4)
    gs = torch.from_numpy(np.random.default_rng(seed).choice(
        np.array([-1, 1], np.int32), (8, 4))).to(dev)
    gs[4, 2] = 0
    return leaves, salts, seeds, gs


@pytest.mark.parametrize("copies", [1, 10], ids=["vec4", "vec16"])
def test_int8_whole_model_launch_matches_per_leaf_plain(dev, copies):
    """One launch over LeNet-5's five int8 leaves (and a view off 16-byte
    alignment) equals the plain version leaf by leaf: the perturbation,
    the update S = 1 in place, and the catch-up S = 8 x P = 4. The kernels
    take 16 elements a thread where that gives 264 tiles of 4,096: one
    copy of the leaves makes 30 (so 4 a thread), ten make 291 (16)."""
    leaves, salts, seeds, gs = _int8_model(dev, LENET_INT8 * copies)
    buf = torch.randint(-127, 128, (999,), dtype=torch.int8).to(dev)
    leaves.append(buf[3:3 + 841])
    salts.append(5)
    n0 = zo_perturb.int8_launches
    for k in (1, -1):
        got = zo_perturb.int8_perturb_leaves(leaves, seeds[0, :1], salts, k,
                                             3, 0.33)
        for t, o, salt in zip(leaves, got, salts):
            assert o.data_ptr() % 16 == 0
            assert torch.equal(o, ref.int8_perturb_ref(t, seeds[0, :1], salt,
                                                       k, 3, 0.33))
    assert zo_perturb.int8_launches == n0 + 2
    n0 = zo_fused_replay.int8_launches
    for sd, g in ((seeds[:1, :1], gs[:1, :1]), (seeds, gs)):
        want = [ref.zo_fused_replay_int8_ref(t, sd, g, salt, 3, 0.33, 1)
                for t, salt in zip(leaves, salts)]
        got = zo_fused_replay.zo_fused_replay_int8_leaves(
            leaves, sd, g, salts, 3, 0.33, 1)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    live = [t.clone() for t in leaves]
    for s in range(8):
        zo_fused_replay.zo_fused_replay_int8_leaves(
            live, seeds[s:s + 1], gs[s:s + 1], salts, 3, 0.33, 1, outs=live)
    assert all(torch.equal(a, b) for a, b in zip(live, want))
    assert zo_fused_replay.int8_launches == n0 + 2 + 8


def test_int8_table_above_the_cap_splits_launches(dev):
    n = zo_perturb.MAX_LEAVES + 7
    shapes = [(17 + 5 * i,) for i in range(n)]
    leaves, salts, seeds, gs = _int8_model(dev, shapes, seed=1)
    n0 = (zo_perturb.int8_launches, zo_fused_replay.int8_launches)
    got = zo_perturb.int8_perturb_leaves(leaves, seeds[0, :1], salts, 1, 3,
                                         0.33)
    rep = zo_fused_replay.zo_fused_replay_int8_leaves(leaves, seeds, gs,
                                                      salts, 3, 0.33, 1)
    assert (zo_perturb.int8_launches - n0[0],
            zo_fused_replay.int8_launches - n0[1]) == (2, 2)
    for t, a, b, salt in zip(leaves, got, rep, salts):
        assert torch.equal(a, ref.int8_perturb_ref(t, seeds[0, :1], salt, 1,
                                                   3, 0.33))
        assert torch.equal(b, ref.zo_fused_replay_int8_ref(
            t, seeds, gs, salt, 3, 0.33, 1))


@pytest.mark.parametrize("r_max,p_zero", [(0, 0.5), (1, 0.0), (7, 1.0),
                                          (100, 0.33)])
@pytest.mark.parametrize("shift", [-2, 0, 5, 31, 32, 40])
def test_int8_replay_every_shift_form_and_large_g(dev, r_max, p_zero, shift):
    """Each of psr's three forms (s <= 0, 0 < s < 32, s >= 32) with g as
    large as 2**30, so g * z reaches INT_MIN, at the ends of p_zero."""
    leaves, salts, seeds, _ = _int8_model(dev, [(4099,), (130, 3)], seed=2)
    gs = torch.tensor([[1, -1, 2**30, -2**30], [0, 3, -7, 2**29]],
                      dtype=torch.int32, device=dev)
    got = zo_fused_replay.zo_fused_replay_int8_leaves(
        leaves, seeds[:2], gs, salts, r_max, p_zero, shift)
    for t, o, salt in zip(leaves, got, salts):
        assert torch.equal(o, ref.zo_fused_replay_int8_ref(
            t, seeds[:2], gs, salt, r_max, p_zero, shift))
        assert torch.equal(
            zo_perturb.int8_perturb(t, seeds[0, :1], salt, 3, r_max, p_zero),
            ref.int8_perturb_ref(t, seeds[0, :1], salt, 3, r_max, p_zero))


@pytest.mark.parametrize("M,K,N,skip", [(37, 25, 6, 0), (50176, 25, 6, 1),
                                        (65, 129, 67, 3), (1, 1, 1, 0),
                                        (256, 784, 120, 0), (8, 0, 5, 0)])
def test_int8_matmul_matches_plain_bitwise(dev, M, K, N, skip):
    g = torch.Generator(device="cpu").manual_seed(M + K + N)
    a = torch.randint(-127, 128, (M * K + skip,), generator=g,
                      dtype=torch.int8)[skip:].reshape(M, K).to(dev)
    w = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8).to(dev)
    out, mx = int8_matmul.int8_matmul(a, w)
    want, want_mx = ref.int8_matmul_ref(a, w)
    assert out.dtype == torch.int32 and torch.equal(out, want)
    assert int(mx) == int(want_mx)


@pytest.mark.parametrize("M,K,N,skip", [
    (64 * 784, 25, 6, 0), (64 * 196, 150, 16, 0), (64, 784, 120, 1),
    (84, 64, 10, 0), (130, 4097, 70, 0), (300, 4097, 200, 1),
    (4096, 64, 4096, 0), (200, 512, 260, 0),
])
def test_int8_matmul_narrow_deep_and_last_tile_max(dev, M, K, N, skip):
    """The narrow-N LeNet-5 shapes, K = 4097 (a ragged last k stage) and
    the largest |out| in the last row and column, so the last M and N
    tile carries max|out|."""
    g = torch.Generator(device="cpu").manual_seed(M * 7 + K + N)
    a = torch.randint(-127, 128, (M * K + skip,), generator=g,
                      dtype=torch.int8).to(dev)[skip:].reshape(M, K)
    w = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8).to(dev)
    a[-1] = 127
    w[:, -1] = 127
    out, mx = int8_matmul.int8_matmul(a, w)
    want, want_mx = ref.int8_matmul_ref(a, w)
    assert torch.equal(out, want)
    assert int(mx) == int(want_mx) == 127 * 127 * K


def test_int8_kernels_refuse_what_they_do_not_take(dev):
    seeds, _ = _zo_records(dev)
    gs = torch.ones((1, 1), dtype=torch.int32, device=dev)
    x = torch.zeros(8, 8, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        zo_perturb.int8_perturb(x.float(), seeds[0, :1], 1, 1, 3, 0.33)
    with pytest.raises(ValueError, match="contiguous"):
        zo_perturb.int8_perturb(x.t(), seeds[0, :1], 1, 1, 3, 0.33)
    with pytest.raises(ValueError, match="dtype"):
        zo_fused_replay.zo_fused_replay_int8(x.float(), seeds[:1, :1], gs, 1,
                                             3, 0.33, 1)
    with pytest.raises(ValueError, match="int32"):
        zo_fused_replay.zo_fused_replay_int8(x, seeds[:1, :1], gs.long(), 1,
                                             3, 0.33, 1)
    with pytest.raises(ValueError, match="dtype"):
        int8_matmul.int8_matmul(x.float(), x)
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul.int8_matmul(x.t(), x)
    with pytest.raises(ValueError, match="K = "):
        big = torch.zeros((1, int8_matmul.MAX_K + 1), dtype=torch.int8,
                          device=dev)
        int8_matmul.int8_matmul(big, big.reshape(-1, 1))


@pytest.mark.parametrize("loss_mode", ["int", "float"])
def test_int8_lane_step_on_card_matches_cpu(dev, loss_mode):
    """Two ZO-Feat-Cls2 steps at batch 16: the card (the three int8
    kernels) and the CPU (their plain versions) agree bitwise."""
    from repro_torch.train.paper_lanes import lenet_int8_lanes
    out = [lenet_int8_lanes(steps=2, batch=16, test_n=64, loss_mode=loss_mode,
                            device=d, lanes=["zo_feat_cls2"], log_every=1)
           ["zo_feat_cls2"] for d in ("cpu", dev)]
    (c, g) = out
    assert c.acc == g.acc and c.history == g.history
    for (_, a), (_, b) in zip(zo.leaves_with_path(c.state.params),
                              zo.leaves_with_path(g.state.params)):
        assert torch.equal(a.data, b.data.cpu())
        assert int(a.exp) == int(b.exp)


@pytest.mark.parametrize("M,K,N", [(32 * 1024, 3, 64), (2 * 64, 3, 16),
                                   (7, 3, 5), (32 * 1024, 128, 1024)])
def test_int8_matmul_k3_pointnet_shapes(dev, M, K, N):
    """PointNet's first int8 product has K = 3 over B x N rows; the
    kernel zero-pads its k tile. Also its widest pointwise layer."""
    g = torch.Generator(device="cpu").manual_seed(M + 3 * K + N)
    a = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    a[-1], w[:, -1] = 127, 127
    out, mx = int8_matmul.int8_matmul(a.to(dev), w.to(dev))
    want, want_mx = ref.int8_matmul_ref(a, w)
    assert torch.equal(out.cpu(), want)
    assert int(mx) == int(want_mx) == 127 * 127 * K


@pytest.mark.parametrize("cfg_name", ["reduced", "full"])
def test_pointnet_int8_forward_on_card_matches_cpu(dev, cfg_name):
    """PointNet's int8 forward through the int8_matmul kernel equals the
    plain versions on the CPU bitwise: reduced width at 8 x 32 points,
    and full width at 2 x 64."""
    from repro_torch.configs.paper_models import POINTNET, PointNetConfig
    from repro_torch.core.int8 import quant_from_float
    from repro_torch.data.synthetic import point_clouds
    from repro_torch.models import pointnet
    cfg, B, N = (PointNetConfig(feat_dims=(16, 16, 16, 32, 64),
                                head_dims=(32, 16), num_classes=8,
                                num_points=32), 8, 32) \
        if cfg_name == "reduced" else (POINTNET, 2, 64)
    xs, _ = point_clouds(B, N, seed=4, start=50_000)
    out = []
    for d in ("cpu", dev):
        params = pointnet.init_pointnet_int8(5, cfg, device=d)
        with torch.no_grad():
            logits, _ = pointnet.pointnet_forward_int8(
                params, quant_from_float(torch.from_numpy(xs).to(d)))
        out.append((logits.data.cpu(), int(logits.exp)))
    assert torch.equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]


def test_pointnet_lane_on_card_matches_cpu(dev):
    """Two ZO-Feat-Cls1 steps of PointNet at 64 points: the card (the ZO
    kernels, cuBLAS with TF32 off) and the CPU agree to float rounding."""
    from repro_torch.benchmarks.paper_tables import pointnet_lanes
    c, g = (pointnet_lanes(steps=2, batch=8, train_n=16, test_n=16,
                           num_points=64, device=d,
                           lanes=["zo_feat_cls1"])["zo_feat_cls1"]
            for d in ("cpu", dev))
    for (_, a), (_, b) in zip(zo.leaves_with_path(c.state.params),
                              zo.leaves_with_path(g.state.params)):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=1e-4,
                                   atol=2e-5)


# ------------------------------------------------------------------ #
# the fleet (seed ledger) on the card
# ------------------------------------------------------------------ #
def test_int8_fleet_with_crash_equals_reference(dev):
    """A short int8 fleet on the card (LeNet-5, 4 workers, a crash whose
    catch-up replays 3 steps): every live worker equals the canon and the
    canon equals the single-process reference, bitwise."""
    from repro_torch.configs import FleetConfig
    from repro_torch.core import keys
    from repro_torch.fleet import run_fleet
    from repro_torch.launch import fleet as launch_fleet
    params, lane, part, probe_fn, batch_fn = \
        launch_fleet.lenet_int8_fleet_setup(1, batch=8, device=dev)
    base = keys.key_data(1)
    n0 = zo_fused_replay.int8_launches
    res = run_fleet(None, params, lane,
                    FleetConfig(num_workers=4, probes_per_worker=1,
                                dropout=0.25, max_delay=2, deadline=1,
                                chaos_seed=1, crashes=((1, 1, 2),)),
                    batch_fn, steps=5, base_seed=base, partition_fn=part,
                    probe_fn=probe_fn)
    # 5 steps x (coordinator + live workers) applies + one catch-up
    assert zo_fused_replay.int8_launches - n0 == 5 + 4 * 5 - 2 + 1
    assert res.stats["n_catchups"] == 1
    for w in res.workers:
        assert launch_fleet.trees_equal(w.params, res.params), w.id
    assert launch_fleet.verify_reference(res, params, probe_fn, None,
                                         batch_fn, 5, base)


def test_int8_catchup_s3_n8_matches_plain(dev):
    """The catch-up shape of an 8-worker fleet, S = 3 steps x n = 8
    probes with masked (g = 0) records, on LeNet-5's int8 ZO leaves in
    one launch: bitwise the plain version leaf by leaf."""
    from repro_torch.core.int8 import replay_int8, zo_shift
    from repro_torch.models import lenet
    params = lenet.init_lenet5_int8(0, device=dev)
    zo_part, _ = lenet.partition_at(params, 4)
    g = torch.Generator().manual_seed(5)
    seeds = torch.randint(-2**31, 2**31, (3, 8), generator=g,
                          dtype=torch.int64).to(torch.int32).to(dev)
    gs = torch.randint(-1, 2, (3, 8), generator=g,
                       dtype=torch.int32).to(dev)
    gs[1, 3] = 0
    lane = configs.LaneConfig(lane="elastic_zo_int8")
    shift = zo_shift(lane.int8_r_max, lane.int8_b_zo)
    n0 = zo_fused_replay.int8_launches
    got = replay_int8(zo_part, seeds, gs, lane.int8_r_max, lane.int8_p_zero,
                      shift)
    assert zo_fused_replay.int8_launches == n0 + 1
    for name in zo_part:
        want = ref.zo_fused_replay_int8_ref(
            zo_part[name]["w"].data, seeds, gs,
            zo.path_salt((name, "w")), lane.int8_r_max, lane.int8_p_zero,
            shift)
        assert torch.equal(got[name]["w"].data, want), name
        assert torch.equal(got[name]["w"].exp, zo_part[name]["w"].exp)


# ------------------------------------------------------------------ #
# the training infrastructure: optimizers, the Prefetcher, step memory
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("name", ["sgd", "momentum", "nesterov", "adam"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_optimizers_on_card_match_cpu(dev, name, dtype):
    """20 updates at a constant learning rate and host steps (the train
    loop's), the same gradients on the card and on the CPU. sgd, momentum
    and Nesterov: the updates, the state and the params bitwise (one
    rounding an op on both). adam: its state (m, v: products and sums)
    bitwise, and every step's update within 2 f32 ulp (its bias
    corrections are host scalars, divided on the leaf's device); its
    params bitwise where every update was (an update a few ulp off can
    move a parameter that crosses zero by many of its own)."""
    from repro_torch.train import optimizer as opt
    make = {"sgd": lambda: opt.sgd(0.05),
            "momentum": lambda: opt.sgd(0.05, momentum=0.9),
            "nesterov": lambda: opt.sgd(0.05, momentum=0.9, nesterov=True),
            "adam": lambda: opt.adam(0.01)}[name]
    g = torch.Generator().manual_seed(3)
    p0 = {"a": {"w": torch.randn(16, 8, generator=g),
                "b": torch.randn(8, generator=g)},
          "c": torch.randn(4, 4, 2, generator=g)}
    grads = [tree_map(lambda t: torch.randn(t.shape, generator=g), p0)
             for _ in range(20)]
    out = {}
    for d in ("cpu", dev):
        o = make()
        params = tree_map(lambda t: t.to(d, dtype), p0)
        state = o.init(params)
        upds = []
        for s, gr in enumerate(grads):
            upd, state = o.update(tree_map(lambda t: t.to(d, dtype), gr),
                                  state, s)
            params = opt.apply_updates(params, upd)
            upds.append(zo.leaves(upd))
        out[d] = (zo.leaves(params), upds, zo.leaves(state)
                  if state != () else [])
    (pc, uc, sc), (pd, ud, sd) = out["cpu"], out[dev]
    for a, b in zip(sc, sd):
        assert torch.equal(b.cpu(), a)
    worst = 0
    for step_c, step_d in zip(uc, ud):
        for a, b in zip(step_c, step_d):
            assert b.is_cuda and b.dtype == torch.float32
            worst = max(worst, ulps(b, a))
    assert worst <= (2 if name == "adam" else 0)
    for a, b in zip(pc, pd):
        assert b.is_cuda and b.dtype == dtype and torch.isfinite(b).all()
        if worst == 0:
            assert torch.equal(b.cpu(), a)


def test_schedules_on_card_match_cpu(dev):
    """step_decay and cosine at a device step counter, at step 0, the
    warmup's end, mid and the end, within 1 ulp of the CPU's (pow and cos
    are the card's own)."""
    from repro_torch.train import optimizer as opt
    for f in (opt.step_decay(0.05, 0.8, 10), opt.cosine(0.3, 100, warmup=10),
              opt.cosine(0.3, 100, warmup=7, floor=0.1)):
        for s in (0, 7, 10, 25, 55, 60, 100, 130):
            got = f(torch.tensor(s, device=dev))
            assert got.device.type == "cuda" and got.dtype == torch.float32
            assert ulps(got, f(s)) <= 1, s


@pytest.mark.parametrize("arch", ["qwen3-4b", "whisper-small",
                                  "llava-next-34b"])
def test_prefetcher_on_card_matches_device_put_batch(dev, arch):
    """The side-stream copies of pinned batches, read on the current
    stream, bitwise the blocking device_put_batch (frames / img in the
    config's dtype)."""
    from repro_torch.data.pipeline import (Prefetcher, device_put_batch,
                                           lm_batch_fn, stub_dtypes)
    cfg = configs.reduced(configs.get_arch(arch))
    shape = configs.ShapeConfig("t", seq_len=24, global_batch=3,
                                kind="train")
    fn = lm_batch_fn(cfg, shape, seed=2)
    dts = stub_dtypes(cfg)
    with Prefetcher(fn, 4, dev, dts) as pf:
        for s in range(4, 12):
            got, batch = pf.get()
            assert got == s
            # work on the current stream between the handover and the read
            torch.ones(1 << 20, device=dev).sum()
            want = device_put_batch(fn(s), dev, dts)
            assert sorted(batch) == sorted(want)
            for k, v in want.items():
                assert batch[k].device == v.device
                assert batch[k].dtype == v.dtype and torch.equal(batch[k], v)


def test_step_memory_analysis_of_lenet_lanes(dev):
    """The step's memory account of LeNet-5's four fp32 lanes and three
    INT8* lanes at batch 32: every key read, peak = argument + output +
    temp - alias, full_zo's params all updated in place, full_bp's none,
    and zo_feat_cls2 under 4 MB (its loop once read 35.9 MB with the
    autograd thread's one-time cuBLAS workspace in it)."""
    from repro_torch.benchmarks import paper_tables as pt
    from repro_torch.models import lenet
    from repro_torch.obs.memory import tree_nbytes
    fp = pt.lenet_measured_memory(32, device=dev)
    i8 = pt.lenet_int8_measured_memory(32, device=dev)
    keys = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "peak_bytes"}
    assert sorted(fp) == sorted(["full_zo", "zo_feat_cls2", "zo_feat_cls1",
                                 "full_bp"])
    assert sorted(i8) == sorted(["full_zo", "zo_feat_cls2", "zo_feat_cls1"])
    for r in list(fp.values()) + list(i8.values()):
        assert set(r) == keys and all(v >= 0 for v in r.values())
        assert r["peak_bytes"] == (r["argument_bytes"] + r["output_bytes"]
                                   + r["temp_bytes"] - r["alias_bytes"])
    fp32_params = tree_nbytes(lenet.init_lenet5(7, device=dev))
    assert fp["full_zo"]["alias_bytes"] == fp32_params
    assert fp["full_bp"]["alias_bytes"] == 0
    assert fp["zo_feat_cls2"]["peak_bytes"] < 4_000_000
    assert fp["full_bp"]["peak_bytes"] > fp["full_zo"]["peak_bytes"]
