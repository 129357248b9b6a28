"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. On the machine
with the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``. Imports nothing of JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import paged_attn, ref, topk_mask  # noqa: E402
from repro_torch.models.transformer import tree_map  # noqa: E402
from repro_torch.serve import Engine, SamplingParams, ServeConfig  # noqa: E402

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


@pytest.mark.parametrize("V", [256, 152064])
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
