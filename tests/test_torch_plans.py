"""Launch plans of the cluster kernels, checked on the CPU.

``kernels/paged_attn.py::plan`` and ``kernels/topk_mask.py::plan`` are
pure Python: the CUDA kernels take their geometry from them, so every
position and every vocab entry must land in exactly one CTA of a cluster
the card can launch, within a CTA's shared memory. The kernels
themselves run in ``tests/test_torch_cuda.py`` on the card.
"""
import pytest

pytest.importorskip("torch")

from repro_torch.configs import ARCHS, ServeConfig  # noqa: E402
from repro_torch.kernels import paged_attn, topk_mask  # noqa: E402

SMEM_LIMIT = 227 * 1024          # H100: dynamic shared memory of a CTA


def _covers_in_order(ranges, n):
    flat = [i for r in ranges for i in r]
    return flat == list(range(n))


@pytest.mark.parametrize("ps", [4, 16, 64])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_paged_plan_covers_every_position_once(arch, ps):
    cfg = ARCHS[arch]
    G, Dh = cfg.num_heads // cfg.num_kv_heads, cfg.head_dim
    for max_seq_len in (1, 544, 4096, 32768):
        P = ServeConfig(page_size=ps, max_seq_len=max_seq_len).max_pages_per_seq
        for itemsize in (2, 4):
            pl = paged_attn.plan(P, ps, G, Dh, itemsize)
            assert pl.positions == P * ps
            assert 1 <= pl.cluster <= paged_attn.MAX_CLUSTER
            assert pl.split % (paged_attn.WARPS * paged_attn.CHUNK) == 0
            assert all(len(r) for r in pl.ranges())   # no idle CTA
            assert _covers_in_order(pl.ranges(), P * ps)
            assert pl.smem_bytes <= SMEM_LIMIT
            assert pl.stages in (1, 2)


def test_paged_plan_at_the_serve_shape():
    """qwen3-4b serving (page 16, max_seq_len 544): 5 CTAs of 128
    positions, two cp.async stages, two CTAs a multiprocessor."""
    P = ServeConfig(page_size=16, max_seq_len=544).max_pages_per_seq
    pl = paged_attn.plan(P, 16, 4, 128, 2)
    assert (P, pl.cluster, pl.split, pl.stages) == (35, 5, 128, 2)
    assert 2 * pl.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("G,Dh", [(0, 128), (9, 128), (4, 8), (4, 32),
                                  (4, 72), (4, 512)])
def test_paged_plan_refuses_what_the_kernel_does_not_take(G, Dh):
    with pytest.raises(ValueError):
        paged_attn.plan(34, 16, G, Dh, 2)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_topk_plan_holds_every_vocab_row(arch):
    V = ARCHS[arch].padded_vocab
    pl = topk_mask.plan(V)
    assert 1 <= pl.cluster <= topk_mask.MAX_CLUSTER
    assert pl.slice % 4 == 0 and pl.slice * 4 <= topk_mask.SLICE_BYTES
    assert _covers_in_order(pl.ranges(), V)
    assert pl.smem_bytes <= SMEM_LIMIT
    if V > topk_mask.SLICE_BYTES // 4:
        assert pl.cluster >= 2


@pytest.mark.parametrize("V,C", [(1, 1), (256, 1), (13312, 1), (13313, 2),
                                 (32000, 4), (152064, 16), (200064, 16),
                                 (152101, 16), (16 * 13312, 16)])
def test_topk_plan_cluster_sizes(V, C):
    pl = topk_mask.plan(V)
    assert pl.cluster == C
    assert _covers_in_order(pl.ranges(), V)


def test_topk_plan_refuses_a_row_beyond_16_ctas():
    with pytest.raises(ValueError, match="does not fit"):
        topk_mask.plan(16 * topk_mask.SLICE_BYTES // 4 + 1)
