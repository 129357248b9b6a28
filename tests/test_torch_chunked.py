"""The BP tail's chunked attention, on the CPU.

``models/layers.py::_chunked_self_attention`` splits the queries into
chunks of S // (S // Q_CHUNK) rows; the last chunk takes the remainder.
With Q_CHUNK cut to 4, sequences that are not a multiple of the chunk are
held to the port's dense ``kernels/ref.py::flash_attention_ref`` (f32,
1e-5: summation order only), and a multiple to the loop as it stood
before the remainder was taken, bitwise. JAX's chunked attention is not
the oracle: it drops the remainder rows.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

B, KVD, G, DH = 2, 2, 2, 8


def _inputs(S, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, S, KVD, G, DH)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, S, KVD, DH)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, S, KVD, DH)).astype(np.float32))
    pos = torch.arange(S)[None].expand(B, S)
    return q, k, v, pos


def _chunked_with_whole_chunks_only(q, k, v, positions, window, scale):
    """The loop before the remainder fix: nq chunks of cq rows."""
    S = q.shape[1]
    nq = max(1, S // layers.Q_CHUNK)
    cq = S // nq
    outs = []
    for i in range(nq):
        q_i = q[:, i * cq:(i + 1) * cq]
        q_pos = positions[:, i * cq:(i + 1) * cq]
        kv_hi = min((i + 1) * cq, k.shape[1])
        kv_lo = max(0, ((i * cq - window + 1) // cq) * cq) if window > 0 else 0
        t_pos = positions[:, kv_lo:kv_hi]
        mask = t_pos[:, None, :] <= q_pos[:, :, None]
        if window > 0:
            mask &= t_pos[:, None, :] > q_pos[:, :, None] - window
        outs.append(layers._attend_block(q_i, k[:, kv_lo:kv_hi],
                                         v[:, kv_lo:kv_hi], mask, scale))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("S", [9, 13, 16])
def test_chunked_attention_returns_every_row(monkeypatch, S, window):
    monkeypatch.setattr(layers, "Q_CHUNK", 4)
    q, k, v, pos = _inputs(S, seed=S + window)
    scale = DH ** -0.5
    y = layers._chunked_self_attention(q, k, v, pos, window, scale)
    assert y.shape == (B, S, KVD, G, DH)
    want = ref.flash_attention_ref(
        q.reshape(B, S, KVD * G, DH).transpose(1, 2), k.transpose(1, 2),
        v.transpose(1, 2), causal=True, window=window, scale=scale)
    got = y.reshape(B, S, KVD * G, DH).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("window", [0, 3])
def test_chunked_attention_at_a_multiple_is_unchanged(monkeypatch, window):
    monkeypatch.setattr(layers, "Q_CHUNK", 4)
    q, k, v, pos = _inputs(16, seed=7)
    args = (q, k, v, pos, window, DH ** -0.5)
    assert torch.equal(layers._chunked_self_attention(*args),
                       _chunked_with_whole_chunks_only(*args))
