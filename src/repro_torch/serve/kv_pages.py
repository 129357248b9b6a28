"""Paged KV-cache pool: host-side page allocator + device admission writes.

Every attention layer owns a pool of ``num_pages`` fixed-size pages,
[periods, num_pages, page_size, KV, Dh]; recurrent state (Mamba, RWKV6)
and Whisper's cross-attention keys and values (``ck`` / ``cv``) stay
dense per decode slot, [periods, slots, ...]. A sequence's cache
is an ordered list of physical page ids; the decode step receives the
list as a row of the [slots, max_pages_per_seq] page table. Page 0 is
the reserved **null page**: unmapped table entries point at it, inactive
batch rows write their token into it, and it is never allocated, so
nothing that matters is read from or lost to it.

The caches are updated **in place**: ``admit_prefill`` writes into them,
and so does the decode step (the KV write in ``kernels/ops.py``, the
recurrent state in ``models/transformer.py``). The JAX package donates
the caches and returns new ones instead. ``grow_dense_caches`` serves the
static-batch baseline (``serve/engine.py::DenseServer``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..configs.base import ATTN, ModelConfig

NULL_PAGE = 0
SELF_KV = ("k", "v")     # an attention entry's names that grow with the text


class PagePool:
    """Free-list page allocator. Page 0 is reserved (null page)."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(
                f"num_pages={num_pages}: need at least 1 allocatable page "
                "+ null page")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """All-or-nothing allocation of n pages (None on exhaustion)."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p == NULL_PAGE:
                raise ValueError("null page is not allocatable")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
            self._free.append(p)


def _scatter_kv(pool, dense, page_rows, page_size):
    """pool [pp, N, ps, KV, Dh] <- dense [pp, nb, L, KV, Dh], each row cut
    into the pages of its ``page_rows`` row [nb, P] (fixed width; unused
    tail entries are the null page, which swallows the spill chunks).
    Rows own disjoint pages, so writes collide only on the null page."""
    pp, nb, L, KV, Dh = dense.shape
    P = page_rows.shape[1]
    pad = P * page_size - L
    if pad:
        dense = F.pad(dense, (0, 0, 0, 0, 0, pad))
    pool[:, page_rows.reshape(-1)] = dense.reshape(
        pp, nb * P, page_size, KV, Dh).to(pool.dtype)


def admit_prefill(paged_caches, dense_caches, cfg: ModelConfig,
                  slots: Sequence[int], page_ids: Sequence[Sequence[int]],
                  page_size: int, table_width: int) -> None:
    """Write a batch-nb prefill's caches into the paged caches, in place:
    one indexed write per leaf for the whole admission wave.

    Row i goes to decode slot ``slots[i]`` (recurrent state, Whisper's
    ck / cv) and to the pages ``page_ids[i]`` (self-attention KV), padded
    with null pages to ``table_width`` (ServeConfig.max_pages_per_seq).
    """
    dev = next(iter(paged_caches["zo"][0].values())).device
    rows = torch.tensor([list(p) + [NULL_PAGE] * (table_width - len(p))
                         for p in page_ids], dtype=torch.int64, device=dev)
    slots = torch.tensor(list(slots), dtype=torch.int64, device=dev)
    for part in ("zo", "bp"):
        for kind, pe, de in zip(cfg.pattern, paged_caches[part],
                                dense_caches[part]):
            for name, d in de.items():
                if kind == ATTN and name in SELF_KV:
                    _scatter_kv(pe[name], d, rows, page_size)
                else:
                    pe[name][:, slots] = d.to(pe[name].dtype)


def grow_dense_caches(caches, cfg: ModelConfig, total: int):
    """Pad a prefill's self-attention KV ([periods, B, S, KV, Dh]) to
    ``total`` positions, capped at the sliding window (a ring); Whisper's
    cross-attention ck / cv, recurrent and conv state are left as they
    are. Returns new caches."""
    tgt = min(total, cfg.sliding_window) if cfg.sliding_window else total

    def grow(leaf):
        pad = tgt - leaf.shape[2]
        return F.pad(leaf, (0, 0, 0, 0, 0, pad)) if pad > 0 else leaf

    return {part: tuple({name: grow(a) if kind == ATTN and name in SELF_KV
                         else a
                         for name, a in e.items()}
                        for kind, e in zip(cfg.pattern, caches[part]))
            for part in ("zo", "bp")}
