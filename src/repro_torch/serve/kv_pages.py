"""Paged KV-cache pool: host-side page allocator + device admission writes.

Every attention layer owns a pool of ``num_pages`` fixed-size pages,
[periods, num_pages, page_size, KV, Dh]. A sequence's cache is an ordered
list of physical page ids; the decode step receives the list as a row of
the [slots, max_pages_per_seq] page table. Page 0 is the reserved **null
page**: unmapped table entries point at it, inactive batch rows write
their token into it, and it is never allocated, so nothing that matters
is read from or lost to it.

The pools are updated **in place**: ``admit_prefill`` writes into them,
and so does the decode step's KV write (``kernels/ops.py``). The JAX
package donates the pools and returns new ones instead.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..configs.base import ATTN, ModelConfig

NULL_PAGE = 0


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
                  page_ids: Sequence[Sequence[int]], page_size: int,
                  table_width: int) -> None:
    """Write a batch-nb prefilled dense cache into the paged pools, in
    place: one indexed write per KV leaf for the whole admission wave.

    Row i of the dense cache goes to ``page_ids[i]``, padded with null
    pages to ``table_width`` (ServeConfig.max_pages_per_seq).
    Attention-only stacks have no per-slot state to write.
    """
    if any(kind != ATTN for kind in cfg.pattern):
        raise NotImplementedError("paged admission of recurrent state is "
                                  "not ported")
    rows = torch.tensor([list(p) + [NULL_PAGE] * (table_width - len(p))
                         for p in page_ids], dtype=torch.int64,
                        device=paged_caches["zo"][0]["k"].device)
    for part in ("zo", "bp"):
        for pe, de in zip(paged_caches[part], dense_caches[part]):
            for name in ("k", "v"):
                _scatter_kv(pe[name], de[name], rows, page_size)
