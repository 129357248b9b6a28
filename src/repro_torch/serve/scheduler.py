"""Continuous-batching scheduler: admission, page growth, preemption.

A copy of ``repro/serve/scheduler.py``, its flight-recorder calls
included (``serve.queue_depth``, ``serve.page_reclaims``,
``serve.admissions``, ``serve.evictions``, ``serve.page_util``,
``serve.preemptions`` and the ``preempt`` event, ``serve.ttft_ms``).
Pure host-side state machine (numpy only).
Sequence lifecycle:

    WAITING --admit--> RUNNING --commit--> FINISHED
        ^                  |
        +----preempt-------+        (recompute-style: pages freed, prompt
                                     re-extended with generated tokens,
                                     re-prefilled at next admission)

SWA reclamation: for sliding-window archs (``window > 0``) a sequence's
page list is *position-indexed with holes* — entry ``lp`` maps logical
page ``lp`` and holds ``NULL_PAGE`` once every position on that page has
slid out of the attention window. Reclaimed pages return to the pool
immediately (before growth allocations each step), the null entries flow
into the step's page table, and the decode kernel skips them; long
decodes therefore run in a pool bounded by the window, not the sequence
length. Admission allocates holes up front for prompt positions already
out of window (their prefill KV chunks land in the never-read null page).

Invariants (the JAX package's tests/test_serve_scheduler.py pins them):
  * page conservation — live pages + free pages == num_pages - 1 (null);
  * no starvation — FIFO admission + LIFO ("newest victim") preemption
    means the oldest running sequence is only ever preempted when it is
    alone, which cannot happen because ``submit`` rejects sequences whose
    worst-case footprint exceeds the pool;
  * a slot never holds two sequences, a page never backs two sequences.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional, Sequence as Seq

import numpy as np

from .. import obs
from ..configs.serve import ServeConfig
from .kv_pages import NULL_PAGE, PagePool
from .sampler import SamplingParams

WAITING, RUNNING, FINISHED = "waiting", "running", "finished"


@dataclass
class Request:
    """One generation request. `prefix_extra` counts non-text cache tokens
    (e.g. VLM image tokens) that prefill writes before the prompt."""
    rid: int
    prompt: List[int]
    sampling: SamplingParams = field(default_factory=SamplingParams)
    max_new_tokens: int = 16
    prefix_extra: int = 0


@dataclass
class _Sequence:
    req: Request
    state: str = WAITING
    slot: int = -1
    pages: List[int] = field(default_factory=list)   # NULL_PAGE = reclaimed
    pos: int = 0                     # tokens currently cached (incl. extra)
    generated: List[int] = field(default_factory=list)
    next_token: int = 0              # token to feed at the next decode step
    preemptions: int = 0
    submit_ns: int = 0               # obs TTFT stamp (0 = recorder off)

    @property
    def cached_prompt(self) -> List[int]:
        """Tokens to prefill on (re-)admission: prompt + prior generations."""
        return list(self.req.prompt) + self.generated

    @property
    def budget_left(self) -> int:
        return self.req.max_new_tokens - len(self.generated)


@dataclass
class StepPlan:
    """Device-ready assembly of one decode step."""
    tokens: np.ndarray               # [slots] int32, next token per row
    page_table: np.ndarray           # [slots, max_pages_per_seq] int32
    seq_lens: np.ndarray             # [slots] int32 (0 = inactive row)
    active: np.ndarray               # [slots] bool
    temperature: np.ndarray          # [slots] f32
    top_k: np.ndarray                # [slots] int32
    top_p: np.ndarray                # [slots] f32
    seed: np.ndarray                 # [slots] uint32
    step: np.ndarray                 # [slots] int32 (per-seq sample index)

    @property
    def num_active(self) -> int:
        return int(self.active.sum())


class Scheduler:
    def __init__(self, serve: ServeConfig, window: int = 0):
        self.serve = serve
        self.window = window             # model sliding window (0 = full)
        self.reclaimed_pages = 0         # SWA pages returned mid-sequence
        # bumped whenever the next StepPlan differs from the previous one
        # by more than the steady-state advance (active rows' pos and
        # sample index +1, tokens = last sampled): admissions, evictions,
        # preemptions, page growth, SWA reclamation. The engine keys its
        # persistent device-side plan buffers on it — an unchanged epoch
        # means the buffers can advance on device with zero host uploads.
        self.plan_epoch = 0
        self.pool = PagePool(serve.num_pages)
        self.waiting: Deque[_Sequence] = deque()
        self.slots: List[Optional[_Sequence]] = \
            [None] * serve.max_batch_slots
        self.finished: List[_Sequence] = []
        self._admit_order: List[_Sequence] = []   # running, oldest first
        self._rid = itertools.count()
        # page-utilization running aggregates (bounded, unlike a sample
        # list, for long-lived engines)
        self.util_peak = 0
        self.util_sum = 0
        self.util_steps = 0

    # ---------------- submission ----------------------------------- #
    def submit(self, prompt: Seq[int], sampling: SamplingParams = None,
               max_new_tokens: int = None, prefix_extra: int = 0) -> int:
        s = self.serve
        if not len(prompt):
            raise ValueError("empty prompt")
        max_new = max_new_tokens if max_new_tokens is not None \
            else s.max_new_tokens
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        total = prefix_extra + len(prompt) + max_new
        if total > s.max_seq_len:
            raise ValueError(
                f"request needs {total} cache tokens > max_seq_len "
                f"{s.max_seq_len}")
        if self._worst_case_pages(total + 1) > s.num_pages - 1:
            raise ValueError(
                f"request worst case {self._worst_case_pages(total + 1)} "
                f"pages > pool {s.num_pages - 1}; would deadlock")
        req = Request(next(self._rid), list(prompt),
                      sampling or SamplingParams(), max_new, prefix_extra)
        rec = obs.get()
        self.waiting.append(_Sequence(
            req, submit_ns=obs.perf_ns() if rec.enabled else 0))
        rec.gauge("serve.queue_depth").set(len(self.waiting))
        return req.rid

    # ---------------- SWA reclamation ------------------------------- #
    def _page_dead(self, lp: int, pos: int) -> bool:
        """True when logical page lp holds no position a decode step at
        write position `pos` (or any later one) can still attend: the
        kernel masks t > pos - window, and pos only grows."""
        return self.window > 0 and \
            (lp + 1) * self.serve.page_size - 1 <= pos - self.window

    def _worst_case_pages(self, tokens: int) -> int:
        """Peak pages one sequence can hold at once. With a sliding
        window, fully out-of-window pages are reclaimed each step, so the
        footprint is bounded by the pages a window-length span can
        straddle (+1 for the page being written), not by `tokens`."""
        p = self.serve.pages_for(tokens)
        if self.window > 0:
            p = min(p, self.serve.pages_for(self.window) + 1)
        return p

    def _reclaim(self, seq: _Sequence) -> None:
        """Free pages that slid fully out of seq's window; null their
        table entries so the kernel never touches them again."""
        dead = [lp for lp, pg in enumerate(seq.pages)
                if pg != NULL_PAGE and self._page_dead(lp, seq.pos)]
        if not dead:
            return
        self.pool.free([seq.pages[lp] for lp in dead])
        for lp in dead:
            seq.pages[lp] = NULL_PAGE
        self.plan_epoch += 1
        self.reclaimed_pages += len(dead)
        obs.get().counter("serve.page_reclaims").inc(len(dead))

    def has_work(self) -> bool:
        return bool(self.waiting) or any(self.slots)

    @property
    def running(self) -> List[_Sequence]:
        return list(self._admit_order)

    # ---------------- admission ------------------------------------ #
    def poll_admissions(self) -> List[_Sequence]:
        """Admit waiting sequences while a slot is free and the pool can
        hold their current prompt. Returns sequences the engine must
        prefill (pages already allocated, slot assigned, pos set)."""
        out = []
        while self.waiting:
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            if not free_slots:
                break
            seq = self.waiting[0]
            need = seq.req.prefix_extra + len(seq.cached_prompt)
            # prompt positions already out of window get holes up front:
            # their prefill KV chunks land in the never-read null page
            n_log = self.serve.pages_for(need)
            live = [lp for lp in range(n_log)
                    if not self._page_dead(lp, need)]
            pages = self.pool.alloc(len(live))
            if pages is None:
                break
            self.waiting.popleft()
            seq.state = RUNNING
            seq.slot = free_slots[0]
            seq.pages = [NULL_PAGE] * n_log
            for lp, pg in zip(live, pages):
                seq.pages[lp] = pg
            seq.pos = need
            self.slots[seq.slot] = seq
            self._admit_order.append(seq)
            out.append(seq)
        if out:
            self.plan_epoch += 1
        rec = obs.get()
        if rec.enabled:
            rec.gauge("serve.queue_depth").set(len(self.waiting))
            if out:
                rec.counter("serve.admissions").inc(len(out))
        return out

    # ---------------- per-step assembly ----------------------------- #
    def _evict(self, seq: _Sequence) -> None:
        self.plan_epoch += 1
        obs.get().counter("serve.evictions").inc()
        self.pool.free([p for p in seq.pages if p != NULL_PAGE])
        seq.pages = []
        self.slots[seq.slot] = None
        seq.slot = -1
        self._admit_order.remove(seq)

    def prepare_step(self) -> Optional[StepPlan]:
        """Ensure every running sequence has a page mapped for the position
        it is about to write; preempt (newest-first) on exhaustion. Returns
        None when nothing is running."""
        ps = self.serve.page_size
        if self.window > 0:
            # reclaim before growth so freed pages can back this very
            # step's new allocations (bounded-pool long decode)
            for seq in self._admit_order:
                self._reclaim(seq)
        for seq in list(self._admit_order):
            if seq.state != RUNNING:
                continue
            if seq.pos % ps == 0:            # next write opens a new page
                while True:
                    page = self.pool.alloc(1)
                    if page is not None:
                        seq.pages.extend(page)
                        self.plan_epoch += 1
                        break
                    # newest victim; never preempt `seq` unless it is alone
                    victim = self._admit_order[-1]
                    if victim is seq and len(self._admit_order) > 1:
                        victim = self._admit_order[-2]
                    if victim is seq:
                        # alone and out of pages: impossible under the
                        # submit() guard unless the pool leaked
                        raise RuntimeError(
                            "page pool exhausted by a single sequence")
                    self._preempt_seq(victim)
                if seq.state != RUNNING:
                    continue
        if not self._admit_order:
            return None

        n, P = self.serve.max_batch_slots, self.serve.max_pages_per_seq
        plan = StepPlan(
            tokens=np.zeros(n, np.int32),
            page_table=np.full((n, P), NULL_PAGE, np.int32),
            seq_lens=np.zeros(n, np.int32),
            active=np.zeros(n, bool),
            temperature=np.zeros(n, np.float32),
            top_k=np.zeros(n, np.int32),
            top_p=np.ones(n, np.float32),
            seed=np.zeros(n, np.uint32),
            step=np.zeros(n, np.int32),
        )
        for seq in self._admit_order:
            i = seq.slot
            sp = seq.req.sampling
            plan.tokens[i] = seq.next_token
            plan.page_table[i, :len(seq.pages)] = seq.pages
            plan.seq_lens[i] = seq.pos
            plan.active[i] = True
            plan.temperature[i] = sp.temperature
            plan.top_k[i] = sp.top_k
            plan.top_p[i] = sp.top_p
            plan.seed[i] = np.uint32(sp.seed)
            plan.step[i] = len(seq.generated)
        used = self.pool.used_pages
        self.util_peak = max(self.util_peak, used)
        self.util_sum += used
        self.util_steps += 1
        obs.get().gauge("serve.page_util").set(
            used / max(self.serve.num_pages - 1, 1))
        return plan

    def steady_horizon(self) -> int:
        """Decode ticks (>= 1) for which the plan just returned by
        ``prepare_step`` is *provably* epoch-stable, so the engine may fuse
        them into one device megastep. Within the horizon no plan-changing
        event can fire: no row crosses a page boundary (growth), no row
        exhausts its budget before the final tick (finish/evict), and —
        since nothing finishes, grows, or is preempted — no pages or slots
        free up, so blocked admissions stay blocked. EOS can end a row on
        any sampled token, so an armed ``eos_id`` pins the horizon to 1;
        SWA reclamation is merely postponed to the horizon's end, which is
        safe (dead pages are already masked out of attention) and keeps the
        reclaim-before-growth ordering the bounded-pool guarantee needs."""
        h = self.serve.megastep
        if h <= 1 or self.serve.eos_id >= 0:
            return 1
        ps = self.serve.page_size
        for seq in self._admit_order:
            h = min(h, seq.budget_left,            # finish only at the end
                    ps - (seq.pos % ps))           # ticks to next new page
        return max(h, 1)

    def _preempt_seq(self, victim: _Sequence) -> None:
        self._evict(victim)
        victim.state = WAITING
        victim.pos = 0
        victim.preemptions += 1
        self.waiting.appendleft(victim)
        rec = obs.get()
        rec.counter("serve.preemptions").inc()
        if rec.enabled:
            rec.event("preempt", track="serve", rid=victim.req.rid,
                      generated=len(victim.generated))

    # ---------------- commit ---------------------------------------- #
    def record_first_token(self, seq: _Sequence, token: int) -> bool:
        """Record the token sampled from prefill logits. Returns True if
        the sequence finished immediately (budget 1 or EOS)."""
        return self._append(seq, token)

    def commit_step(self, sampled: np.ndarray) -> List[_Sequence]:
        """Apply sampled tokens [slots] after a decode step; the fed token
        is now cached, so pos advances. Returns newly finished sequences."""
        done = []
        for seq in list(self._admit_order):
            tok = int(sampled[seq.slot])
            seq.pos += 1
            if self._append(seq, tok):
                done.append(seq)
        return done

    def _append(self, seq: _Sequence, token: int) -> bool:
        seq.generated.append(token)
        seq.next_token = token
        if seq.submit_ns and len(seq.generated) == 1:
            obs.get().histogram("serve.ttft_ms").observe(
                (obs.perf_ns() - seq.submit_ns) / 1e6)
        eos = self.serve.eos_id
        if seq.budget_left <= 0 or (eos >= 0 and token == eos):
            self._evict(seq)
            seq.state = FINISHED
            self.finished.append(seq)
            return True
        return False

    # ---------------- accounting ------------------------------------ #
    def clear_finished(self) -> List[_Sequence]:
        """Hand over and drop the finished-sequence history (long-lived
        servers call this after consuming results to bound memory)."""
        done, self.finished = self.finished, []
        return done

    def check_invariants(self) -> None:
        live = [p for s in self._admit_order for p in s.pages
                if p != NULL_PAGE]
        if len(live) != len(set(live)):
            raise RuntimeError("page double-booked")
        if len(live) + self.pool.free_pages != self.serve.num_pages - 1:
            raise RuntimeError("page leak")
        for i, s in enumerate(self.slots):
            if s is not None and s.slot != i:
                raise RuntimeError("slot table corrupt: sequence in "
                                   f"slot {i} thinks it is in {s.slot}")
