"""Serving engine: prefill -> paged continuous-batching decode -> streams.

The port of ``repro/serve/engine.py`` (``Engine``). One ``Engine.step()``
is one scheduler iteration:

  1. admit waiting requests as a wave: one batched prefill and one pool
     write per distinct (bucketed) prompt length, then one batched call
     that samples every admission's first token (recurrent state goes
     into the admissions' decode slots);
  2. assemble the step (page table, seq lens, per-row sampling knobs),
     preempting newest-first if the pool cannot grow someone's cache;
  3. ask the scheduler how many ticks the plan is provably stable for
     (``Scheduler.steady_horizon``) and run that many decode+sample ticks
     (``_megastep``, a Python loop where the JAX package scans); sampled
     tokens stay on the device and feed the next tick;
  4. copy the megastep's [horizon, slots] tokens to the host once, commit
     them tick by tick, emit stream events and evict finished sequences.

Whisper and LLaVA requests carry no audio or image: each admission's
prefill takes zero frame / image embeddings, as in the JAX package (the
front ends are stubs there too), and a LLaVA request's image tokens
count in its cache length (``Scheduler.submit``'s ``prefix_extra``).

The plan is uploaded once per step, where the JAX package keeps it on the
device across epoch-stable steps. The flight recorder's spans, metrics and
memory tags are the JAX package's (``serve/tick``, ``serve/prefill``,
``serve/decode``, ``serve/sample``, ``serve/run``; ``serve.decode_token_ms``,
``serve.decode_tokens``, ``serve.kv_pages_used_bytes``; ``serve.kv_pages``
and ``serve.params``). With a recorder armed the decode span ends in a
device synchronise, so it measures the megastep's device time; without
one nothing waits that would not wait anyway.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence as Seq

import numpy as np
import torch

from .. import obs
from ..configs.base import ATTN, LaneConfig, ModelConfig
from ..configs.serve import ServeConfig
from ..core import api
from ..core.prng import MASK32
from ..models.transformer import make_paged_caches
from . import kv_pages, sampler
from .sampler import SamplingParams
from .scheduler import Scheduler


@dataclass
class StreamEvent:
    rid: int
    token: int
    text: str
    finished: bool = False


def _default_detok(token: int) -> str:
    return f"{token} "


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class Engine:
    def __init__(self, cfg: ModelConfig, serve: Optional[ServeConfig] = None,
                 lane: Optional[LaneConfig] = None, params=None,
                 init_seed: int = 0,
                 detok: Optional[Callable[[int], str]] = None,
                 device=None):
        self.cfg = cfg
        self.serve = serve or ServeConfig()
        self.lane = lane or LaneConfig()
        self.detok = detok or _default_detok
        self.device = api.resolve_device(device)
        s = self.serve
        worst = s.max_pages_per_seq
        if cfg.sliding_window:
            # SWA reclamation bounds a sequence's footprint by its window
            worst = min(worst, s.pages_for(cfg.sliding_window) + 1)
        if worst > s.num_pages - 1:
            raise ValueError(
                f"pool of {s.num_pages - 1} usable pages cannot hold one "
                f"max-length sequence ({worst} pages); raise "
                "num_pages or lower max_seq_len")
        self._attn_only = all(k == ATTN for k in cfg.pattern)
        self.params = params if params is not None else api.init(
            cfg, self.lane, seed=init_seed, device=self.device,
            max_seq=s.max_seq_len)
        raw = make_paged_caches(cfg, s.max_batch_slots, s.num_pages,
                                s.page_size, device=self.device)
        self.caches = api.split_caches(raw, cfg, self.lane)
        self.sched = Scheduler(s, window=cfg.sliding_window or 0)
        self.steps_run = 0
        self.ticks_run = 0          # decode ticks over all megasteps
        # memory ledger: the page pool is allocated up front and lives as
        # long as the engine; register the whole block plus the params.
        # The used share of the pool feeds serve.kv_pages_used_bytes
        rec = obs.get()
        self._pool_nbytes = 0
        if rec.enabled:
            self._pool_nbytes = obs.memory.tree_nbytes(self.caches)
            rec.memory.rebind("serve.kv_pages", self._pool_nbytes,
                              key=("engine", id(self)))
            rec.memory.rebind("serve.params",
                              obs.memory.tree_nbytes(self.params),
                              key=("engine", id(self)))

    # ------------------------------------------------------------- #
    def submit(self, prompt: Seq[int],
               sampling: Optional[SamplingParams] = None,
               max_new_tokens: Optional[int] = None) -> int:
        return self.sched.submit(prompt, sampling or SamplingParams(),
                                 max_new_tokens,
                                 prefix_extra=self.cfg.num_image_tokens)

    def _tensor(self, values, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=dtype,
                               device=self.device)

    def _sample_admitted(self, seqs, logits_parts,
                         events: List[StreamEvent]) -> None:
        """Sample the first token of every admission in one batched call
        and one device->host copy."""
        if not seqs:
            return
        logits = torch.cat(logits_parts) if len(logits_parts) > 1 \
            else logits_parts[0]
        sps = [s.req.sampling for s in seqs]
        if all(sp.temperature <= 0 for sp in sps):
            toks = sampler.greedy_tokens(logits)
        else:
            toks = sampler.sample_tokens(
                logits,
                self._tensor([sp.temperature for sp in sps], torch.float32),
                self._tensor([sp.top_k for sp in sps], torch.int32),
                self._tensor([sp.top_p for sp in sps], torch.float32),
                self._tensor([sp.seed & MASK32 for sp in sps], torch.int64),
                self._tensor([len(s.generated) for s in seqs], torch.int32),
                vocab_size=self.cfg.vocab_size)
        for seq, tok in zip(seqs, toks.cpu().tolist()):
            finished = self.sched.record_first_token(seq, tok)
            events.append(StreamEvent(seq.req.rid, tok, self.detok(tok),
                                      finished))

    def _prefill_len(self, seq) -> int:
        """The prefill's text length: the prompt's, or with bucketing its
        next power of two, capped so that the image tokens and the text
        fit ``max_seq_len``."""
        s_tok = len(seq.cached_prompt)
        if self.serve.bucket_prompts and self._attn_only:
            s_tok = min(_next_pow2(s_tok), self.serve.max_seq_len
                        - self.cfg.num_image_tokens)
        return s_tok

    def _admit_wave(self, seqs):
        """Prefill and page-write a whole admission wave, one prefill call
        per distinct (bucketed) prompt length. Returns (seqs in processing
        order, their prefill-logit blocks)."""
        s = self.serve
        groups: Dict[int, list] = {}
        for seq in seqs:                       # group, keep arrival order
            groups.setdefault(self._prefill_len(seq), []).append(seq)
        ordered, logits_parts = [], []
        for s_tok, group in groups.items():
            toks = np.zeros((len(group), s_tok), np.int64)
            for i, seq in enumerate(group):
                prompt = seq.cached_prompt
                toks[i, :len(prompt)] = prompt
            last = [seq.pos - 1 for seq in group]   # counts image tokens
            logits, dense = api.prefill_logits(
                self.params, self.cfg, self._tensor(toks, torch.int64),
                self._tensor(last, torch.int64),
                **api.stub_inputs(self.cfg, len(group), self.device))
            kv_pages.admit_prefill(self.caches, dense, self.cfg,
                                   [q.slot for q in group],
                                   [q.pages for q in group], s.page_size,
                                   table_width=s.max_pages_per_seq)
            ordered.extend(group)
            logits_parts.append(logits)
        return ordered, logits_parts

    def _megastep(self, plan, horizon: int, greedy: bool) -> torch.Tensor:
        """``horizon`` decode+sample ticks. Each tick decodes one token per
        row and samples the next; positions and sample indices advance by
        the active mask, on the device. Returns [horizon, slots] tokens."""
        tok = self._tensor(plan.tokens, torch.int64)
        table = self._tensor(plan.page_table, torch.int32)
        seq_lens = self._tensor(plan.seq_lens, torch.int32)
        step = self._tensor(plan.step, torch.int32)
        mask = self._tensor(plan.active, torch.int32)
        if not greedy:
            temperature = self._tensor(plan.temperature, torch.float32)
            top_k = self._tensor(plan.top_k, torch.int32)
            top_p = self._tensor(plan.top_p, torch.float32)
            seed = self._tensor(plan.seed.astype(np.int64), torch.int64)
        toks = []
        for _ in range(horizon):
            logits = api.decode_step_paged(self.params, self.cfg,
                                           tok[:, None], self.caches, table,
                                           seq_lens)
            if greedy:
                tok = sampler.greedy_tokens(logits)
            else:
                tok = sampler.sample_tokens(
                    logits, temperature, top_k, top_p, seed, step,
                    vocab_size=self.cfg.vocab_size)
            toks.append(tok)
            seq_lens = seq_lens + mask
            step = step + mask
        return torch.stack(toks)

    # ------------------------------------------------------------- #
    @torch.no_grad()
    def step(self) -> List[StreamEvent]:
        """One engine iteration; returns the stream events it produced."""
        rec = obs.get()
        with rec.span("serve/tick", track="serve"):
            events: List[StreamEvent] = []
            with rec.span("serve/prefill", track="serve"):
                waiting = self.sched.poll_admissions()
                if waiting:
                    seqs, logits_parts = self._admit_wave(waiting)
                    self._sample_admitted(seqs, logits_parts, events)
            plan = self.sched.prepare_step()
            if plan is None:
                return events
            H = self.sched.steady_horizon()
            # all-greedy megasteps skip the sampler's filters and noise
            greedy = not bool(plan.temperature.any())
            with rec.span("serve/decode", track="serve",
                          rows=plan.num_active, ticks=H) as dsp:
                toks_dev = self._megastep(plan, H, greedy)
                if rec.enabled and toks_dev.is_cuda:
                    torch.cuda.synchronize(toks_dev.device)
            with rec.span("serve/sample", track="serve",
                          rows=plan.num_active):
                toks = toks_dev.cpu().numpy()   # the megastep's one copy
            if rec.enabled and plan.num_active:
                # the decode span waited for the tokens, so its duration
                # is the megastep's; per row and tick it is the per-token
                # latency
                rec.histogram("serve.decode_token_ms").observe(
                    dsp.dur_ns / 1e6 / (plan.num_active * H))
                rec.counter("serve.decode_tokens").inc(plan.num_active * H)
                # occupied slice of the (up-front) pool allocation
                rec.gauge("serve.kv_pages_used_bytes").set(
                    self._pool_nbytes * self.sched.pool.used_pages
                    // max(self.serve.num_pages - 1, 1))
            for t in range(H):
                active = list(self.sched.running)
                done = {s.req.rid for s in self.sched.commit_step(toks[t])}
                for seq in active:
                    tok = seq.generated[-1]
                    events.append(StreamEvent(seq.req.rid, tok,
                                              self.detok(tok),
                                              seq.req.rid in done))
            self.steps_run += 1
            self.ticks_run += H
            return events

    def run(self, callback: Optional[Callable[[StreamEvent], None]] = None,
            max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Drive until every submitted request finishes. Returns
        rid -> generated tokens for requests that finished during THIS
        call; ``callback`` sees every stream event."""
        start = len(self.sched.finished)
        with obs.get().span("serve/run", track="serve"):
            for _ in range(max_steps):
                if not self.sched.has_work():
                    break
                for ev in self.step():
                    if callback is not None:
                        callback(ev)
            else:
                raise RuntimeError("engine did not drain within max_steps")
        self.sched.check_invariants()
        return {s.req.rid: list(s.generated)
                for s in self.sched.finished[start:]}

    def generate(self, prompts: Seq[Seq[int]],
                 sampling: Optional[SamplingParams] = None,
                 max_new_tokens: Optional[int] = None) -> List[List[int]]:
        rids = [self.submit(p, sampling, max_new_tokens) for p in prompts]
        out = self.run()
        return [out[r] for r in rids]

    def release_memory_tags(self):
        """Rebind this engine's ledger registrations to zero. Call when
        retiring an engine whose process keeps running (a benchmark that
        builds several engines); live bytes otherwise keep counting the
        dead pool."""
        rec = obs.get()
        if rec.enabled and self._pool_nbytes:
            rec.memory.rebind("serve.kv_pages", 0, key=("engine", id(self)))
            rec.memory.rebind("serve.params", 0, key=("engine", id(self)))
            self._pool_nbytes = 0

    def page_utilization(self) -> Dict[str, float]:
        total = self.serve.num_pages - 1
        s = self.sched
        mean = s.util_sum / s.util_steps if s.util_steps else 0.0
        return {"total_pages": total,
                "peak_pages": int(s.util_peak),
                "mean_pages": mean,
                "peak_util": s.util_peak / total,
                "mean_util": mean / total,
                "reclaimed_pages": int(s.reclaimed_pages)}


# ----------------------------------------------------------------- #
# dense static-batch baseline
# ----------------------------------------------------------------- #
class DenseServer:
    """Greedy static-batch decode with a dense grown KV cache, the
    baseline the paged engine is held against (``repro/serve/engine.py``
    ``DenseServer``). The caches follow the params' device; they are
    written in place each step. A LLaVA prompt's cache holds its image
    tokens before the text, so ``total`` counts them."""

    def __init__(self, cfg: ModelConfig, params, batch: int,
                 prompt_len: int, max_new_tokens: int):
        self.cfg, self.params = cfg, params
        self.B, self.Lp = batch, prompt_len
        self.max_new = max_new_tokens
        self.total = cfg.num_image_tokens + prompt_len + max_new_tokens
        self.device = params["embed"].device

    @torch.no_grad()
    def generate(self, prompts: np.ndarray) -> np.ndarray:
        """prompts [B, Lp] int -> [B, max_new_tokens] int64."""
        if prompts.shape != (self.B, self.Lp):
            raise ValueError(f"prompts shape {prompts.shape} != "
                             f"{(self.B, self.Lp)}")
        cfg = self.cfg
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                               device=self.device)
        nxt, caches = api.prefill_step(self.params, cfg, toks,
                                       **api.stub_inputs(cfg, self.B,
                                                         self.device))
        caches = kv_pages.grow_dense_caches(caches, cfg, self.total)
        out = [nxt]
        start = cfg.num_image_tokens + self.Lp
        for cur in range(start, start + self.max_new - 1):
            nxt, caches = api.decode_step(self.params, cfg, nxt, caches, cur)
            out.append(nxt)
        return torch.cat(out, dim=1).cpu().numpy()


def dense_generate(cfg: ModelConfig, params, prompts: np.ndarray,
                   max_new_tokens: int) -> np.ndarray:
    """One-shot wrapper around ``DenseServer``."""
    B, Lp = prompts.shape
    return DenseServer(cfg, params, B, Lp, max_new_tokens).generate(prompts)

