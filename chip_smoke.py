#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the repository root: ``python3 chip_smoke.py``. It builds the
CUDA kernels from ``src/repro_torch/csrc`` with nvcc and holds each
kernel against its plain PyTorch version at the shapes its path gives
it. Then it drives the port's paths and checks that each went through
its kernels: it checks small (reduced, f32) qwen3-4b, Jamba, RWKV6 and
Mixtral models on the card against the CPU, serves eight requests with
qwen3-4b at full width and depth (36 layers, bf16, random weights from a
seed), with Jamba at full width and one period of its four (8 layers:
Mamba, attention and MoE blocks) and with RWKV6-1.6B at full width and 12
of its 24 layers, trains LeNet-5 in the paper's four fp32
lanes (Table 1) and in its three ElasticZO-INT8 lanes in both loss modes
(Table 1's INT8 and INT8* columns, integer arithmetic through the int8
kernels), runs the seed-ledger fleet (``repro_torch.fleet``) on the
paper's int8 LeNet-5 and on qwen3-4b at full width (two layers), each
through chaos and a crash whose catch-up replays several ledger steps in
one launch, every worker and the single-process reference bitwise the
canon, trains PointNet, the paper's second model, in its four fp32
lanes (Table 1, then timed at Fig. 6's 1024 points), runs its full-width
int8 forward against the CPU, runs the paper-table runner
(``repro_torch.benchmarks.run --fast``) in process and its Table 2 once
more (the rows must repeat), trains qwen3-4b at full width and depth for
a few ElasticZO steps, unfused and with the fused antithetic probe pair
at seq 4096 (the ZO forwards and the prefill attend through the flash
kernel), and trains the other families: RWKV6-1.6B whole, Mixtral at
full width and 8 of its 32 layers, and Jamba at full width and one
period (unfused, and RWKV6 and Mixtral also with fused probes at seq
4096 and 4608; launch counts, a moved head and tail, a bitwise rerun),
reduced Mixtral, RWKV6 and two-period Jamba steps on the card against
the CPU, and ``launch.train --profile-phases`` on RWKV6-1.6B. Then it
serves and trains Whisper's encoder-decoder (whisper-small whole) and
LLaVA's image-token prefix (llava-next-34b at full width, 16 of its 60
layers, 2,880 image tokens before the text), unfused and with fused
probes, and holds reduced Whisper and LLaVA on the card to the CPU. The
LeNet-5 and PointNet lanes run through the package's own harness
(``benchmarks/paper_tables.py``); the LeNet-5 lanes' training memory over
a loop is held to the step's memory account
(``core/engine.py::step_memory_analysis``), after a phase shows the
one-time workspace that the process's first backward allocates. It also
trains qwen3-4b through the launcher's prefetching data pipeline
(``data/pipeline.py``) with a checkpoint and an elastic resume
(``train/elastic_runtime.py``), bytes-equal to a straight run, holds the
optimizers (``train/optimizer.py``) on the card to the CPU, and runs the
four examples (``repro_torch.examples``) at their JAX twins' defaults.
Then it trains across a mesh (``launch/train.py --mesh``): the shard
forms of the two fp32 ZO kernels against their plain versions and a
2-D shard of w_gate against the whole leaf's noise; on a 2x2 mesh of
four spawned ranks sharing the card over gloo, qwen3-4b (4 of 36
layers, full width, tp), whisper-small (4 of 12 decoder and encoder
layers, full width, f32) under tp, fsdp and serve with fused probes
under tp and fsdp, llava-next-34b (2 of 60 layers, full width, f32)
under tp, and mixtral-8x7b (2 of 32 layers, full width, f32) under fsdp
with the batch over (data, model), so that the MoE's expert buffers go
through the dispatch all-to-all (each shard's noise bitwise the
one-device kernels' sliced, the coefficients bitwise across ranks every
step, losses and leaf moves against one device's, fused pairs bitwise
the unfused ones, the all-to-alls counted), reduced f32 qwen3-4b,
Whisper, LLaVA and Mixtral card against CPU (the seq plan and the MoE tp
plan at 1x4 too); and whole qwen3-4b on a 1x1 mesh over
NCCL, bitwise the one-device run (with four cards, also 2x2 over
NCCL). Last, it holds the dry run's cost model (``launch/dryrun.py``:
a step on ``meta`` tensors over a fake process group, counted) against
the card: the qwen3-4b train cell on the 16x16 production mesh through
the CLI, the unfused 4 x 128 step's launches, peak memory and bound
against the step measured here, and the 2x2 qwen3-4b ``tp`` lane's
collectives against a dry run of it, record for record on every rank.
It serves across a mesh too: in the same 2x2 world, qwen3-4b (4 of 36
layers, full width, bf16) prefills two 512-token prompts and decodes 16
greedy steps (``core/api.py::prefill_step`` / ``decode_step`` with a
``MeshRun``) with its KV heads over `model`, with the decode cache
context-sharded over `model`, and with a batch of one whose cache's
slots are split over `data`, each lane's tokens and caches against one
device's and its collectives against the dry run's; the dry run's
launches and peak of the same prefill and decode steps on a 1x1 mesh
against the card's; the CLI's serve cell (qwen3-4b decode_32k under
the serve strategy); and flash's log-sum-exp (``return_lse``) against
its plain version and float64, the output bitwise unchanged.

The last three lines of its output are the card's name and power limit
(nvidia-smi), a JSON line of per-kernel numbers, and
``{"ok": true, "device": {...}}``. Any failing phase raises: the script
then exits non-zero and prints no result. It needs one CUDA card and
imports nothing of JAX.
"""
import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

# the fleet's fp32 probes run under torch.use_deterministic_algorithms
# (core/api.py::deterministic), whose cuBLAS products need a fixed
# workspace configuration; cuBLAS reads it once, at the process's first
# product, so it is set before any phase runs
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
PAGED_BF16_TOL = 3e-2            # a few bf16 ulps of |o| <~ 1 (the plain
#                                  version rounds the softmax weights to
#                                  bf16 before the weighted sum; the kernel
#                                  keeps them in f32)
PAGED_F32_TOL = 1e-5             # summation order only
ZO_CHUNK = 1 << 26               # flat elements per plain-version chunk
# the largest ZO leaf a training phase gives the ZO kernels: the stacked
# expert w_gate of the Mixtral cut's 7 ZO periods, 7 x 8 x 4096 x 14336 =
# 3,288,334,336 bf16 elements, whose flat indices pass 2**31 (whole when
# unfused and in the update, period 6's slice at offset 6 x 469,762,048
# when fused)
ZO_LARGE = (7, 8, 4096, 14336)
INT8_OPS_PER_S = 1979e12         # H100 SXM dense int8 tensor-core peak
# SASS instructions that run on the INT32 (ALU) pipe; IMAD goes to the
# FMA pipe, and ops of unknown pipe are left out, so a bound from this
# set stays a lower bound
ALU_OPS = {"LOP3", "SHF", "IADD3", "ISETP", "VIMNMX", "IMNMX", "VIADD",
           "SEL", "PRMT", "IABS", "LEA"}
WARM_CALLS = 8                   # device_ms's discarded calls a profile
MEMORY_AGREE = 0.01              # a loop's training memory against the
#                                  step's memory account, relative
INT8_LEAF = (35, 2560, 9728)     # qwen3-4b's w_gate count, 871,628,800


_PHASE = {"name": None, "t0": None, "start": time.perf_counter()}


def phase(name):
    """Starts a phase, printing the wall time of the one before."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        print(f"-- {_PHASE['name']}: {now - _PHASE['t0']:.1f} s wall", flush=True)
    _PHASE.update(name=name, t0=now)
    if name is not None:
        print(f"== {name}", flush=True)


def _kernel_events(prof):
    """(device microseconds, kernel records) of a profile."""
    evs = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")]
    return (sum(e.self_device_time_total for e in evs),
            sum(e.count for e in evs))


def _kernel_us(prof):
    return _kernel_events(prof)[0]


class ProfilerDroppedRecords(RuntimeError):
    """The profiler kept dropping kernel records: a timing could not be
    read, as distinct from a kernel that failed."""


def device_ms(fn, iters=30, flush=None, attempts=5):
    """Device time of one fn() call in ms, for kernels under a
    millisecond: the kernels' own durations as the profiler (CUPTI)
    records them, summed over ``iters`` calls, so the host's time to
    issue a call is not counted. ``flush`` (a buffer larger than L2) is
    rewritten before every call so fn meets a cold cache; the flush
    kernels' time, from a run of flushes alone, is subtracted.

    The profiler drops the first kernel records of a session on this
    card, so each profile opens with a warm-up step of ``WARM_CALLS``
    calls whose records are discarded, and every call is synchronised. A
    run counts only if it holds ``iters`` times the records of a single
    profiled call; a run that falls short is profiled again, and after
    ``attempts`` short runs the check fails. Time kernels of a
    millisecond or more with event_ms: over runs of them the profiler
    under-reported durations."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(3):
        fn()

    def calls(call, n):
        for _ in range(n):
            if flush is not None:
                flush.zero_()
            if call:
                fn()
            torch.cuda.synchronize()

    def run(call, n):
        got = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: got.append(_kernel_events(p))
                     ) as prof:
            calls(call, WARM_CALLS)
            prof.step()
            calls(call, n)
            prof.step()
        return got[0]

    def full(call):
        for _ in range(attempts):
            one = run(call, 1)[1]
            us, got = run(call, iters)
            if one and got == iters * one:
                return us
            print(f"  (the profiler recorded {got} of {iters} x {one} kernel "
                  "records; profiled again)")
        raise ProfilerDroppedRecords(f"the profiler dropped kernel records "
                                     f"in {attempts} runs")
    base = full(False) if flush is not None else 0.0
    return (full(True) - base) / iters / 1e3


def tiny_ms(fn, what):
    """``device_ms(fn)`` for a kernel of a few microseconds, or, where the
    profiler keeps dropping its records (it did, once, for LeNet-5's int8
    leaves after the earlier phases of a full run), ``graph_ms(fn)``, and
    says so."""
    try:
        return device_ms(fn)
    except ProfilerDroppedRecords as e:
        print(f"  ({what}: {e}; timed as a CUDA graph of 100 calls)")
        return graph_ms(fn)


def event_ms(fn, iters, flush=None):
    """fn()'s time in ms from CUDA events around ``iters`` back-to-back
    calls after one warm-up call (less a run of the flushes alone), for
    kernels of a millisecond or more, behind which the host's issue time
    hides."""
    fn()

    def run(call):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            if flush is not None:
                flush.zero_()
            if call:
                fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)
    base = run(False) if flush is not None else 0.0
    return (run(True) - base) / iters


def graph_ms(fn, calls=100):
    """Device time of one fn() call in ms, without the profiler, for
    kernels of a few microseconds: ``calls`` calls captured in one CUDA
    graph and its replays timed with CUDA events. The host issues one
    launch for all of them, so its time to issue a call is not counted;
    the gap between two graph nodes is."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return event_ms(graph.replay, 5) / calls


def kernel_records(fn, calls=3, attempts=5, whole=None):
    """{kernel name: (records, device ms)} of ``calls`` fn() calls,
    profiled after WARM_CALLS discarded calls as device_ms does; a run
    whose records do not come in whole calls, or fail ``whole(records)``
    where it is given, is profiled again."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(attempts):
        got = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: got.append(
                         {e.key: (e.count, e.self_device_time_total / 1e3)
                          for e in p.key_averages()
                          if str(e.device_type).endswith("CUDA")})) as prof:
            for n in (WARM_CALLS, calls):
                for _ in range(n):
                    fn()
                    torch.cuda.synchronize()
                prof.step()
        if got and got[0] and all(c % calls == 0 for c, _ in got[0].values()) \
                and (whole is None or whole(got[0])):
            return got[0]
    raise ProfilerDroppedRecords(f"the profiler dropped kernel records in "
                                 f"{attempts} runs")


# --------------------------------------------------------------------- #
# paged attention at the serve path's shapes
# --------------------------------------------------------------------- #
PAGED_LENS = (0, 140, 270, 400, 530, 160, 290, 415)


def paged_case(dtype, window, P, seed=0, *, KVd=8, G=4, Dh=128, N=256,
               lens=PAGED_LENS):
    """len(lens) rows of decode against a pool of N pages of 16 positions
    (by default qwen3-4b's: KV=8 heads, G=4, Dh=128, 256 pages): row 0
    inactive (seq_len 0, all-null table), the others at the given
    lengths. With a window, row 6's out-of-window pages are reclaimed
    (nulled), as the scheduler does."""
    dev = torch.device("cuda")
    B, ps = len(lens), 16
    lens = list(lens)
    g = torch.Generator(device="cpu").manual_seed(seed)
    perm = (torch.randperm(N - 1, generator=g) + 1).tolist()
    table = torch.zeros((B, P), dtype=torch.int32)
    for b, n in enumerate(lens):
        for lp in range(n // ps + 1 if n else 0):
            table[b, lp] = perm.pop()
    if window:
        for lp in range(lens[6] // ps + 1):
            if (lp + 1) * ps - 1 <= lens[6] - window:
                table[6, lp] = 0
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dtype)  # noqa: E731
    return (rnd(B, KVd, G, Dh), rnd(B, KVd, Dh), rnd(B, KVd, Dh),
            rnd(N, ps, KVd, Dh), rnd(N, ps, KVd, Dh), table.to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def live_positions(table, lens, ps, window):
    n = 0
    for row, pos in zip(table.tolist(), lens.tolist()):
        lo = max(0, pos - window + 1) if window else 0
        n += sum(1 for t in range(lo, pos + 1) if row[t // ps] != 0)
    return n


def paged_shape(q, k_new, v_new, k_pool, v_pool, page_table, seq_lens, *,
                scale, window=0):
    """A paged_attention_step call's shapes: q, the pool, the table's
    width, the dtype and the window."""
    return (tuple(q.shape), tuple(k_pool.shape), page_table.shape[1],
            q.dtype, window)


def check_paged(paged_attn, ref, P):
    """Returns the kernel's numbers and ``held``, the set of
    ``paged_shape``s its check holds against the plain version."""
    out, held = {}, set()
    for dtype, tol in ((torch.float32, PAGED_F32_TOL),
                       (torch.bfloat16, PAGED_BF16_TOL)):
        for window in (0, 64):
            q, kn, vn, kp, vp, table, sl = paged_case(dtype, window, P)
            held.add(paged_shape(q, kn, vn, kp, vp, table, sl,
                                 scale=128 ** -0.5, window=window))
            kp2, vp2 = kp.clone(), vp.clone()
            o = paged_attn.paged_attention_step(
                q, kn, vn, kp, vp, table, sl, scale=128 ** -0.5,
                window=window)
            want = ref.paged_attn_step_ref(q, kn, vn, kp2, vp2, table, sl,
                                           scale=128 ** -0.5, window=window)
            torch.cuda.synchronize()
            if not (torch.equal(kp, kp2) and torch.equal(vp, vp2)):
                raise AssertionError(f"paged KV write differs ({dtype}, "
                                     f"window {window})")
            err = (o[1:].float() - want[1:].float()).abs().max().item()
            print(f"paged_attention_step {str(dtype)[6:]} window {window}: "
                  f"max |o - plain| over active rows = {err:.3g} "
                  f"(tolerance {tol})")
            if not err <= tol:
                raise AssertionError("paged attention disagrees with plain")
            if o[0].abs().max().item() != 0.0:
                raise AssertionError("inactive row must give o = 0")
            out[(dtype, window)] = err

    check_paged_dead_pages(paged_attn, ref, P)

    # timing at the main path's case: bf16, full attention
    q, kn, vn, kp, vp, table, sl = paged_case(torch.bfloat16, 0, P)
    records = {k: c for k, (c, _) in kernel_records(
        lambda: paged_attn.paged_attention_step(
            q, kn, vn, kp, vp, table, sl, scale=128 ** -0.5)).items()}
    print(f"paged_attention_step: kernel records per call {records} "
          "(3 calls)")
    if len(records) != 1 or sum(records.values()) != 3:
        raise AssertionError("paged_attention_step must be one kernel "
                             "launch a call")
    name = next(iter(records))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    scale = 128 ** -0.5
    ms = device_ms(lambda: paged_attn.paged_attention_step(
        q, kn, vn, kp, vp, table, sl, scale=scale), flush=flush)
    plain_ms = device_ms(lambda: ref.paged_attn_step_ref(
        q, kn, vn, kp, vp, table, sl, scale=scale), flush=flush)
    library_ms, bound, nbytes, live = paged_sdpa_and_bound(
        q, kn, vn, kp, vp, table, sl, flush)
    print(f"paged_attention_step bf16 B=8 live positions {live}: kernel "
          f"{ms:.4f} ms ({name[:60]}), plain {plain_ms:.4f} ms, SDPA on "
          f"gathered cache {library_ms:.4f} ms, bound {bound:.4f} ms "
          f"({nbytes} bytes); kernel / SDPA {ms / library_ms:.2f}")
    return dict(max_abs_err=out[(torch.bfloat16, 0)], ms=ms,
                plain_ms=plain_ms, bound_ms=bound, library_ms=library_ms,
                f32_err=max(out[(torch.float32, 0)],
                            out[(torch.float32, 64)]), held=held)


def paged_sdpa_and_bound(q, kn, vn, kp, vp, table, sl, flush):
    """(SDPA's ms on the already-gathered cache, the bound ms, its bytes,
    the live positions) of a bf16 paged decode step without a window.
    SDPA is the yardstick, not used by the port. The bound: each input
    read once (the live cache positions' K and V, the new token's, q,
    the table and lengths), the new K / V and o written once, over the
    card's memory rate, or the Q.K and P.V multiply-adds of the live
    positions over its bf16 rate, whichever is larger."""
    B, KVd, G, Dh = q.shape
    ps = kp.shape[1]
    k = kp[table.long()].reshape(B, -1, KVd, Dh).transpose(1, 2)
    v = vp[table.long()].reshape(B, -1, KVd, Dh).transpose(1, 2)
    k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    t = torch.arange(k.shape[2], device="cuda")
    mask = (t[None, :] <= sl[:, None]) & \
        (table != 0).repeat_interleave(ps, 1)
    qh = q.reshape(B, KVd * G, 1, Dh)
    library_ms = device_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, k, v, attn_mask=mask[:, None, None, :]), flush=flush)
    live = live_positions(table, sl, ps, 0)
    isz = 2
    nbytes = (q.numel() + kn.numel() + vn.numel()) * isz \
        + 2 * B * KVd * Dh * isz \
        + live * 2 * KVd * Dh * isz \
        + table.numel() * 4 + sl.numel() * 4 + q.numel() * isz
    ops = live * KVd * 4 * G * Dh
    bound = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
    return library_ms, bound, nbytes, live


def check_paged_at(paged_attn, ref, label, cfg, sc, lens):
    """paged_attention_step at a serve phase's own geometry: ``cfg``'s
    heads (G = num_heads / num_kv_heads; the kernel computes the next
    power of two of G, the extra heads zero) and ``sc``'s pool and table
    width, rows of ``lens`` positions, window 0. f32 and bf16 against the
    plain version (the KV write bitwise, active rows within tolerance,
    the inactive row 0), and the bf16 call timed beside its plain
    version. Returns (held shapes, numbers)."""
    KVd, Dh = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // KVd
    P, N, scale = sc.max_pages_per_seq, sc.num_pages, Dh ** -0.5
    held, errs = set(), {}
    for dtype, tol in ((torch.float32, PAGED_F32_TOL),
                       (torch.bfloat16, PAGED_BF16_TOL)):
        case = paged_case(dtype, 0, P, KVd=KVd, G=G, Dh=Dh, N=N, lens=lens)
        q, kn, vn, kp, vp, table, sl = case
        held.add(paged_shape(*case, scale=scale))
        kp2, vp2 = kp.clone(), vp.clone()
        o = paged_attn.paged_attention_step(q, kn, vn, kp, vp, table, sl,
                                            scale=scale)
        want = ref.paged_attn_step_ref(q, kn, vn, kp2, vp2, table, sl,
                                       scale=scale)
        torch.cuda.synchronize()
        err = (o[1:].float() - want[1:].float()).abs().max().item()
        errs[str(dtype)[6:]] = err
        print(f"paged_attention_step {label} {str(dtype)[6:]}: KV {KVd} x "
              f"G {G}, Dh {Dh}, pool {N} pages, table width {P}, lengths "
              f"{list(lens)}: max |o - plain| over active rows = {err:.3g} "
              f"(tolerance {tol})")
        if not (torch.equal(kp, kp2) and torch.equal(vp, vp2)):
            raise AssertionError(f"paged KV write differs ({label})")
        if not err <= tol or o[0].abs().max().item() != 0.0:
            raise AssertionError(f"paged attention {label} disagrees with "
                                 "its plain version")
        del case, q, kn, vn, kp, vp, kp2, vp2, o, want
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    q, kn, vn, kp, vp, table, sl = paged_case(
        torch.bfloat16, 0, P, KVd=KVd, G=G, Dh=Dh, N=N, lens=lens)
    ms = device_ms(lambda: paged_attn.paged_attention_step(
        q, kn, vn, kp, vp, table, sl, scale=scale), flush=flush)
    plain_ms = device_ms(lambda: ref.paged_attn_step_ref(
        q, kn, vn, kp, vp, table, sl, scale=scale), flush=flush)
    library_ms, bound, nbytes, live = paged_sdpa_and_bound(
        q, kn, vn, kp, vp, table, sl, flush)
    print(f"paged_attention_step {label} bf16 (live positions {live}): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA on the "
          f"gathered cache {library_ms:.4f} ms, bound {bound:.5f} ms "
          f"({nbytes} bytes); kernel at {100 * bound / ms:.0f}% of its bound")
    return held, dict(max_abs_err=errs["bfloat16"], f32_err=errs["float32"],
                      ms=ms, plain_ms=plain_ms, bound_ms=bound,
                      bound_by="bytes" if nbytes / HBM_BYTES_PER_S * 1e3
                      >= bound else "operations", library_ms=library_ms)


def check_paged_dead_pages(paged_attn, ref, P):
    """NaN in every pool page the tables do not reference (the null page
    and the pages reclaimed out of row 6's window) must not reach o: the
    kernel, given those pools, within tolerance of the plain version
    given the finite ones, on active rows; inactive row 0 still 0."""
    for dtype, tol in ((torch.float32, PAGED_F32_TOL),
                       (torch.bfloat16, PAGED_BF16_TOL)):
        q, kn, vn, kp, vp, table, sl = paged_case(dtype, 64, P)
        dead = torch.ones(kp.shape[0], dtype=torch.bool, device="cuda")
        dead[table.flatten().long()] = False
        dead[0] = True
        kp_nan, vp_nan = kp.clone(), vp.clone()
        kp_nan[dead] = float("nan")
        vp_nan[dead] = float("nan")
        o = paged_attn.paged_attention_step(
            q, kn, vn, kp_nan, vp_nan, table, sl, scale=128 ** -0.5,
            window=64)
        want = ref.paged_attn_step_ref(q, kn, vn, kp, vp, table, sl,
                                       scale=128 ** -0.5, window=64)
        torch.cuda.synchronize()
        err = (o[1:].float() - want[1:].float()).abs().max().item()
        print(f"paged_attention_step {str(dtype)[6:]} window 64 with "
              f"{int(dead.sum())} NaN-filled dead pages: o finite "
              f"{bool(torch.isfinite(o).all())}, max |o - plain| over "
              f"active rows = {err:.3g}")
        if not (bool(torch.isfinite(o).all()) and err <= tol
                and o[0].abs().max().item() == 0.0):
            raise AssertionError("NaN in a dead page reached o")


# --------------------------------------------------------------------- #
# top-k / top-p at the sampler's shapes
# --------------------------------------------------------------------- #
def check_topk(topk_mask, ref, V):
    g = torch.Generator(device="cpu").manual_seed(1)
    B = 8
    x = torch.randn(B, V, generator=g) * 3 / 0.8        # logits / temperature
    x[6] = torch.round(x[6])                             # long tied runs
    x[7, ::11] = -0.0
    x[7, 1::11] = 0.0
    x = x.cuda()
    k = torch.tensor([50, 0, 1, 0, 50, V, 20, 1000], dtype=torch.int32,
                     device="cuda")
    p = torch.tensor([0.95, 1.0, 1.0, 0.9, 1.0, 0.5, 0.8, 0.99],
                     device="cuda")
    got = topk_mask.topk_topp_mask(x, k, p)
    again = topk_mask.topk_topp_mask(x, k, p)
    want = ref.topk_topp_mask_ref(x, k, p)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("topk_topp_mask is not reproducible")
    keep, keep_want = got > -5e29, want > -5e29
    if not torch.equal(keep, keep_want):
        raise AssertionError("topk_topp_mask keep-set differs from plain: "
                             f"{(keep != keep_want).sum().item()} entries")
    err = (got - want).abs().max().item()
    print(f"topk_topp_mask B={B} V={V}: keep-sets equal, kept per row "
          f"{keep.sum(1).tolist()}, max |out - plain| = {err}")
    mixed_ms = device_ms(lambda: topk_mask.topk_topp_mask(x, k, p))
    # timing at the serve path's knobs: 4 sampled rows (top_k 50, top_p
    # 0.95) and 4 greedy rows, whose filters are off
    k = torch.tensor([50, 0] * 4, dtype=torch.int32, device="cuda")
    p = torch.tensor([0.95, 1.0] * 4, device="cuda")
    ms = device_ms(lambda: topk_mask.topk_topp_mask(x, k, p))
    plain_ms = device_ms(lambda: ref.topk_topp_mask_ref(x, k, p))
    nbytes = 2 * B * V * 4 + B * 8
    ops = 8 * B * V        # key, exp, divide and compares per element
    bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    print(f"topk_topp_mask at the serve knobs: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({nbytes} bytes); at "
          f"the mixed knobs above: kernel {mixed_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                library_ms=None)


# --------------------------------------------------------------------- #
# flash attention at the ZO forwards' and the prefill's shapes
# --------------------------------------------------------------------- #
FLASH_F32_TOL = 1e-5             # f32: the sums differ in order only
# (label, B, H, Hkv, Sq, Sk, D, dtype, causal, window): (a) the fused
# train path's forwards, (b) a serve prefill, (c) a sliding window, (d)
# the reduced model's head dim at ragged lengths, (i) the qwen3-4b fleet's
# probe forwards, (j) the serve phases' prefill groups (two prompts of
# each length; qwen3-4b's and Jamba's attention have the same heads), (k)
# the family train phases' probe forwards (Mixtral with its 4096 window,
# past it at seq 4608; Jamba)
FLASH_CASES = [
    ("(a) train, seq 4096", 1, 32, 8, 4096, 4096, 128, torch.bfloat16, True,
     0),
    ("(b) prefill, batch 8", 8, 32, 8, 512, 512, 128, torch.bfloat16, True, 0),
    ("(c) window 512", 1, 32, 8, 2048, 2048, 128, torch.bfloat16, True, 512),
    ("(d) reduced, ragged", 2, 4, 2, 100, 100, 16, torch.float32, True, 0),
    ("(d) reduced, Sq != Sk", 2, 4, 2, 100, 77, 16, torch.float32, False, 0),
    ("(i) fleet probe, seq 128", 1, 32, 8, 128, 128, 128, torch.bfloat16,
     True, 0),
] + [(f"(j) serve prefill group, seq {n}", 2, 32, 8, n, n, 128,
      torch.bfloat16, True, 0) for n in (128, 256, 384, 512)] + [
    ("(k) Mixtral train probe", 4, 32, 8, 128, 128, 128, torch.bfloat16,
     True, 4096),
    ("(k) Mixtral fused probe, seq 4608", 1, 32, 8, 4608, 4608, 128,
     torch.bfloat16, True, 4096),
    ("(k) Jamba train probe", 4, 32, 8, 128, 128, 128, torch.bfloat16, True,
     0)]
# Whisper's and LLaVA's serve prompts (two of each length) and train
# shapes (batch x text tokens)
WHISPER_PROMPTS = (64, 128, 256, 384)
LLAVA_PROMPTS = (128, 256, 384, 512)
WHISPER_TRAIN = ((4, 128), (1, 448))            # unfused, fused
LLAVA_TRAIN = ((2, 128), (1, 128))
LLAVA_IMAGE = 2880
# (l) Whisper (12 heads of 64): the encoder, non-causal over its 1,500
# frames (23 key tiles of 64 and a zero-filled one of 28), at each batch
# the serve and train phases give it; the decoder's causal self- and
# non-causal cross-attention at each prefill group and train shape; and
# the decode tick's cross-attention, one query a slot over 1,500 keys;
# (m) LLaVA (56 query / 8 KV heads of 128): each prefill group and the
# probe forwards, 2,880 image tokens before the text
FLASH_CASES += [
    (f"(l) Whisper encoder, batch {b}", b, 12, 12, 1500, 1500, 64,
     torch.bfloat16, False, 0) for b in (1, 2, 4)] + [
    (f"(l) Whisper {kind}, batch {b}, seq {n}", b, 12, 12, n,
     n if kind == "self" else 1500, 64, torch.bfloat16, kind == "self", 0)
    for b, n in [(2, n) for n in WHISPER_PROMPTS] + list(WHISPER_TRAIN)
    for kind in ("self", "cross")] + [
    ("(l) Whisper decode cross", 8, 12, 12, 1, 1500, 64, torch.bfloat16,
     False, 0)] + [
    (f"(m) LLaVA, batch {b}, seq {LLAVA_IMAGE + n}", b, 56, 8,
     LLAVA_IMAGE + n, LLAVA_IMAGE + n, 128, torch.bfloat16, True, 0)
    for b, n in [(2, n) for n in LLAVA_PROMPTS] + [LLAVA_TRAIN[1]]]
# (n) the mesh serve lanes' prefill (SERVE_MESH_LANES): a rank's row of
# a 512-token prompt on its 16 of qwen3-4b's 32 Q heads over 4 KV heads
FLASH_CASES += [("(n) 2x2 serve prefill, a rank's heads", 1, 16, 4, 512,
                 512, 128, torch.bfloat16, True, 0)]
# the bf16 tensor-core kernel's edge paths: head dims 16 and 64, ragged Sq
# != Sk, and windows under which rows past Sk + window - 1 see no key
FLASH_EDGE_CASES = [
    ("(e) D 16, window, rows see no key", 2, 4, 2, 100, 40, 16,
     torch.bfloat16, True, 8),
    ("(f) D 16, Sq != Sk", 2, 4, 2, 100, 77, 16, torch.bfloat16, False, 0),
    ("(g) D 64, Sq != Sk", 1, 8, 2, 130, 77, 64, torch.bfloat16, False, 0),
    ("(h) D 64, window, rows see no key", 1, 4, 1, 200, 90, 64,
     torch.bfloat16, True, 16),
]


def flash_inputs(B, H, Hkv, Sq, Sk, D, dtype, seed=0):
    """q, k, v as the model passes them: transposed views of [B, S,
    heads, D] tensors."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def make(heads, S):
        return torch.randn(B, S, heads, D, generator=g, device="cuda").to(
            dtype).transpose(1, 2)
    return make(H, Sq), make(Hkv, Sk), make(Hkv, Sk)


def flash_cost(q, k, causal, window, q_offset=0):
    """``kernels/cost.py::flash_attention`` of a call on q, k (bf16: the
    tensor cores' peak; the dry run prices the same calls so)."""
    from repro_torch.kernels import cost
    return cost.flash_attention(tuple(q.shape), tuple(k.shape), q.dtype,
                                causal=causal, window=window,
                                q_offset=q_offset)


def attention_f64(q, k, v):
    """Causal attention of q [B,H,S,D], k/v [B,Hkv,S,D] in float64."""
    G = q.shape[1] // k.shape[1]
    k, v = (t.double().repeat_interleave(G, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k) / q.shape[-1] ** 0.5
    pos = torch.arange(q.shape[2], device=q.device)
    s = torch.where(pos[None, :] <= pos[:, None], s, -1e30)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)


def check_flash_large_scores(flash_attn, ref, q, k, v):
    """(a) with q scaled by 8: scores up to ~40, where an f32 score's own
    rounding (~2e-6) moves outputs that cancel to |o| ~ 1e-5 by more than
    one bf16 ulp. Both the kernel and the f32 plain version are held to
    the attention in float64; the kernel may not miss it more often."""
    exact = attention_f64(q, k, v)
    tol = 2.0**-7 * exact.abs() + 1e-6
    counts = []
    for o in (flash_attn.flash_attention(q, k, v),
              ref.flash_attention_ref(q, k, v)):
        counts.append(int(((o.double() - exact).abs() > tol).sum()))
    print(f"flash_attention (a), q x 8, against float64: {counts[0]} of "
          f"{exact.numel()} outputs beyond one bf16 ulp of |o|; the f32 plain "
          f"version {counts[1]}")
    if counts[0] > counts[1]:
        raise AssertionError("flash attention at large scores misses the "
                             "float64 result more often than its plain "
                             "version")
    del exact, tol


def check_p_split(ref, q, k, v):
    """Why the kernel's P.V takes P in three bf16 terms: at (a), P fed to
    bf16 tensor cores as one, two (hi + lo) or three (hi + mid + lo) bf16
    terms, each term's products with V summed in f32, against the plain
    version. Prints the outputs beyond one bf16 ulp of |o| for each."""
    want = ref.flash_attention_ref(q, k, v).float()
    G = q.shape[1] // k.shape[1]
    k, v = (t.float().repeat_interleave(G, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) / q.shape[-1] ** 0.5
    pos = torch.arange(q.shape[2], device=q.device)
    rest = torch.softmax(torch.where(pos[None, :] <= pos[:, None], s, -1e30),
                         dim=-1)
    del s
    acc, counts = torch.zeros_like(want), []
    for _ in range(3):
        term = rest.bfloat16().float()
        rest -= term
        acc += torch.einsum("bhqk,bhkd->bhqd", term, v)
        o = acc.bfloat16().float()
        counts.append(int(((o - want).abs()
                           > 2.0**-7 * want.abs() + 1e-6).sum()))
        del term, o
    print(f"P.V at (a) with P as 1 / 2 / 3 bf16 terms: {counts[0]} / "
          f"{counts[1]} / {counts[2]} of {want.numel()} outputs beyond one "
          "bf16 ulp of the plain version")
    del rest, acc, want


def check_flash(flash_attn, ref):
    """flash_attention against its plain version at FLASH_CASES and
    FLASH_EDGE_CASES: f32 within FLASH_F32_TOL; bf16 within one bf16 ulp
    of |o| (both round one f32 result to bf16 once, and the f32 results
    differ by summation order only: the kernel's P.V takes P in three
    exact bf16 terms). Timed at (a), beside SDPA."""
    worst = 0.0
    for label, B, H, Hkv, Sq, Sk, D, dtype, causal, window in \
            FLASH_CASES + FLASH_EDGE_CASES:
        q, k, v = flash_inputs(B, H, Hkv, Sq, Sk, D, dtype)
        got = flash_attn.flash_attention(q, k, v, causal=causal,
                                         window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        err = d.max().item()
        worst = max(worst, err)
        if dtype == torch.float32:
            bad = int((d > FLASH_F32_TOL).sum())
            tol = f"tolerance {FLASH_F32_TOL}"
        else:
            bad = int((d > 2.0**-7 * want.float().abs() + 1e-6).sum())
            tol = "tolerance one bf16 ulp of |o|"
        print(f"flash_attention {label}: B {B} H {H}/{Hkv} Sq {Sq} Sk {Sk} D "
              f"{D} {str(dtype)[6:]} causal {causal} window {window}: max "
              f"|o - plain| = {err:.3g}, {bad} elements beyond the {tol}")
        if bad or got.stride() != q.stride():
            raise AssertionError(f"flash attention {label} disagrees with "
                                 "its plain version")
        del q, k, v, got, want, d
    _, B, H, Hkv, Sq, Sk, D, dtype, causal, window = FLASH_CASES[0]
    q, k, v = flash_inputs(B, H, Hkv, Sq, Sk, D, dtype)
    check_flash_large_scores(flash_attn, ref, q * 8, k, v)
    check_p_split(ref, q, k, v)
    torch.cuda.empty_cache()
    ms = event_ms(lambda: flash_attn.flash_attention(q, k, v), 10)
    plain_ms = event_ms(lambda: ref.flash_attention_ref(q, k, v), 3)
    try:        # a yardstick only: the port never calls SDPA
        library_ms = device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
    except RuntimeError as e:
        print(f"scaled_dot_product_attention refused (a): {e}")
        library_ms = None
    c = flash_cost(q, k, causal, window)
    ops, by_bytes = c.flops, c.bytes / HBM_BYTES_PER_S * 1e3
    by_tc = ops / BF16_OPS_PER_S * 1e3
    bound = c.bound_s * 1e3
    ratio = f"{ms / library_ms:.2f}x SDPA" if library_ms else "SDPA refused"
    print(f"flash_attention (a): kernel {ms:.4f} ms "
          f"({ops / ms / 1e9:.1f} TFLOP/s, {ratio}), plain {plain_ms:.4f} "
          f"ms, SDPA {library_ms} ms; bound {bound:.4f} ms by operations "
          f"({ops:.4g} on the bf16 tensor cores; the three-term P.V design's "
          f"tensor work is twice that, a {2 * by_tc:.4f} ms floor; bytes "
          f"{by_bytes:.4f} ms)")
    del q, k, v
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if by_bytes >= by_tc else "operations",
                library_ms=library_ms,
                at_whisper_encoder=flash_case_times(
                    flash_attn, ref, "(l) Whisper encoder, batch 2",
                    device_ms),
                at_whisper_decode_cross=flash_case_times(
                    flash_attn, ref, "(l) Whisper decode cross", graph_ms))


def flash_case_times(flash_attn, ref, label, timer):
    """The kernel, its plain version and SDPA (a yardstick the port never
    calls) at one FLASH_CASES entry, each timed with ``timer``, and the
    entry's bound."""
    _, B, H, Hkv, Sq, Sk, D, dtype, causal, window = next(
        c for c in FLASH_CASES if c[0] == label)
    q, k, v = flash_inputs(B, H, Hkv, Sq, Sk, D, dtype)
    ms = timer(lambda: flash_attn.flash_attention(q, k, v, causal=causal,
                                                  window=window))
    plain_ms = timer(lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                     window=window))
    library_ms = timer(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True))
    c = flash_cost(q, k, causal, window)
    by_bytes = c.bytes / HBM_BYTES_PER_S * 1e3
    by_tc = c.flops / BF16_OPS_PER_S * 1e3
    print(f"flash_attention {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f}"
          f" ms, SDPA {library_ms:.4f} ms, bound {max(by_bytes, by_tc):.4f} "
          f"ms (bytes {by_bytes:.4f}, operations {by_tc:.4f})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(by_bytes, by_tc),
                bound_by="bytes" if by_bytes >= by_tc else "operations",
                library_ms=library_ms)


# the seq plan's flash calls at qwen3-4b's heads: (B, H, Hkv, S, D, ranks)
FLASH_OFFSET = (1, 32, 8, 4096, 128, 4)


def check_flash_offset(flash_attn, ref):
    """The seq attention plan's calls at qwen3-4b's shapes, bf16: the
    sequence split four ways, rank r's 1,024 query rows at ``q_offset =
    r * 1,024`` against keys 0 .. (r + 1) * 1,024 - 1. Each call within
    one bf16 ulp of |o| of its plain version; the four outputs
    concatenated bitwise the whole-sequence call (every offset is a
    multiple of the kernel's 128-row query tile, so each query tile sees
    the same keys in the same order). Times the four calls (CUDA events,
    each over 10 calls) beside the whole call."""
    B, H, Hkv, S, D, tp = FLASH_OFFSET
    q, k, v = flash_inputs(B, H, Hkv, S, S, D, torch.bfloat16, seed=3)
    whole = flash_attn.flash_attention(q, k, v)
    c = S // tp
    calls, parts, worst, bad = [], [], 0.0, 0
    for r in range(tp):
        lo, hi = r * c, (r + 1) * c
        args = (q[:, :, lo:hi], k[:, :, :hi], v[:, :, :hi])
        got = flash_attn.flash_attention(*args, q_offset=lo)
        want = ref.flash_attention_ref(*args, q_offset=lo).float()
        d = (got.float() - want).abs()
        worst = max(worst, d.max().item())
        bad += int((d > 2.0**-7 * want.abs() + 1e-6).sum())
        parts.append(got)
        calls.append((args, lo))
        del want, d
    same = torch.equal(torch.cat(parts, dim=2), whole)
    print(f"flash_attention at q_offset, B {B} H {H}/{Hkv} D {D} S {S} over "
          f"{tp} ranks: max |o - plain| = {worst:.3g}, {bad} elements beyond "
          f"one bf16 ulp of |o|; the chunks concatenated bitwise the whole "
          f"call: {same}")
    if bad or not same:
        raise AssertionError("flash at q_offset disagrees")
    each = [event_ms(lambda a=a, lo=lo: flash_attn.flash_attention(
        *a, q_offset=lo), 10) for a, lo in calls]
    ms_whole = event_ms(lambda: flash_attn.flash_attention(q, k, v), 10)
    bounds = [flash_cost(a[0], a[1], True, 0, lo).bound_s * 1e3
              for a, lo in calls]
    print(f"flash_attention at q_offset: the four calls "
          f"{[round(x, 4) for x in each]} ms (sum {sum(each):.4f}, bounds "
          f"{[round(x, 4) for x in bounds]}), the whole call {ms_whole:.4f} "
          "ms")
    del q, k, v, whole, parts
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, chunks_bitwise=same, ms_by_rank=each,
                ms_sum=sum(each), bound_ms_by_rank=bounds,
                ms_whole=ms_whole)


# (label, B, H, Hkv, Sq, Sk, D, dtype, causal, window) of the log-sum-exp
# check: the serve prefill's seq 4096 (bf16, the tensor cores), Whisper's
# decode cross-attention, one query a row over 1,500 encoder positions
# (the context-parallel combine reads its log-sum-exp), and the f32 kernel
# at the reduced stacks' head dim with rows that see no key
FLASH_LSE_CASES = [
    ("seq 4096", 1, 32, 8, 4096, 4096, 128, torch.bfloat16, True, 0),
    ("Whisper decode cross, Sq 1", 8, 12, 12, 1, 1500, 64, torch.bfloat16,
     False, 0),
    ("f32, D 16, window, rows see no key", 2, 4, 2, 100, 40, 16,
     torch.float32, True, 8),
]
FLASH_LSE_TOL = 1e-4             # |lse - lse_plain| and |lse - float64|, in
#                                  units of max(1, |lse|): the kernel sums
#                                  the same f32 exps in another order


def check_flash_lse(flash_attn, ref):
    """flash's log-sum-exp (``return_lse``) at FLASH_LSE_CASES: the
    output bitwise the output without it; the lse within FLASH_LSE_TOL
    of the plain version's and of the scores' log-sum-exp in float64
    (rows that see no key at -1e30 in both). Times the call with and
    without the lse (CUDA events, 10 calls each)."""
    out = {}
    for label, B, H, Hkv, Sq, Sk, D, dtype, causal, window in \
            FLASH_LSE_CASES:
        q, k, v = flash_inputs(B, H, Hkv, Sq, Sk, D, dtype, seed=7)
        kw = dict(causal=causal, window=window)
        plain_o = flash_attn.flash_attention(q, k, v, **kw)
        o, lse = flash_attn.flash_attention(q, k, v, return_lse=True, **kw)
        same = torch.equal(o, plain_o)
        _, want = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
        G = H // Hkv
        s = torch.einsum("bhqd,bhkd->bhqk", q.double(),
                         k.double().repeat_interleave(G, dim=1)) / D ** 0.5
        qp = torch.arange(Sq, device=q.device)[:, None]
        kp = torch.arange(Sk, device=q.device)[None, :]
        seen = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
        if causal:
            seen &= kp <= qp
        if window:
            seen &= kp > qp - window
        exact = torch.logsumexp(s.masked_fill(~seen, float("-inf")), dim=-1)
        none = ~seen.any(dim=-1)
        exact = torch.where(none[None, None], torch.full_like(exact, -1e30),
                            exact)
        scale = lse.abs().clamp(min=1.0)
        to_plain = float(((lse - want).abs() / scale).max())
        to_exact = float(((lse.double() - exact).abs() / scale).max())
        ms = event_ms(lambda: flash_attn.flash_attention(q, k, v, **kw), 10)
        ms_lse = event_ms(lambda: flash_attn.flash_attention(
            q, k, v, return_lse=True, **kw), 10)
        print(f"flash_attention lse, {label} (B {B} H {H}/{Hkv} Sq {Sq} Sk "
              f"{Sk} D {D} {str(dtype)[6:]}): output bitwise the call "
              f"without it: {same}; lse against the plain version "
              f"{to_plain:.3g}, against float64 {to_exact:.3g} (relative to "
              f"max(1, |lse|); tolerance {FLASH_LSE_TOL}; {int(none.sum())} "
              f"rows see no key); {ms_lse:.4f} ms with it, {ms:.4f} ms "
              "without")
        if not same or max(to_plain, to_exact) > FLASH_LSE_TOL:
            raise AssertionError(f"flash lse, {label}: disagrees")
        out[label] = dict(bitwise=same, max_rel_err_plain=to_plain,
                          max_rel_err_f64=to_exact, ms=ms_lse,
                          ms_without=ms)
        del q, k, v, o, lse, want, s, exact
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- #
# the ZO kernels at the train path's leaves
# --------------------------------------------------------------------- #
def _ordered(t):
    """Float bits as integers ordered like the values (-0 == +0), so a
    difference of two is a distance in units in the last place."""
    if t.dtype == torch.bfloat16:
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    i = t.view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def ulp_diff(got, plain):
    """(elements that differ, largest ulp distance) between a kernel's
    output and ``plain(lo, hi)``, its plain version over the flat range
    [lo, hi), taken ZO_CHUNK elements at a time."""
    flat = got.reshape(-1)
    count = worst = 0
    for lo in range(0, flat.numel(), ZO_CHUNK):
        hi = min(lo + ZO_CHUNK, flat.numel())
        d = (_ordered(flat[lo:hi]) - _ordered(plain(lo, hi))).abs()
        count += int((d != 0).sum())
        worst = max(worst, int(d.max()))
    return count, worst


def zo_records(steps, probes, seed=0):
    """The train step's seeds (u32, as int32 on the card) of ``steps`` x
    ``probes`` probes, and coefficients of the size eta * g / valid."""
    from repro_torch.core import keys, prng, zo
    base = keys.key_data(seed)
    seeds = [prng.seed_from_key(keys.fold_in(keys.fold_in(base, s), i))
             for s in range(steps) for i in range(probes)]
    rng = np.random.default_rng(seed)
    coeffs = (rng.normal(size=(steps, probes)) * 1e-3).astype(np.float32)
    return (zo.device_seeds(seeds, "cuda").reshape(steps, probes),
            torch.from_numpy(coeffs).cuda())


def check_zo_leaf(zo_perturb, zo_replay, ref, path, shape, dtype):
    """Both ZO kernels against their plain versions on one leaf, bitwise:
    perturbation, the update (S = 1, P = 1 and P = 4), a ledger catch-up
    (S = 8, P = 4), and 8 single-step launches against one 8-step
    launch. Returns the leaf, its salt and the records."""
    from repro_torch.core import zo
    gen = torch.Generator(device="cuda").manual_seed(5)
    theta = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    salt = zo.path_salt(path)
    seeds, coeffs = zo_records(8, 4)
    flat = theta.reshape(-1)
    name = f"{zo.keystr(path)} {list(shape)} {str(dtype)[6:]}"
    checks = [("zo_perturb +eps", zo_perturb.zo_perturb(
        theta, seeds[0, :1], salt, 1e-3),
        lambda lo, hi: ref.zo_perturb_ref(flat[lo:hi], seeds[0, :1], salt,
                                          1e-3, lo))]
    for S, P in ((1, 1), (1, 4), (8, 4)):
        sd, cf = seeds[:S, :P], coeffs[:S, :P]
        checks.append((f"zo_fused_replay S={S} P={P}",
                       zo_replay.zo_fused_replay(theta, sd, cf, salt),
                       lambda lo, hi, sd=sd, cf=cf: ref.zo_fused_replay_ref(
                           flat[lo:hi], sd, cf, salt, lo)))
    for what, got, plain in checks:
        count, worst = ulp_diff(got, plain)
        print(f"{what} on {name}: {count} of {theta.numel()} elements "
              f"differ from the plain version, largest distance {worst} ulp")
        if count:
            raise AssertionError(f"{what} is not bitwise its plain version")
    live = theta.clone()
    for s in range(8):
        zo_replay.zo_fused_replay(live, seeds[s:s + 1], coeffs[s:s + 1],
                                  salt, out=live)
    if not torch.equal(live, checks[-1][1]):
        raise AssertionError(f"8 live steps != one 8-step replay on {name}")
    print(f"live == replay on {name}: 8 single-step in-place launches equal "
          "one 8-step launch bitwise")
    return theta, salt, seeds, coeffs


def noise_paths(name, kernel, per_iteration, record_op="MUFU", per_record=1,
                lib=None):
    """(instructions, INT32-pipe instructions) an element of the 16-byte
    grid-stride loop of ``kernel`` (one iteration handles
    ``per_iteration`` elements), and an element of one noise record where
    the loop holds a record loop (the first innermost loop that holds a
    ``record_op`` instruction, or any for None; its body applies
    ``per_record`` element-records), else None: issued along the loop's
    fast path (sass_fast_path). ``lib``: another build of csrc/<name>.cu."""
    code = sass_code(name, kernel, lib)
    loops = [(tg, a) for a, t in code if (tg := _bra_target(t)) is not None
             and tg < a]

    def body(lo, hi):
        return [t for a, t in code if lo <= a <= hi]
    main = next((lo, hi) for lo, hi in loops
                if any("LDG.E.128" in t for t in body(lo, hi))
                and any("STG.E.128" in t for t in body(lo, hi)))
    records = [(lo, hi) for lo, hi in loops if main[0] < lo and hi < main[1]
               and (record_op is None
                    or any(_opcode(t) == record_op for t in body(lo, hi)))]
    inner = [r for r in records
             if not any(r[0] < o[0] and o[1] < r[1] for o in records)]
    record = inner[0] if inner else None

    def mix(lo, hi, per):
        ops = sass_fast_path(code, lo, hi)
        return len(ops) / per, sum(op in ALU_OPS for op in ops) / per
    return mix(*main, per_iteration), \
        mix(*record, per_record) if record else None


def check_zo(zo_perturb, zo_replay, ref):
    """The kernels on a LeNet-5 leaf (f32), an odd-sized one and the
    largest qwen3-4b ZO leaf (bf16), then timed on the last."""
    check_zo_leaf(zo_perturb, zo_replay, ref, ("fc1", "w"), (784, 120),
                  torch.float32)
    check_zo_leaf(zo_perturb, zo_replay, ref, ("conv2", "b"), (16 + 3,),
                  torch.float32)
    theta, salt, seeds, coeffs = check_zo_leaf(
        zo_perturb, zo_replay, ref, ("periods_zo", "blk0", "mlp", "w_gate"),
        (35, 2560, 9728), torch.bfloat16)
    flat, n = theta.reshape(-1), theta.numel()
    seed, sd, cf = seeds[0, :1], seeds[:1, :1], coeffs[:1, :1]
    p, size = 17, theta[0].numel()
    got = zo_perturb.zo_perturb(theta[p], seed, salt, 1e-3, p * size)
    same = (torch.equal(got, ref.zo_perturb_ref(theta[p], seed, salt, 1e-3,
                                                 p * size)),
            torch.equal(got, zo_perturb.zo_perturb(theta, seed, salt,
                                                   1e-3)[p]))
    print(f"zo_perturb at offset {p} x {size} (period {p}'s slice of the "
          f"stacked w_gate): bitwise its plain version {same[0]}, bitwise "
          f"the whole leaf's slice {same[1]}")
    if not all(same):
        raise AssertionError("zo_perturb with an offset differs")
    del got

    def chunked(fn):
        def call():
            for lo in range(0, n, ZO_CHUNK):
                fn(lo, min(lo + ZO_CHUNK, n))
        return call

    # the bound: bytes, or the instructions the build issues an element
    # (kernels/cost.py, its constants held to this build's SASS)
    from repro_torch.kernels import cost
    hz = max_sm_hz()
    sass = check_noise_sass()
    bf16 = torch.bfloat16
    mix = {k: sass[(k, bf16)][0] for k in ("zo_perturb", "zo_fused_replay")}
    record = sass[("zo_fused_replay", bf16)][1]

    def bound_of(c):
        return c.bound_s * 1e3, c.bound_by
    out = {}
    ms = event_ms(lambda: zo_perturb.zo_perturb(theta, seed, salt, 1e-3), 10)
    plain_ms = event_ms(chunked(lambda lo, hi: ref.zo_perturb_ref(
        flat[lo:hi], seed, salt, 1e-3, lo)), 2)
    bound, by = bound_of(cost.zo_perturb(n, bf16, hz))
    out["zo_perturb"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, library_ms=None)
    ms = event_ms(lambda: zo_replay.zo_fused_replay(theta, sd, cf, salt), 10)
    plain_ms = event_ms(chunked(lambda lo, hi: ref.zo_fused_replay_ref(
        flat[lo:hi], sd, cf, salt, lo)), 2)
    bound, by = bound_of(cost.zo_fused_replay(n, bf16, 1, hz))
    out["zo_fused_replay"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound, bound_by=by,
                                  library_ms=None)
    catch_up_ms = event_ms(lambda: zo_replay.zo_fused_replay(
        theta, seeds, coeffs, salt), 3)
    catch_up_bound, catch_up_by = bound_of(
        cost.zo_fused_replay(n, bf16, seeds.numel(), hz))
    print(f"operation bound at the card's highest SM clock {hz / 1e6:.0f} "
          f"MHz: instructions an element on the fast path of the bf16 "
          "16-byte loop (total, INT32 pipe): " + ", ".join(
              f"{k} {t:.2f}, {a:.2f}" for k, (t, a) in mix.items()) +
          f"; one replay record {record[0]:.0f}, {record[1]:.0f}")
    for name, r in out.items():
        print(f"{name} on the {n}-element bf16 leaf: kernel {r['ms']:.4f} "
              f"ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
              f"ms by {r['bound_by']} ({2 * n * 2} bytes); kernel at "
              f"{100 * r['bound_ms'] / r['ms']:.0f}% of its bound")
    print(f"zo_fused_replay S=8 P=4 (ledger catch-up) on the same leaf: "
          f"kernel {catch_up_ms:.4f} ms, bound {catch_up_bound:.4f} ms by "
          f"{catch_up_by} (32 records)")
    return out


# a rank's shard of a sharded leaf: (global shape, dtype, spec, mesh
# sizes, the rank's coordinates); together they cover one-, two- and
# three-level index maps, runs whose length the 16-byte vector does and
# does not divide, and an innermost stride above 1
ZO_MAP_CASES = [
    ((6, 40, 24), torch.float32, (None, "data", "model"),
     {"data": 2, "model": 2}, {"data": 1, "model": 1}),
    ((6, 40, 24), torch.bfloat16, (None, "data", "model"),
     {"data": 2, "model": 2}, {"data": 1, "model": 0}),
    ((64, 48), torch.bfloat16, ("model", "data"),
     {"data": 2, "model": 2}, {"data": 1, "model": 1}),
    ((64, 48), torch.float32, (None, "model"),
     {"data": 1, "model": 4}, {"data": 0, "model": 3}),
    ((4, 8, 2), torch.float32, (None, None, "model"),
     {"data": 1, "model": 2}, {"data": 0, "model": 1}),
    ((8, 64), torch.bfloat16, ("data", None),
     {"data": 4, "model": 1}, {"data": 2, "model": 0}),
]
# w_gate of qwen3-4b's 35 ZO periods, 2-D sharded at 2x2 (rank (1, 1))
ZO_MAP_LARGE = ((35, 2560, 9728), (None, "data", "model"),
                {"data": 2, "model": 2}, {"data": 1, "model": 1})


def check_zo_maps(zo_perturb, zo_replay, ref):
    """The shard forms of both fp32 ZO kernels (an index map of up to
    three levels, sharding/params.py::shard_desc) bitwise their plain
    versions on ZO_MAP_CASES (perturb; replay at S = 1, P = 1 and S = 8,
    P = 4), and on a 2-D shard of qwen3-4b's w_gate bitwise the
    contiguous kernels' output on the whole leaf sliced and bitwise the
    plain versions at the shard's index map (S = P = 1); then that shard
    timed against the contiguous kernels on a leaf of as many elements.
    Returns {kernel: {"shard_ms", "contiguous_ms", "elements",
    "levels"}}."""
    from repro_torch.core import zo
    from repro_torch.sharding.params import shard_desc
    seeds, coeffs = zo_records(8, 4)
    gen = torch.Generator(device="cuda").manual_seed(7)
    salt = zo.path_salt(("periods_zo", "blk0", "mlp", "w_gate"))
    for shape, dtype, spec, sizes, coords in ZO_MAP_CASES:
        d = shard_desc(shape, spec, coords, sizes)
        theta = torch.randn(d.local_shape, generator=gen, device="cuda",
                            dtype=dtype)
        name = (f"{list(shape)} {str(dtype)[6:]} spec {spec} rank {coords}: "
                f"{d.index}")
        got = zo_perturb.zo_perturb(theta, seeds[0, :1], salt, 1e-3,
                                    index=d.index)
        want = ref.zo_perturb_ref(theta, seeds[0, :1], salt, 1e-3,
                                  index=d.index)
        ok = [torch.equal(got, want)]
        for S, P in ((1, 1), (8, 4)):
            ok.append(torch.equal(
                zo_replay.zo_fused_replay(theta, seeds[:S, :P],
                                          coeffs[:S, :P], salt,
                                          index=d.index),
                ref.zo_fused_replay_ref(theta, seeds[:S, :P],
                                        coeffs[:S, :P], salt,
                                        index=d.index)))
        print(f"shard form on {name}: perturb, replay S=1 P=1, S=8 P=4 "
              f"bitwise their plain versions: {ok}")
        if not all(ok):
            raise AssertionError(f"a ZO kernel's shard form differs on {name}")
    # a shard whose global indices pass 2**32 (a stacked expert leaf of a
    # full-depth MoE stack on the production mesh): each drawn mod 2**32
    from repro_torch.core.prng import IndexMap
    for dtype in (torch.float32, torch.bfloat16):
        past = IndexMap(2**32 - 1000, ((3, 58720256), (16, 896), (64, 1)))
        theta = torch.randn(3, 16, 64, generator=gen, device="cuda",
                            dtype=dtype)
        ok = [torch.equal(zo_perturb.zo_perturb(theta, seeds[0, :1], salt,
                                                1e-3, index=past),
                          ref.zo_perturb_ref(theta, seeds[0, :1], salt, 1e-3,
                                             index=past)),
              torch.equal(zo_replay.zo_fused_replay(theta, seeds, coeffs,
                                                    salt, index=past),
                          ref.zo_fused_replay_ref(theta, seeds, coeffs, salt,
                                                  index=past))]
        print(f"shard form past 2**32 ({past}, {str(dtype)[6:]}): perturb, "
              f"replay S=8 P=4 bitwise their plain versions (indices mod "
              f"2**32): {ok}")
        if not all(ok):
            raise AssertionError("a ZO kernel's shard form differs past "
                                 "2**32")
    shape, spec, sizes, coords = ZO_MAP_LARGE
    d = shard_desc(shape, spec, coords, sizes)
    whole = torch.empty(shape, device="cuda", dtype=torch.bfloat16)
    for part in whole:
        part.normal_(generator=gen)
    shard = whole[d.slices].contiguous()
    seed, sd, cf = seeds[0, :1], seeds[:1, :1], coeffs[:1, :1]
    got_p = zo_perturb.zo_perturb(shard, seed, salt, 1e-3, index=d.index)
    got_r = zo_replay.zo_fused_replay(shard, sd, cf, salt, index=d.index)
    same = (torch.equal(got_p, zo_perturb.zo_perturb(whole, seed, salt,
                                                     1e-3)[d.slices]),
            torch.equal(got_r, zo_replay.zo_fused_replay(whole, sd, cf,
                                                         salt)[d.slices]))
    del whole
    plain = (torch.equal(got_p, ref.zo_perturb_ref(shard, seed, salt, 1e-3,
                                                   index=d.index)),
             torch.equal(got_r, ref.zo_fused_replay_ref(shard, sd, cf, salt,
                                                        index=d.index)))
    del got_p, got_r
    torch.cuda.empty_cache()
    print(f"shard {list(d.local_shape)} of {list(shape)} at 2x2 ({d.index}):"
          f" perturb and replay bitwise the whole leaf's kernel output "
          f"sliced: {same}; bitwise their plain versions at the shard's "
          f"index map: {plain}")
    if not all(same):
        raise AssertionError("a shard's noise is not the whole leaf's")
    if not all(plain):
        raise AssertionError("a shard form differs from its plain version "
                             "on the 2x2 shard")
    flat = shard.reshape(-1)               # the same count, one run
    n = shard.numel()
    out = {"zo_perturb": dict(
        shard_ms=event_ms(lambda: zo_perturb.zo_perturb(
            shard, seed, salt, 1e-3, index=d.index), 10),
        contiguous_ms=event_ms(lambda: zo_perturb.zo_perturb(
            flat, seed, salt, 1e-3), 10))}
    out["zo_fused_replay"] = dict(
        shard_ms=event_ms(lambda: zo_replay.zo_fused_replay(
            shard, sd, cf, salt, index=d.index), 10),
        contiguous_ms=event_ms(lambda: zo_replay.zo_fused_replay(
            flat, sd, cf, salt), 10))
    for name, r in out.items():
        r.update(elements=n, levels=len(d.index.levels))
        print(f"{name} on the {n}-element shard: shard form "
              f"{r['shard_ms']:.4f} ms, contiguous form on as many elements "
              f"{r['contiguous_ms']:.4f} ms "
              f"({100 * (r['shard_ms'] / r['contiguous_ms'] - 1):+.1f}%)")
    return out


def check_zo_large(zo_perturb, zo_replay, ref):
    """Both ZO kernels on a bf16 leaf of ZO_LARGE, the flat indices up to
    its 3.29e9 elements, bitwise their plain versions over every element:
    zo_perturb whole and at the offset of each period's slice, and the
    update (zo_fused_replay, S = 1, P = 1). Returns the end of the flat
    index range held (check_index_held)."""
    from repro_torch.core import zo
    path = ("periods_zo", "blk0", "moe", "w_gate")
    theta = torch.empty(ZO_LARGE, device="cuda", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(6)
    for part in theta:
        part.normal_(generator=gen)
    salt = zo.path_salt(path)
    seeds, coeffs = zo_records(1, 1)
    flat, n = theta.reshape(-1), theta.numel()
    name = f"{zo.keystr(path)} {list(ZO_LARGE)} bfloat16"
    got = zo_perturb.zo_perturb(theta, seeds[0], salt, 1e-3)
    count, worst = ulp_diff(got, lambda lo, hi: ref.zo_perturb_ref(
        flat[lo:hi], seeds[0], salt, 1e-3, lo))
    size = theta[0].numel()
    slices = all(torch.equal(zo_perturb.zo_perturb(theta[p], seeds[0], salt,
                                                   1e-3, p * size), got[p])
                 for p in range(ZO_LARGE[0]))
    del got
    print(f"zo_perturb on {name} (flat indices to {n - 1}, past 2**31 = "
          f"{2**31}): {count} of {n} elements differ from the plain "
          f"version, largest distance {worst} ulp; each period's slice at "
          f"offset p x {size} bitwise the whole leaf's: {slices}")
    if count or not slices:
        raise AssertionError("zo_perturb past 2**31 flat indices is not "
                             "bitwise its plain version")
    got = zo_replay.zo_fused_replay(theta, seeds, coeffs, salt)
    count, worst = ulp_diff(got, lambda lo, hi: ref.zo_fused_replay_ref(
        flat[lo:hi], seeds, coeffs, salt, lo))
    print(f"zo_fused_replay S=1 P=1 on {name}: {count} of {n} elements "
          f"differ from the plain version, largest distance {worst} ulp")
    if count:
        raise AssertionError("zo_fused_replay past 2**31 flat indices is not "
                             "bitwise its plain version")
    return n


# --------------------------------------------------------------------- #
# the int8 lane's kernels
# --------------------------------------------------------------------- #
def nvidia_smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def max_sm_hz():
    """The card's highest SM clock (nvidia-smi), which gives the INT32
    pipe's highest rate and so the least time."""
    return float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6


def int8_records(steps, probes, seed=1):
    """Probe seeds of ``steps`` x ``probes`` train-step probes and
    ternary g with one 0 (a masked probe), both int32 on the card."""
    seeds, _ = zo_records(steps, probes, seed)
    rng = np.random.default_rng(seed)
    gs = rng.choice(np.array([-1, 1], np.int32), size=(steps, probes))
    gs[steps // 2, probes // 2] = 0
    return seeds, torch.from_numpy(gs).cuda()


def int_diff(got, plain):
    """(elements that differ, largest |difference|) between an int8
    kernel output and ``plain(lo, hi)``, ZO_CHUNK elements at a time."""
    flat = got.reshape(-1)
    count = worst = 0
    for lo in range(0, flat.numel(), ZO_CHUNK):
        hi = min(lo + ZO_CHUNK, flat.numel())
        d = (flat[lo:hi].to(torch.int32) - plain(lo, hi).to(torch.int32)).abs()
        count += int((d != 0).sum())
        worst = max(worst, int(d.max()))
    return count, worst


def check_int8_leaf(zo_perturb, zo_replay, ref, path, shape):
    """int8_perturb (k = +-1) and zo_fused_replay_int8 (S = 1, P = 1 in
    place; S = 8, P = 4 with one g = 0) against their plain versions on
    one int8 leaf, bitwise, and 8 single in-place steps against one
    8-step launch. Returns the leaf, its salt, the records and the
    largest difference seen."""
    from repro_torch.core import zo
    gen = torch.Generator(device="cuda").manual_seed(6)
    theta = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int8)
    salt = zo.path_salt(path)
    seeds, gs = int8_records(8, 4)
    flat = theta.reshape(-1)
    name = f"{zo.keystr(path)} {list(shape)} int8"
    args = (3, 0.33)
    checks = [(f"int8_perturb k={k:+d}", zo_perturb.int8_perturb(
        theta, seeds[0, :1], salt, k, *args),
        lambda lo, hi, k=k: ref.int8_perturb_ref(flat[lo:hi], seeds[0, :1],
                                                 salt, k, *args, lo))
        for k in (1, -1)]
    live1 = theta.clone()
    zo_replay.zo_fused_replay_int8(live1, seeds[:1, :1], gs[:1, :1], salt,
                                   *args, 1, out=live1)
    checks.append(("zo_fused_replay_int8 S=1 P=1 in place", live1,
                   lambda lo, hi: ref.zo_fused_replay_int8_ref(
                       flat[lo:hi], seeds[:1, :1], gs[:1, :1], salt, *args,
                       1, lo)))
    checks.append(("zo_fused_replay_int8 S=8 P=4",
                   zo_replay.zo_fused_replay_int8(theta, seeds, gs, salt,
                                                  *args, 1),
                   lambda lo, hi: ref.zo_fused_replay_int8_ref(
                       flat[lo:hi], seeds, gs, salt, *args, 1, lo)))
    worst_all = 0
    for what, got, plain in checks:
        count, worst = int_diff(got, plain)
        worst_all = max(worst_all, worst)
        print(f"{what} on {name}: {count} of {theta.numel()} elements "
              f"differ from the plain version (largest |difference| {worst})")
        if count:
            raise AssertionError(f"{what} is not bitwise its plain version")
    del live1
    live = theta.clone()
    for s in range(8):
        zo_replay.zo_fused_replay_int8(live, seeds[s:s + 1], gs[s:s + 1],
                                       salt, *args, 1, out=live)
    if not torch.equal(live, checks[-1][1]):
        raise AssertionError(f"8 live steps != one 8-step replay on {name}")
    print(f"live == replay on {name}: 8 single-step in-place launches equal "
          "one 8-step launch bitwise")
    return theta, salt, seeds, gs, worst_all


def _opcode(text):
    import re
    return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0]


def _bra_target(text):
    import re
    m = re.search(r"\bBRA (?:\w+, )?(0x[0-9a-f]+)", text)
    return int(m.group(1), 16) if m else None


@functools.lru_cache(maxsize=None)
def sass_functions(name, lib=None):
    """{mangled kernel name: SASS text} of the built library of
    csrc/<name>.cu (or of the library ``lib``), from cuobjdump -sass."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    lib = lib or _build._target(_build.CSRC / f"{name}.cu")
    sass = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return {f.split()[0]: f for f in sass.split("Function : ")[1:]}


def sass_code(name, kernel, lib=None):
    """[(address, instruction)] of ``kernel`` (a substring of its mangled
    name) in the built library of csrc/<name>.cu (or ``lib``)."""
    import re
    body = next(f for fn, f in sass_functions(name, lib).items()
                if kernel in fn)
    return [(int(a, 16), t.strip()) for a, t in
            re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]


def sass_fast_path(code, lo, hi):
    """The opcodes issued by one pass from ``lo`` to the loop's backward
    branch at ``hi`` along the fast path: straight on, into every inner
    loop once, over a forward branch when it is unconditional or when the
    code it skips is a slow path (a call or a table load, and no MUFU: the
    precise cosf's Payne-Hanek reduction, which the Box-Muller angle in
    [0, 2 pi) never takes, and the sqrt's special cases). Predicated
    instructions count: they issue."""
    addrs = [a for a, _ in code]
    text = dict(code)
    i, ops = addrs.index(lo), []
    while i < len(addrs) and addrs[i] <= hi:
        a = addrs[i]
        ops.append(_opcode(text[a]))
        tg = _bra_target(text[a])
        if tg is not None and tg > a:
            skipped = [t for b, t in code if a < b < tg]
            if not text[a].startswith("@") or (
                    any(_opcode(t) == "CALL" or "CONSTANT" in t
                        for t in skipped)
                    and not any(_opcode(t) == "MUFU" for t in skipped)):
                i = addrs.index(tg)
                continue
        i += 1
    return ops


def sass_counts(name, ops):
    """{kernel: {op: count}} of the SASS instructions or registers ``ops``
    in each kernel of the built library of csrc/<name>.cu."""
    import re
    counts = {}
    for fn, body in sass_functions(name).items():
        found = re.findall(r"\b(" + "|".join(ops) + r")\b", body)
        counts[fn] = {op: found.count(op) for op in ops}
    return counts


def check_cluster_sass():
    """The two cluster kernels must combine through distributed shared
    memory: every SASS function of their builds reads the shared-memory
    window register SR_SWINHI (ptxas lowers mapa.shared::cluster to a
    PRMT of the CTA rank into that window and ld.shared::cluster to a
    generic LD on it; sm_90's SASS has no MAPA for it) and arrives on the
    cluster barrier (UCGABAR_ARV); the bf16 paged kernels score on the
    tensor cores (HMMA)."""
    for name in ("paged_attn", "topk_mask"):
        counts = sass_counts(name, ("SR_SWINHI", "UCGABAR_ARV", "HMMA"))
        bf16 = [c for fn, c in counts.items() if "bfloat16" in fn]
        print(f"  {name}: {len(counts)} kernels; SR_SWINHI reads "
              f"{sorted({c['SR_SWINHI'] for c in counts.values()})}, "
              f"UCGABAR_ARV {sorted({c['UCGABAR_ARV'] for c in counts.values()})}"
              f", HMMA in the {len(bf16)} bf16 ones "
              f"{sorted({c['HMMA'] for c in bf16})}")
        if not counts or not all(c["SR_SWINHI"] and c["UCGABAR_ARV"]
                                 for c in counts.values()):
            raise AssertionError(f"a kernel of {name} reads no distributed "
                                 "shared memory")
        if name == "paged_attn" and not (bf16 and all(c["HMMA"]
                                                       for c in bf16)):
            raise AssertionError("a bf16 paged kernel holds no HMMA")


def check_tensor_core_sass():
    """The bf16 flash kernels and the int8 GEMM must reach the tensor
    cores: each of their SASS functions holds MMA instructions."""
    for name, kernel, ops in (("flash_attn", "flash_tc", ("HGMMA", "HMMA")),
                              ("int8_matmul", "int8_mma", ("IMMA",))):
        found = 0
        for fn, c in sass_counts(name, ("HGMMA", "HMMA", "IMMA")).items():
            print(f"  {name} SASS {fn}: " +
                  ", ".join(f"{op} {n}" for op, n in c.items()))
            if kernel in fn:
                found += 1
                if not sum(c[op] for op in ops):
                    raise AssertionError(f"{fn} in {name} holds no "
                                         f"{'/'.join(ops)}")
        if not found:
            raise AssertionError(f"no {kernel} kernel in {name}'s SASS")


def noise_bound_ms(n, itemsize, per_element, hz):
    """(bound ms, what bounds it) of one pass over an n-element leaf
    whose every element costs ``per_element`` = (instructions, INT32-pipe
    instructions): the larger of the bytes (a read and a write), the
    INT32 pipe and the dispatch rate (one warp instruction a clock per
    scheduler), at SM clock ``hz`` (``kernels/cost.py::noise_seconds``)."""
    from repro_torch.kernels import cost
    by_bytes = 2 * n * itemsize / HBM_BYTES_PER_S
    by_ops = cost.noise_seconds(n, per_element, hz)
    return max(by_bytes, by_ops) * 1e3, \
        "bytes" if by_bytes >= by_ops else "operations"


def check_noise_sass():
    """The instructions an element of every noise-kernel build the
    dispatch takes (bf16 and f32, the offset form and the unit-stride
    shard form; noise_paths on the build this run made), and of one more
    replay record, against ``kernels/cost.py``'s constants, which the
    dry run and the bounds of the kernels line read: raises where one
    went stale. Returns {(form, dtype): (an element, a record or None)}."""
    from repro_torch.kernels import cost
    got, stale = {}, []
    for (form, dtype), (symbol, per) in cost.NOISE_SYMBOLS.items():
        name = "zo_perturb" if form.startswith("zo_perturb") \
            else "zo_fused_replay"
        element, record = noise_paths(name, symbol, per)
        got[(form, dtype)] = element, record
        want = cost.NOISE_SASS[(form, dtype)]
        want_rec = cost.REPLAY_RECORD_SASS.get((form, dtype))
        print(f"  {form} {str(dtype)[6:]} ({symbol}): {element[0]:.4f}, "
              f"{element[1]:.4f} instructions an element (total, INT32 "
              f"pipe), kernels/cost.py {want[0]:.4f}, {want[1]:.4f}" + (
                  f"; a record {record[0]:.0f}, {record[1]:.0f}, kernels/"
                  f"cost.py {want_rec[0]:.0f}, {want_rec[1]:.0f}"
                  if want_rec else ""))
        if element != want or (want_rec is not None and record != want_rec):
            stale.append(f"{form} {dtype}")
    if stale:
        raise AssertionError(f"kernels/cost.py's SASS counts are stale for "
                             f"{stale}: the build issues others")
    return got


# the int8 noise kernels' 16-byte paths: (symbol substring, elements a
# tile, elements a record-loop iteration); the replay's with psr's
# 0 < s < 32 form, the one the lanes run (shift 1)
INT8_SASS = {"int8_perturb": ("int8_perturb_kernelILi16", 16, None),
             "zo_fused_replay_int8": ("replay_int8_kernelILi16ELi1E", 16, 16)}


def int8_sass():
    """{kernel: (an element at S = P = 1, an element of one more record or
    None)}, each (instructions, INT32-pipe instructions), of the int8
    noise kernels' fast paths (noise_paths on each kernel's own symbol)."""
    out = {}
    for name, (symbol, per_tile, per_record) in INT8_SASS.items():
        out[name] = noise_paths(name, symbol, per_tile, record_op=None,
                                per_record=per_record or 1)
        if per_record is None:
            out[name] = out[name][0], None
        elif out[name][0][0] < out[name][1][0]:
            raise AssertionError(f"{name}: the S = P = 1 fast path ({out[name]}"
                                 ") is cheaper than one record: the walk "
                                 "missed the record loop")
    return out


def check_int8_model(zo_perturb, zo_replay, ref, lenet, seeds, gs,
                     copies=1):
    """One launch over all of LeNet-5's int8 leaves for each int8 noise
    call against the plain version leaf by leaf, bitwise: the perturbation
    (k = +-1), the update S = 1 P = 1 in place and the catch-up S = 8 x
    P = 4 (one g = 0), each a single launch whatever the leaf count. With
    ``copies`` the table holds the leaves that many times, each copy with
    salts of its own (10 copies take the kernels' 16 elements a thread)."""
    leaves = [leaf for leaf, _ in lenet.values()] * copies
    salts = [(salt + 7919 * c) % 2**30 for c in range(copies)
             for _, salt in lenet.values()]
    args = (3, 0.33)
    checks = []
    for k in (1, -1):
        n0 = zo_perturb.int8_launches
        got = zo_perturb.int8_perturb_leaves(leaves, seeds[0, :1], salts, k,
                                             *args)
        checks.append((f"int8_perturb k={k:+d}", zo_perturb.int8_launches - n0,
                       got, [ref.int8_perturb_ref(t, seeds[0, :1], salt, k,
                                                  *args)
                             for t, salt in zip(leaves, salts)]))
    live = [t.clone() for t in leaves]
    for S, P, outs in ((1, 1, live), (8, 4, None)):
        n0 = zo_replay.int8_launches
        got = zo_replay.zo_fused_replay_int8_leaves(
            live if outs else leaves, seeds[:S, :P], gs[:S, :P], salts, *args,
            1, outs=outs)
        checks.append((f"zo_fused_replay_int8 S={S} P={P}"
                       + (" in place" if outs else ""),
                       zo_replay.int8_launches - n0, got,
                       [ref.zo_fused_replay_int8_ref(t, seeds[:S, :P],
                                                     gs[:S, :P], salt, *args,
                                                     1)
                        for t, salt in zip(leaves, salts)]))
    for what, launches, got, want in checks:
        differ = sum(int((a != b).sum()) for a, b in zip(got, want))
        print(f"{what}, one launch for {copies} x LeNet-5's int8 leaves "
              f"({sum(t.numel() for t in leaves)} elements): {launches} "
              f"launch(es), {differ} elements differ from the plain version "
              "leaf by leaf")
        if launches != 1 or differ:
            raise AssertionError(f"{what}: the whole-model launch is not one "
                                 "launch bitwise the plain version")


def check_int8_noise(zo_perturb, zo_replay, ref):
    """The int8 noise kernels on every int8 leaf of LeNet-5 (conv1's 150
    and fc3's 840 elements run the kernels' ragged tail), one leaf a launch
    and all five in one launch, and on an int8 leaf of qwen3-4b's w_gate
    size; then timed on the latter and on LeNet-5, where one whole-model
    launch stands beside the per-leaf launches it replaces."""
    from repro_torch.models.lenet import init_lenet5_int8
    w1, lenet = 0, {}
    for layer, q in init_lenet5_int8(0, device="cuda").items():
        leaf, leaf_salt, _, _, w = check_int8_leaf(
            zo_perturb, zo_replay, ref, (layer, "w"), tuple(q["w"].data.shape))
        w1 = max(w1, w)
        lenet[layer] = leaf, leaf_salt
    theta, salt, seeds, gs, w2 = check_int8_leaf(
        zo_perturb, zo_replay, ref, ("periods_zo", "blk0", "mlp", "w_gate"),
        INT8_LEAF)
    for copies in (1, 10):
        check_int8_model(zo_perturb, zo_replay, ref, lenet, seeds, gs, copies)
    flat, n = theta.reshape(-1), theta.numel()
    seed, sd, g1 = seeds[0, :1], seeds[:1, :1], gs[:1, :1]
    args = (3, 0.33)

    def chunked(fn):
        def call():
            for lo in range(0, n, ZO_CHUNK):
                fn(lo, min(lo + ZO_CHUNK, n))
        return call

    hz = max_sm_hz()
    sass = int8_sass()
    per_element = {name: c[0] for name, c in sass.items()}
    record = sass["zo_fused_replay_int8"][1]
    for name, (el, rec) in sass.items():
        print(f"{name} SASS fast path (16-byte tile, {INT8_SASS[name][0]}): "
              f"{el[0]:.2f} instructions an element, {el[1]:.2f} of them on "
              "the INT32 pipe" + (f"; one more record {rec[0]:.2f} and "
                                  f"{rec[1]:.2f} an element" if rec else ""))
    out = {}
    ms = event_ms(lambda: zo_perturb.int8_perturb(theta, seed, salt, 1,
                                                   *args), 10)
    plain_ms = event_ms(chunked(lambda lo, hi: ref.int8_perturb_ref(
        flat[lo:hi], seed, salt, 1, *args, lo)), 2)
    bound, by = noise_bound_ms(n, 1, per_element["int8_perturb"], hz)
    out["int8_perturb"] = dict(max_abs_err=float(max(w1, w2)), ms=ms,
                               plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                               library_ms=None)
    ms = event_ms(lambda: zo_replay.zo_fused_replay_int8(
        theta, sd, g1, salt, *args, 1), 10)
    plain_ms = event_ms(chunked(lambda lo, hi: ref.zo_fused_replay_int8_ref(
        flat[lo:hi], sd, g1, salt, *args, 1, lo)), 2)
    bound, by = noise_bound_ms(n, 1, per_element["zo_fused_replay_int8"], hz)
    out["zo_fused_replay_int8"] = dict(
        max_abs_err=float(max(w1, w2)), ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=None)
    live = int(gs.ne(0).sum())
    catch_up_ms = event_ms(lambda: zo_replay.zo_fused_replay_int8(
        theta, seeds, gs, salt, *args, 1), 3)
    catch_up_bound, catch_up_by = noise_bound_ms(
        n, 1, tuple(e + (live - 1) * r for e, r in
                    zip(per_element["zo_fused_replay_int8"], record)), hz)
    print(f"operation bounds at the card's highest SM clock {hz / 1e6:.0f} "
          f"MHz ({nvidia_smi('clocks.sm')} now)")
    for name, r in out.items():
        print(f"{name} on the {n}-element int8 leaf: kernel {r['ms']:.4f} "
              f"ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
              f"ms by {r['bound_by']} ({2 * n} bytes); kernel at "
              f"{100 * r['bound_ms'] / r['ms']:.0f}% of its bound")
    print(f"zo_fused_replay_int8 S=8 P=4 ({live} records with g != 0) on the "
          f"same leaf: kernel {catch_up_ms:.4f} ms, bound "
          f"{catch_up_bound:.4f} ms by {catch_up_by} (the S = P = 1 path and "
          f"{live - 1} more records an element); kernel at "
          f"{100 * catch_up_bound / catch_up_ms:.0f}% of its bound")
    # LeNet-5: each leaf a launch, and all five leaves in one launch
    leaves = [leaf for leaf, _ in lenet.values()]
    salts = [s for _, s in lenet.values()]
    total = sum(t.numel() for t in leaves)
    one = {"int8_perturb": lambda t, s: zo_perturb.int8_perturb(
               t, seed, s, 1, *args),
           "zo_fused_replay_int8": lambda t, s: zo_replay.zo_fused_replay_int8(
               t, sd, g1, s, *args, 1)}
    whole = {"int8_perturb": lambda ts, ss: zo_perturb.int8_perturb_leaves(
                 ts, seed, ss, 1, *args),
             "zo_fused_replay_int8":
                 lambda ts, ss: zo_replay.zo_fused_replay_int8_leaves(
                     ts, sd, g1, ss, *args, 1)}
    for name in one:
        mix = per_element[name]
        for layer, (leaf, leaf_salt) in lenet.items():
            t = tiny_ms(lambda: one[name](leaf, leaf_salt),
                        f"{name} on {layer}")
            b, by_ = noise_bound_ms(leaf.numel(), 1, mix, hz)
            print(f"  {name} (S=1 P=1) on LeNet-5's {layer} "
                  f"({leaf.numel()} elements) alone: {t:.4f} ms a launch, "
                  f"bound {b:.3g} ms by {by_}")
        per_leaf = tiny_ms(lambda: [one[name](t, s)
                                    for t, s in zip(leaves, salts)],
                           f"{name} per leaf")
        once = tiny_ms(lambda: whole[name](leaves, salts),
                       f"{name} whole model")
        b, by_ = noise_bound_ms(total, 1, mix, hz)
        print(f"{name} on LeNet-5's {len(leaves)} int8 leaves ({total} "
              f"elements, 4 a thread): one whole-model launch {once:.4f} ms; "
              f"the {len(leaves)} per-leaf launches it replaces "
              f"{per_leaf:.4f} ms in all; bound {b:.3g} ms by {by_}")
        # the kernels take 16 elements a thread from 264 tiles of 4,096 on:
        # 9 copies of LeNet-5's leaves make 261 (4 a thread), 10 make 290
        at = {c: tiny_ms(lambda: whole[name](leaves * c, salts * c),
                         f"{name} x {c}") for c in (9, 10)}
        print(f"{name} where the elements a thread switch: 9 copies of the "
              f"leaves (4 a thread) {at[9]:.4f} ms, "
              f"{1e6 * at[9] / (9 * total):.4f} ns an element; 10 copies (16 "
              f"a thread) {at[10]:.4f} ms, "
              f"{1e6 * at[10] / (10 * total):.4f} ns an element")
        if not once < per_leaf:
            raise AssertionError(f"{name}: one whole-model launch is not "
                                 "faster than the per-leaf launches")
    return out


# (M, K, N) of the int8 products of one batch-64 step of LeNet-5: the
# forward's conv1, conv2 (im2col), fc1, fc2, fc3, and ZO-Feat-Cls2's tail
# backward (g = a^T e and e_in = e w^T for fc3, then fc2)
MM_FORWARD = [(64 * 784, 25, 6), (64 * 196, 150, 16), (64, 784, 120),
              (64, 120, 84), (64, 84, 10)]
MM_BACKWARD = [(84, 64, 10), (64, 10, 84), (120, 64, 84), (64, 84, 120)]
MM_ODD = [(1, 1, 1), (65, 129, 67), (1000, 33, 7), (3, 0, 5), (127, 4097, 3)]
# the same products at the fleet's batch 8 (each worker's probe forwards),
# and the one-FC tail's backward (g = a^T e, e_in = e w^T for fc3)
MM_FLEET = [(8 * 784, 25, 6), (8 * 196, 150, 16), (8, 784, 120),
            (8, 120, 84), (8, 84, 10), (84, 8, 10), (8, 10, 84)]
# (M, K, N) of PointNet's int8 forward at full width, batch 32 x 1024
# points: the five pointwise layers over B*N rows (the first with K = 3;
# feat1 and feat2 share a shape), then the head's three over B rows
MM_POINTNET = [(32 * 1024, 3, 64), (32 * 1024, 64, 64), (32 * 1024, 64, 128),
               (32 * 1024, 128, 1024), (32, 1024, 512), (32, 512, 256),
               (32, 256, 40)]
MM_MISALIGNED = [(64 * 784, 25, 6, 1), (1000, 4096, 1000, 1)]


def mm_bound_ms(M, K, N):
    by_bytes = (M * K + K * N + 4 * M * N + 4) / HBM_BYTES_PER_S
    by_ops = 2 * M * N * K / INT8_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, \
        "bytes" if by_bytes >= by_ops else "operations"


def check_int8_matmul(int8_mm, ref):
    """int8_matmul against its plain version (float64 on the card), out
    and max|out| bitwise, at 4096^3, at the LeNet-5 step's shapes, at odd
    ones, on views off 16-byte alignment and at K = MAX_K; timed at 4096^3
    (beside torch._int_mm) and at the path's."""
    gen = torch.Generator(device="cuda").manual_seed(7)

    def case(M, K, N):
        a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                          dtype=torch.int8)
        return a, w

    worst = 0
    for M, K, N in [(4096, 4096, 4096)] + MM_FORWARD + MM_BACKWARD + MM_ODD \
            + MM_POINTNET + MM_FLEET:
        a, w = case(M, K, N)
        out, mx = int8_mm.int8_matmul(a, w)
        want, want_mx = ref.int8_matmul_ref(a, w)
        count = int((out != want).sum())
        worst = max(worst, int((out.double() - want.double()).abs().max())
                    if out.numel() else 0)
        if count or int(mx) != int(want_mx):
            raise AssertionError(f"int8_matmul {M}x{K}x{N}: {count} outputs "
                                 f"differ, max {int(mx)} vs {int(want_mx)}")
    # views that start one byte off 16-byte alignment (the byte path), and
    # the deepest K the wrapper takes
    for M, K, N, skip in MM_MISALIGNED + [(5, int8_mm.MAX_K, 7, 0)]:
        raw = torch.randint(-127, 128, (M * K + skip,), generator=gen,
                            device="cuda", dtype=torch.int8)
        a = raw[skip:].view(M, K)
        w = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                          dtype=torch.int8)
        out, mx = int8_mm.int8_matmul(a, w)
        want, want_mx = ref.int8_matmul_ref(a, w)
        count = int((out != want).sum())
        worst = max(worst, int((out.double() - want.double()).abs().max()))
        if count or int(mx) != int(want_mx):
            raise AssertionError(f"int8_matmul {M}x{K}x{N} at byte offset "
                                 f"{skip}: {count} outputs differ, max "
                                 f"{int(mx)} vs {int(want_mx)}")
    print(f"int8_matmul: out and max|out| bitwise the plain version at "
          f"4096^3, the 5 forward and 4 backward shapes of a batch-64 LeNet-5 "
          f"step, the {len(MM_FLEET)} of a batch-8 fleet probe, the "
          f"{len(MM_POINTNET)} shapes of PointNet's int8 forward "
          f"(K = 3 first), {len(MM_ODD)} odd shapes, {len(MM_MISALIGNED)} "
          "views one "
          f"byte off alignment and K = {int8_mm.MAX_K} (MAX_K)")
    a, w = case(4096, 4096, 4096)
    ms = event_ms(lambda: int8_mm.int8_matmul(a, w), 10)
    plain_ms = event_ms(lambda: ref.int8_matmul_ref(a, w), 3)
    try:        # a yardstick only: the port never calls torch._int_mm
        library_ms = event_ms(lambda: torch._int_mm(a, w), 10)
    except RuntimeError as e:
        print(f"torch._int_mm refused 4096^3: {e}")
        library_ms = None
    bound, by = mm_bound_ms(4096, 4096, 4096)
    lib = (f"{library_ms:.4f} ms ({2 * 4096 ** 3 / library_ms / 1e9:.1f} "
           f"TOPS)" if library_ms else "refused")
    print(f"int8_matmul 4096^3: kernel {ms:.4f} ms "
          f"({2 * 4096 ** 3 / ms / 1e9:.1f} TOPS), plain {plain_ms:.4f} ms, "
          f"torch._int_mm {lib}, bound {bound:.4f} ms by {by}")
    path_ms = path_plain = path_bound = 0.0
    # kernel and plain version alike as CUDA graphs of 100 calls: device
    # time without the host's issue time (the profiler drops the plain
    # version's small kernels' records at these shapes)
    for M, K, N in MM_FORWARD + MM_BACKWARD:
        a, w = case(M, K, N)
        t = graph_ms(lambda: int8_mm.int8_matmul(a, w))
        p = graph_ms(lambda: ref.int8_matmul_ref(a, w))
        b, by_ = mm_bound_ms(M, K, N)
        path_ms, path_plain = path_ms + t, path_plain + p
        path_bound += b
        print(f"  int8_matmul {M}x{K}x{N}: kernel {t:.4f} ms, plain {p:.4f} "
              f"ms, bound {b:.5f} ms by {by_}")
    print(f"int8_matmul at the path's 9 shapes (CUDA graphs of 100 calls): "
          f"kernel {path_ms:.4f} ms in all, plain {path_plain:.4f} ms, bound "
          f"{path_bound:.5f} ms")
    # PointNet's 8 forward products (feat1 and feat2 share a shape) timed
    # as one forward's worth, with CUDA events over 20 back-to-back runs:
    # 8 launches a run keep the card busier than the host that issues them
    cases = [case(M, K, N) for M, K, N in MM_POINTNET[:2] + MM_POINTNET[1:]]
    pn_ms = event_ms(lambda: [int8_mm.int8_matmul(a, w) for a, w in cases],
                     20)
    pn_plain = event_ms(lambda: [ref.int8_matmul_ref(a, w)
                                 for a, w in cases], 20)
    pn_bound = sum(mm_bound_ms(*mkn)[0]
                   for mkn in MM_POINTNET[:2] + MM_POINTNET[1:])
    print(f"int8_matmul at PointNet's 8 forward products (32 x 1024 points, "
          f"full width): kernel {pn_ms:.4f} ms in all, plain {pn_plain:.4f} "
          f"ms, bound {pn_bound:.5f} ms (CUDA events over 20 runs)")
    return dict(max_abs_err=float(worst), ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=library_ms)


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #
def requests(cfg, rng, lengths=(128, 256, 384, 512)):
    """8 requests, prompts of the four ``lengths`` (two of each), 32 new
    tokens; even ones greedy, odd ones sampled with distinct seeds."""
    from repro_torch.serve import SamplingParams
    out = []
    for i, n in enumerate(n for n in lengths for _ in range(2)):
        sp = SamplingParams() if i % 2 == 0 else SamplingParams(
            temperature=0.8, top_k=50, top_p=0.95, seed=1000 + i)
        out.append((list(rng.integers(0, cfg.vocab_size, n)), sp))
    return out


def serve(engine, reqs, new_tokens=32):
    rids = [engine.submit(p, sp, new_tokens) for p, sp in reqs]
    out = engine.run()
    return [out[r] for r in rids]


@contextlib.contextmanager
def counting_prefills():
    """Counts the calls of repro_torch.core.api.prefill_logits (the serve
    engine's one prefill a prompt-length group) made inside."""
    from repro_torch.core import api
    calls = []
    prefill = api.prefill_logits

    def counted(*a, **k):
        calls.append(a[2].shape)
        return prefill(*a, **k)
    api.prefill_logits = counted
    try:
        yield calls
    finally:
        api.prefill_logits = prefill


SMALL_ARCHS = ("qwen3-4b", "jamba-v0.1-52b", "rwkv6-1.6b", "mixtral-8x7b")
SERVE_RWKV_LAYERS = 12           # of rwkv6-1.6b's 24, served at full
#                                  width (a depth cut for the run's time
#                                  limit; trained whole): its blocks are
#                                  all of one kind, so the cut drops depth
#                                  and no path
SMALL_LOGIT_TOL = 1e-4           # f32 prefill logits, card against CPU


def attention_blocks(cfg):
    """The attention blocks of a stack: one flash launch a prefill and
    one paged launch a decode tick each."""
    return cfg.num_periods * cfg.pattern.count("attn")


def serve_flash_launches(cfg, prefills, ticks):
    """Flash launches of a serve run: a prefill call's encoder blocks and
    its decoder's self- and cross-attention blocks, and a decode tick's
    cross-attention blocks (Whisper; a tick's self-attention is the paged
    kernel's)."""
    n_attn, cross = attention_blocks(cfg), bool(cfg.encoder_layers)
    return prefills * (cfg.encoder_layers + n_attn * (1 + cross)) \
        + ticks * n_attn * cross


def stub_batch(cfg, rows, device, seed=0):
    """Random frames (Whisper) and image-token embeddings (LLaVA) for a
    prefill or a train batch, in the config's dtype, so that the encoder
    and the image prefix do real work."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    out = {}
    if cfg.encoder_layers:
        out["frames"] = torch.randn(rows, cfg.encoder_seq, cfg.d_model,
                                    generator=g).to(device, dt)
    if cfg.num_image_tokens:
        out["img"] = torch.randn(rows, cfg.num_image_tokens, cfg.d_model,
                                 generator=g).to(device, dt)
    return out


def check_small_model_on_card_vs_cpu(flash_attn, paged_attn,
                                     archs=SMALL_ARCHS):
    """Reduced ``archs`` in f32 (by default qwen3-4b, Jamba (Mamba,
    attention and MoE blocks, one period), RWKV6 and Mixtral (MoE,
    sliding window 16)): the same requests on the card (CUDA kernels; the
    flash kernel at head dim 16) and on the CPU (plain versions) give the
    same streams, and prefill logits (random frames or image embeddings
    where the stack takes them) within SMALL_LOGIT_TOL."""
    from repro_torch import configs
    from repro_torch.core import api
    from repro_torch.models.transformer import tree_map
    from repro_torch.serve import Engine, SamplingParams, ServeConfig
    sc = ServeConfig(page_size=4, num_pages=64, max_batch_slots=4,
                     max_seq_len=48, max_new_tokens=12, megastep=4)
    for arch in archs:
        cfg = configs.reduced(configs.ARCHS[arch], dtype="float32")
        cpu = Engine(cfg, sc, device="cpu", init_seed=3)
        card = Engine(cfg, sc, device="cuda",
                      params=tree_map(lambda a: a.cuda(), cpu.params))
        rng = np.random.default_rng(3)
        # 21 tokens pass the reduced Mixtral's window of 16 at prefill
        reqs = [(list(rng.integers(0, cfg.vocab_size, n)), sp) for n, sp in
                ((5, SamplingParams()),
                 (9, SamplingParams(temperature=0.8, top_k=7, seed=11)),
                 (14, SamplingParams(temperature=1.1, top_p=0.9, seed=23)),
                 (21, SamplingParams(temperature=0.7, top_k=20, top_p=0.8,
                                     seed=5)))]
        a = serve(cpu, reqs, 12)
        flash_attn.launches = paged_attn.launches = 0
        with counting_prefills() as prefills:
            b = serve(card, reqs, 12)
        if a != b:
            raise AssertionError(f"{arch}: card streams {b} != CPU streams "
                                 f"{a}")
        n, n_paged = flash_attn.launches, paged_attn.launches
        n_attn = attention_blocks(cfg)
        toks = torch.tensor([reqs[3][0]])
        last = torch.tensor([cfg.num_image_tokens + len(reqs[3][0]) - 1])
        stubs = stub_batch(cfg, 1, "cpu", seed=3)
        want, _ = api.prefill_logits(cpu.params, cfg, toks, last, **stubs)
        got, _ = api.prefill_logits(card.params, cfg, toks.cuda(),
                                    last.cuda(), **tree_map(
                                        lambda a: a.cuda(), stubs))
        err = (got.cpu() - want).abs().max().item()
        print(f"small {arch}: card == CPU for {len(a)} streams of 12 "
              f"tokens; flash_attention (head dim 16) launched {n} times for "
              f"{len(prefills)} prefills of {n_attn} attention blocks, "
              f"paged_attention_step {n_paged} times in {card.ticks_run} "
              f"ticks; prefill logits max |card - CPU| = {err:.3g} "
              f"(tolerance {SMALL_LOGIT_TOL})")
        if n != serve_flash_launches(cfg, len(prefills), card.ticks_run) \
                or n_paged != n_attn * card.ticks_run:
            raise AssertionError(f"{arch}: the small model missed the "
                                 "attention kernels")
        if not err <= SMALL_LOGIT_TOL:
            raise AssertionError(f"{arch}: prefill logits disagree")


def serve_config():
    from repro_torch.serve import ServeConfig
    return ServeConfig(page_size=16, max_batch_slots=8, max_seq_len=544)


def whisper_serve_config():
    """Whisper's own text context, 448 positions (arXiv:2212.04356): the
    longest prompt, 384 tokens, and 32 new ones fit."""
    from repro_torch.serve import ServeConfig
    return ServeConfig(page_size=16, max_batch_slots=8, max_seq_len=448)


def llava_serve_config():
    """2,880 image tokens, a prompt of up to 512 and 32 new tokens; a pool
    that holds all 8 slots at that length (215 pages each)."""
    from repro_torch.serve import ServeConfig
    n = LLAVA_IMAGE + max(LLAVA_PROMPTS) + 32
    pages = -(-(n + 1) // 16)
    return ServeConfig(page_size=16, max_batch_slots=8, max_seq_len=n,
                       num_pages=1 + 8 * pages)


# the paged check's row lengths at the Whisper and LLaVA serve phases'
# geometries (row 0 inactive; the longest at the last position the
# phase's max_seq_len allows)
PAGED_LENS_WHISPER = (0, 70, 140, 200, 270, 330, 390, 447)
PAGED_LENS_LLAVA = (0, 3010, 3100, 3200, 3300, 3050, 3390, 3423)


def check_serve(cfg, paged_attn, topk_mask, flash_attn, paged_held, *,
                sc=None, lengths=(128, 256, 384, 512)):
    """Serves ``requests`` (8 prompts of the four ``lengths``, 128-512
    tokens by default, 32 new; 4 sampled) with ``cfg`` at full width
    (random bf16 weights from seed 0) through ``sc`` (``serve_config()``
    by default). Asserts the launches from the pattern (flash once per
    attention block a prefill, and Whisper's encoder and cross-attention
    blocks too, paged once per attention block a tick, top-k/top-p on
    sampled ticks), one prefill per prompt length (exact lengths: no
    bucketing), every flash and paged shape one that its check holds,
    and a fresh engine reproducing all 8 streams. Prints tok/s cold and
    warm, ms a tick, peak device memory and the busy share. Returns the
    launches of paged_attention_step, topk_topp_mask and
    flash_attention."""
    from repro_torch.core import api
    from repro_torch.serve import Engine
    sc = sc or serve_config()
    t0 = time.perf_counter()
    params = api.init(cfg, seed=0, device="cuda", max_seq=sc.max_seq_len)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_attn = attention_blocks(cfg)
    print(f"{cfg.name}: {cfg.num_layers} layers ({n_attn} attention), "
          f"d_model {cfg.d_model}, vocab {cfg.padded_vocab}, {n_params} "
          f"parameters ({cfg.dtype}), init {time.perf_counter() - t0:.2f} s")
    reqs = requests(cfg, np.random.default_rng(0), lengths)

    engine = Engine(cfg, sc, params=params)
    torch.cuda.reset_peak_memory_stats()
    paged_attn.launches = topk_mask.launches = flash_attn.launches = 0
    t0 = time.perf_counter()
    with counting_prefills() as prefills, \
            shapes_of(flash_attn, "flash_attention", flash_shape) as fa, \
            shapes_of(paged_attn, "paged_attention_step", paged_shape) as pa:
        streams = serve(engine, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_paged, n_topk = paged_attn.launches, topk_mask.launches
    n_flash = flash_attn.launches
    n_tok = sum(len(s) for s in streams)
    print(f"serve: {n_tok} tokens for 8 requests in {wall:.3f} s "
          f"({n_tok / wall:.1f} tok/s), {engine.steps_run} engine steps, "
          f"{engine.ticks_run} decode ticks, peak device memory "
          f"{torch.cuda.max_memory_allocated()} bytes")
    print(f"launches on the main path: paged_attention_step {n_paged}, "
          f"topk_topp_mask {n_topk}, flash_attention {n_flash} "
          f"({len(prefills)} prefills, batches x lengths {prefills})")
    if len(prefills) != 4:
        raise AssertionError(f"{len(prefills)} prefills for 4 prompt "
                             "lengths")
    want_flash = serve_flash_launches(cfg, len(prefills), engine.ticks_run)
    if n_flash != want_flash:
        raise AssertionError(f"flash attention launched {n_flash} times, "
                             f"want {want_flash}")
    if n_paged != n_attn * engine.ticks_run:
        raise AssertionError(f"paged attention launched {n_paged} times, "
                             f"want {n_attn} x {engine.ticks_run}")
    if n_topk == 0:
        raise AssertionError("top-k/top-p kernel never launched")
    if n_attn:
        check_shapes_held("flash_attention", fa,
                          [c[1:] for c in FLASH_CASES])
        check_shapes_held("paged_attention_step", pa, paged_held)
    # sampled tokens stay in the real vocab; greedy ones are the argmax
    # over the padded vocab, as in the JAX package
    if any(len(s) != 32 or not all(0 <= t < (cfg.padded_vocab if i % 2 == 0
                                              else cfg.vocab_size) for t in s)
           for i, s in enumerate(streams)):
        raise AssertionError(f"bad streams: {streams}")
    logits, _ = api.prefill_logits(
        params, cfg, torch.tensor([reqs[0][0]], device="cuda"),
        torch.tensor([cfg.num_image_tokens + len(reqs[0][0]) - 1],
                     device="cuda"), **stub_batch(cfg, 1, "cuda"))
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are not finite")
    del engine

    engine = Engine(cfg, sc, params=params)
    t0 = time.perf_counter()
    again = serve(engine, reqs)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    if again != streams:
        raise AssertionError("a fresh engine with the same params and "
                             "seeds gave other streams")
    print(f"serve: a fresh engine reproduces all 8 streams (4 sampled); "
          f"warm run {warm:.3f} s ({n_tok / warm:.1f} tok/s, "
          f"{1e3 * warm / engine.ticks_run:.2f} ms per decode tick "
          f"including prefill)")
    del engine
    profile_serve(Engine(cfg, sc, params=params), reqs, warm)
    return n_paged, n_topk, n_flash


def profile_serve(engine, reqs, warm_s):
    """Device time by kernel over one more run of the same requests,
    from torch.profiler, device activity only (with every host op
    recorded as well, RWKV6's tens of thousands of launches kept the
    profiler busy for over a minute on an H100); the busy share is
    against the unprofiled warm run's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve(engine, reqs)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    dev_us = _kernel_us(prof)
    print(f"profile: {len(kernels)} kernel names, device time "
          f"{dev_us / 1e3:.1f} ms = {100 * dev_us / 1e6 / warm_s:.1f}% of "
          f"the warm run's wall time")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for e in top[:12] + [e for e in top[12:] if "flash" in e.key]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# --------------------------------------------------------------------- #
# training: LeNet-5 in the paper's four fp32 lanes (Table 1)
# --------------------------------------------------------------------- #
# Test accuracy of the JAX package on the CPU at these settings: as
# committed in BENCH_paper.json (benchmarks/run.py --fast), and as
# benchmarks/paper_tables.py::lenet_lanes(steps=150) gives it with
# jax 0.9.0, the JAX package's current state.
LENET_JAX_CPU_ACC = {"full_zo": (0.203, 0.354), "zo_feat_cls2": (0.449, 0.600),
                     "zo_feat_cls1": (0.314, 0.387), "full_bp": (0.998, 1.0)}
# zo_perturb launches per step: 2 per probe (4 probes) per ZO leaf
LENET_PERTURB_PER_STEP = {"full_zo": 80, "zo_feat_cls2": 48,
                          "zo_feat_cls1": 64, "full_bp": 0}


def check_memory_agrees(title, loop_mem, step_rows):
    """Each lane's training memory over a loop (parameters plus the
    loop's peak growth, ``paper_lanes.measured_run``) beside the step's
    memory account (``core/engine.py::step_memory_analysis``): they must
    agree within MEMORY_AGREE of the step's peak."""
    for name, mem in loop_mem.items():
        r = step_rows[name]
        off = mem - r["peak_bytes"]
        print(f"{title} {name:13s}: step_memory_analysis peak "
              f"{r['peak_bytes']} bytes (argument {r['argument_bytes']}, "
              f"output {r['output_bytes']}, temp {r['temp_bytes']}, alias "
              f"{r['alias_bytes']}); the loop's training memory {mem} bytes "
              f"({off:+d}, {100 * off / r['peak_bytes']:+.3f}%)")
        if abs(off) > MEMORY_AGREE * r["peak_bytes"]:
            raise AssertionError(f"{title} {name}: the loop's memory {mem} "
                                 "and the step's peak "
                                 f"{r['peak_bytes']} disagree")


def check_lenet(zo_perturb, zo_replay, steps=150, batch=32):
    """Each lane through repro_torch.benchmarks.paper_tables.lenet_lanes,
    one lane a call so that its launches can be read: from the same init
    (seed 7) and key (11) for ``steps`` steps on glyphs(2048, seed=0),
    evaluated on glyphs(512, seed=1, start=10000), the settings behind
    BENCH_paper.json's Table 1 (the harness runs one warm step more, on a
    copy of the state). Then each lane's training memory beside the
    step's memory account at the same batch."""
    from repro_torch.benchmarks.paper_tables import (lenet_lanes,
                                                     lenet_measured_memory)
    acc, peak, train_mem = {}, {}, {}
    for name in LENET_JAX_CPU_ACC:
        zo_perturb.launches = zo_replay.launches = 0
        r = lenet_lanes(steps, batch, lanes=[name])[name]
        n_p, n_r = zo_perturb.launches, zo_replay.launches
        acc[name], peak[name], train_mem[name] = \
            r.acc, r.peak_bytes, r.memory_bytes
        loss = r.history[-1][1]
        committed, current = LENET_JAX_CPU_ACC[name]
        print(f"lenet {name:13s}: test accuracy {acc[name]:.4f} (JAX on the "
              f"CPU: {committed:.3f} in BENCH_paper.json, {current:.3f} with "
              f"jax 0.9.0), last loss {loss:.4f}, "
              f"{1e3 * r.train_s / steps:.3f} ms per step, peak device memory "
              f"{peak[name]} bytes (training memory {train_mem[name]} "
              f"bytes: parameters plus the loop's peak growth), launches "
              "per step: zo_perturb "
              f"{n_p / (steps + 1):g}, zo_fused_replay "
              f"{n_r / (steps + 1):g}")
        want = LENET_PERTURB_PER_STEP[name]
        if n_p != want * (steps + 1) or n_r != want // 8 * (steps + 1):
            raise AssertionError(f"lenet {name}: {n_p} zo_perturb and {n_r} "
                                 f"zo_fused_replay launches in {steps} + 1 "
                                 f"steps, want {want} and {want // 8} a step")
        if not np.isfinite(loss):
            raise AssertionError(f"lenet {name}: loss {loss}")
    order = ("full_bp", "zo_feat_cls2", "zo_feat_cls1", "full_zo")
    if not all(acc[a] > acc[b] for a, b in zip(order, order[1:])):
        raise AssertionError(f"Table 1 ordering does not hold: {acc}")
    print(f"Table 1 ordering holds: {' > '.join(order)}; peak memory "
          f"full_bp / full_zo = {peak['full_bp'] / peak['full_zo']:.3f}, "
          "training memory full_bp / full_zo = "
          f"{train_mem['full_bp'] / train_mem['full_zo']:.3f}")
    check_memory_agrees("lenet", train_mem, lenet_measured_memory(batch))
    return train_mem


# --------------------------------------------------------------------- #
# training: PointNet in the paper's four fp32 lanes (Table 1, Fig. 6)
# --------------------------------------------------------------------- #
# Test accuracy of the JAX package on the CPU at the benchmarks/run.py
# --fast setting (100 steps at batch 32, 256 points, 8 classes): as
# committed in BENCH_paper.json, and as
# benchmarks/paper_tables.py::pointnet_lanes(steps=100) gives it with
# jax 0.9.0, the JAX package's current state.
POINTNET_JAX_CPU_ACC = {"full_zo": (0.125, 0.125),
                        "zo_feat_cls2": (0.125, 0.125),
                        "zo_feat_cls1": (0.25, 0.125),
                        "full_bp": (0.453125, 0.6328125)}
POINTNET_ACC_TOL = 0.03          # 8 of the 256 test clouds
# launches per step at 4 probes: zo_perturb 2 a probe and zo_fused_replay 1
# per ZO leaf (w and b of the 8 / 6 / 7 / 0 ZO layers)
POINTNET_PER_STEP = {"full_zo": (128, 16), "zo_feat_cls2": (96, 12),
                     "zo_feat_cls1": (112, 14), "full_bp": (0, 0)}
PAPER_CLS1_OVERHEAD_PCT = (0.072, 1.7)   # the paper's ElasticZO memory cost


def check_pointnet(zo_perturb, zo_replay, steps=100, timed_steps=20):
    """PointNet's four lanes through
    repro_torch.benchmarks.paper_tables.pointnet_lanes at the run.py --fast
    setting, one lane a call: launches a step, accuracy within
    POINTNET_ACC_TOL of JAX's, full_bp above full_zo. Then each lane timed
    at the paper's 1024 points, batch 32, over ``timed_steps`` steps after
    a warm-up step, with its memory beside the analytic Fig. 6 table.
    Returns the launches of the accuracy runs."""
    from repro_torch.benchmarks.paper_tables import (pointnet_lanes,
                                                     pointnet_memory_table)
    acc, launches = {}, {"zo_perturb": 0, "zo_fused_replay": 0}
    for name, (committed, current) in POINTNET_JAX_CPU_ACC.items():
        zo_perturb.launches = zo_replay.launches = 0
        r = pointnet_lanes(steps, lanes=[name])[name]
        n_p, n_r = zo_perturb.launches, zo_replay.launches
        launches["zo_perturb"] += n_p
        launches["zo_fused_replay"] += n_r
        acc[name] = r.acc
        loss = r.history[-1][1]
        print(f"pointnet {name:13s}: test accuracy {r.acc:.4f} (JAX on the "
              f"CPU: {committed:.4f} in BENCH_paper.json, {current:.4f} with "
              f"jax 0.9.0), last loss {loss:.4f}, "
              f"{1e3 * r.train_s / steps:.3f} ms per step at 256 points, "
              f"launches per step: zo_perturb {n_p / (steps + 1):g}, "
              f"zo_fused_replay {n_r / (steps + 1):g}")
        want_p, want_r = POINTNET_PER_STEP[name]
        # the harness's warm step on a copy of the state (measured_run)
        if (n_p, n_r) != (want_p * (steps + 1), want_r * (steps + 1)):
            raise AssertionError(f"pointnet {name}: {n_p} zo_perturb and "
                                 f"{n_r} zo_fused_replay launches in {steps} "
                                 f"+ 1 steps, want {want_p} and {want_r} a "
                                 "step")
        if not np.isfinite(loss):
            raise AssertionError(f"pointnet {name}: loss {loss}")
        if abs(r.acc - current) > POINTNET_ACC_TOL + 1e-9:
            raise AssertionError(f"pointnet {name}: accuracy {r.acc} is more "
                                 f"than {POINTNET_ACC_TOL} from JAX's "
                                 f"{current}")
    if not acc["full_bp"] > acc["full_zo"]:
        raise AssertionError(f"pointnet: full_bp {acc['full_bp']} is not "
                             f"above full_zo {acc['full_zo']}")
    print(f"pointnet: every lane within {POINTNET_ACC_TOL} of JAX's jax "
          "0.9.0 accuracy; full_bp above full_zo")
    ms, mem = {}, {}
    for name in POINTNET_JAX_CPU_ACC:
        r = pointnet_lanes(timed_steps, num_points=1024, warmup=1,
                           lanes=[name])[name]
        ms[name] = 1e3 * r.train_s / timed_steps
        mem[name] = r.memory_bytes
        print(f"pointnet {name:13s} at 1024 points, batch 32: "
              f"{ms[name]:.3f} ms per step ({timed_steps} steps after a "
              f"warm-up step), peak device memory {r.peak_bytes} bytes, "
              f"training memory {mem[name]} bytes (parameters plus the "
              "loop's peak growth)")
    busy = pointnet_device_ms()
    for name, dev_ms in busy.items():
        print(f"pointnet {name:13s} at 1024 points: device time "
              f"{dev_ms:.3f} ms a step (kernels of one profiled step) = "
              f"{100 * dev_ms / ms[name]:.1f}% of the timed step's wall "
              "time")
    table = pointnet_memory_table(32)
    fz = table["full_zo"]["fp32_bytes"]
    print(f"pointnet training memory full_bp / full_zo = "
          f"{mem['full_bp'] / mem['full_zo']:.4f} (Eqs. 2-4, "
          f"pointnet_memory_table(32): "
          f"{table['full_bp']['fp32_bytes'] / fz:.4f}); zo_feat_cls1 over "
          f"full_zo {100 * (mem['zo_feat_cls1'] / mem['full_zo'] - 1):.3f}% "
          f"(Eqs. 2-4: {100 * (table['zo_feat_cls1']['fp32_bytes'] / fz - 1):.3f}%"
          f"; the paper: {PAPER_CLS1_OVERHEAD_PCT[0]}-"
          f"{PAPER_CLS1_OVERHEAD_PCT[1]}%); 8 classes where the table and "
          "the paper have ModelNet40's 40")
    return launches


def pointnet_device_ms():
    """{lane: device ms of one step} at 1024 points, batch 32, 8 classes:
    each lane's step (from paper_tables.pointnet_lane_configs) after a
    warm-up step, its kernels' time summed by torch.profiler."""
    from repro_torch.benchmarks.paper_tables import pointnet_lane_configs
    from repro_torch.configs.paper_models import PointNetConfig
    from repro_torch.core.elastic import make_elastic_step
    from repro_torch.data.synthetic import point_clouds
    from repro_torch.models import pointnet
    from repro_torch.train.train_loop import init_state
    xs, ys = point_clouds(32, 1024, seed=3)
    batch = {"x": torch.from_numpy(xs).cuda(),
             "y": torch.from_numpy(ys).cuda()}
    cfg = PointNetConfig(num_classes=8)
    out = {}
    for name, lane, c in pointnet_lane_configs(20):
        part = (lambda p, c=c: pointnet.partition_at(p, c)) \
            if lane.lane == "elastic_zo" else None
        step = make_elastic_step(pointnet.pointnet_loss, lane,
                                 partition_fn=part)
        state = [init_state(pointnet.init_pointnet(5, cfg, device="cuda"),
                            17)]
        mask = np.ones((lane.zo_num_probes,), np.float32)

        def one():
            state[0] = step(state[0], batch, mask)[0]
        out[name] = sum(t for _, t in kernel_records(one, calls=1).values())
    return out


def check_pointnet_int8(int8_mm):
    """PointNet's int8 forward at full width (the paper's 40 classes) on
    one batch of 32 clouds of 1024 points quantised by quant_from_float:
    the logits' int8 data and exponent bitwise the CPU's plain versions,
    8 int8_matmul launches. Returns the launches."""
    from repro_torch.configs.paper_models import POINTNET
    from repro_torch.core.int8 import quant_from_float
    from repro_torch.data.synthetic import point_clouds
    from repro_torch.models import pointnet
    xs, _ = point_clouds(32, 1024, seed=4, start=50_000)
    out = {}
    for dev in ("cpu", "cuda"):
        params = pointnet.init_pointnet_int8(5, POINTNET, device=dev)
        qx = quant_from_float(torch.from_numpy(xs).to(dev))
        int8_mm.launches = 0
        with torch.no_grad():
            logits, _ = pointnet.pointnet_forward_int8(params, qx)
        out[dev] = (logits.data.cpu(), int(logits.exp), int8_mm.launches)
    (d_cpu, e_cpu, _), (d_card, e_card, n) = out["cpu"], out["cuda"]
    same = torch.equal(d_cpu, d_card) and e_cpu == e_card
    print(f"pointnet int8 forward, 32 x 1024 points, full width: logits "
          f"{list(d_card.shape)} exponent {e_card}, bitwise the CPU's: "
          f"{same}; int8_matmul launches {n}")
    if not same:
        diff = int((d_cpu != d_card).sum())
        raise AssertionError(f"pointnet int8 forward: {diff} logits differ, "
                             f"exponent {e_card} vs {e_cpu}")
    if n != 8:
        raise AssertionError(f"pointnet int8 forward: {n} int8_matmul "
                             "launches, want 8")
    params = pointnet.init_pointnet_int8(5, POINTNET, device="cuda")
    qx = quant_from_float(torch.from_numpy(xs).cuda())
    def mm_records(times):
        return [(c, t) for k, (c, t) in times.items() if "int8_mma" in k]
    with torch.no_grad():
        # a run where the profiler dropped some of the forward's records
        # (seen after the earlier phases) is profiled again
        times = kernel_records(
            lambda: pointnet.pointnet_forward_int8(params, qx), calls=1,
            whole=lambda t: sum(c for c, _ in mm_records(t)) == n)
    mm = mm_records(times)
    n_mm = sum(c for c, _ in mm)
    print(f"pointnet int8 forward on the card: {n_mm} int8_matmul kernel "
          f"records, {sum(t for _, t in mm):.4f} ms of the forward's "
          f"{sum(t for _, t in times.values()):.4f} ms device time")
    if n_mm != 8:
        raise AssertionError(f"pointnet int8 forward profile: {n_mm} "
                             "int8_matmul records, want 8")
    return n


def bench_run_fast(*sections):
    """repro_torch.benchmarks.run --fast in this process (the given
    sections, or all), written to a temporary file; every section must
    run. Returns the document."""
    import tempfile
    from repro_torch.benchmarks import run as bench_run
    argv = ["--fast"] + [a for s in sections for a in ("--section", s)]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "BENCH_torch_paper.json"
        rc = bench_run.main(argv + ["--out", str(path)])
        doc = json.loads(path.read_text())
    errors = {k: v for k, v in doc["metrics"].items() if k.endswith("_error")}
    if rc or errors:
        raise AssertionError(f"benchmarks.run {argv}: rc {rc}, {errors}")
    return doc


def table2_rows(metrics):
    """Table 2's accuracies (its timings left out)."""
    return {k: v for k, v in metrics.items()
            if k.startswith("table2_") and "_acc_" in k}


def check_paper_tables():
    """The paper-table runner in this process, every section; prints its
    headline metrics. Then Table 2 (the finetune section) once more in
    the same process: its rows must be equal, since every entry point
    trains under core/api.py::deterministic."""
    doc = bench_run_fast()
    m = doc["metrics"]
    keys = [k for k in m if k.startswith(("table1_", "table2_", "memory_",
                                          "int_loss_sign_agreement",
                                          "steptime_"))]
    for k in keys:
        v = m[k]
        print(f"  {k} = {v:.6g}" if isinstance(v, float) else f"  {k} = {v}")
    print(f"paper tables: sections {doc['config']['sections']} on "
          f"{doc['config'].get('card')}")
    first = table2_rows(m)
    again = table2_rows(bench_run_fast("finetune")["metrics"])
    print(f"Table 2 again in the same process: {again}")
    if len(first) != 10 or again != first:
        raise AssertionError(f"Table 2 did not repeat: {first} then {again}")


# --------------------------------------------------------------------- #
# training: LeNet-5 in the paper's three ElasticZO-INT8 lanes (Table 1's
# INT8 and INT8* columns)
# --------------------------------------------------------------------- #
# Test accuracy of the JAX package on the CPU after 150 steps at batch 64
# (benchmarks/paper_tables.py::lenet_int8_lanes, the benchmarks/run.py
# --fast setting): as committed in BENCH_paper.json (INT8* only), and as
# jax 0.9.0 gives it, the JAX package's current state. The int-mode lane
# is integer arithmetic from the init on, so the card must give the
# current figures to the last digit.
LENET_INT8_JAX_CPU_ACC = {
    "int": {"full_zo": (0.017578125, 0.126953125),
            "zo_feat_cls2": (0.8984375, 0.791015625),
            "zo_feat_cls1": (0.966796875, 0.951171875)},
    "float": {"full_zo": (None, 0.41015625),
              "zo_feat_cls2": (None, 0.970703125),
              "zo_feat_cls1": (None, 0.912109375)},
}
# launches per step at 1 probe: int8_perturb 2 (one for all ZO leaves a
# perturbation), zo_fused_replay_int8 1 (all ZO leaves), int8_matmul 5 per
# forward (two forwards) and 2 per tail FC; the test-set forward adds 5
# matmuls a lane
LENET_INT8_PER_STEP = {"full_zo": (2, 1, 10), "zo_feat_cls2": (2, 1, 14),
                       "zo_feat_cls1": (2, 1, 12)}


def check_lenet_int8(zo_perturb, zo_replay, int8_mm, fp32_mem, steps=150,
                     batch=64):
    """Each int8 lane in both loss modes through
    repro_torch.train.paper_lanes.lenet_int8_lanes on the card: launch
    counts, the int-mode accuracies equal to JAX's, ZO-Feat above Full-ZO,
    a bitwise rerun, and the peak memory of 5 steps at batch 32 beside the
    fp32 lane's. Returns the launches of each kernel over the 6 runs."""
    from repro_torch.benchmarks.paper_tables import lenet_int8_measured_memory
    from repro_torch.core import zo
    from repro_torch.train.paper_lanes import INT8_LANES, lenet_int8_lanes
    total = dict.fromkeys(("int8_perturb", "zo_fused_replay_int8",
                           "int8_matmul"), 0)
    acc, kept = {}, {}
    for mode in ("int", "float"):
        for name, _, _ in INT8_LANES:
            zo_perturb.int8_launches = zo_replay.int8_launches = 0
            int8_mm.launches = 0
            r = lenet_int8_lanes(steps, batch, loss_mode=mode,
                                 lanes=[name])[name]
            n = (zo_perturb.int8_launches, zo_replay.int8_launches,
                 int8_mm.launches)
            for k, v in zip(total, n):
                total[k] += v
            acc[mode, name] = r.acc
            kept[mode, name] = r.state
            committed, current = LENET_INT8_JAX_CPU_ACC[mode][name]
            print(f"lenet int8 {mode:5s} {name:13s}: test accuracy "
                  f"{r.acc:.9g} (JAX on the CPU: {committed} in "
                  f"BENCH_paper.json, {current} with jax 0.9.0); "
                  f"{1e3 * r.train_s / steps:.3f} ms per step, training "
                  f"memory {r.memory_bytes} bytes; launches per step: "
                  f"int8_perturb {n[0] / (steps + 1):g}, "
                  f"zo_fused_replay_int8 {n[1] / (steps + 1):g}, int8_matmul "
                  f"{(n[2] - 5) / (steps + 1):g} (+5 for the test set)")
            p, u, m = LENET_INT8_PER_STEP[name]
            # the harness's warm step on a copy of the state (measured_run)
            want = (p * (steps + 1), u * (steps + 1), m * (steps + 1) + 5)
            if n != want:
                raise AssertionError(
                    f"lenet int8 {mode} {name}: launches {n}, want {want}")
            if mode == "int" and r.acc != current:
                raise AssertionError(f"lenet int8 {name}: accuracy {r.acc} "
                                     f"!= JAX's {current}")
        for name in ("zo_feat_cls2", "zo_feat_cls1"):
            if not acc[mode, name] > acc[mode, "full_zo"]:
                raise AssertionError(f"{mode}: {name} {acc[mode, name]} is "
                                     "not above full_zo "
                                     f"{acc[mode, 'full_zo']}")
    print("int mode: all three accuracies equal JAX's to the last digit; "
          "both ZO-Feat lanes above Full-ZO in both modes")
    again = lenet_int8_lanes(steps, batch, lanes=["zo_feat_cls1"])
    first = dict((zo.keystr(p), t) for p, t in
                 zo.leaves_with_path(kept["int", "zo_feat_cls1"].params))
    same = all(torch.equal(t.data, first[zo.keystr(p)].data)
               and torch.equal(t.exp, first[zo.keystr(p)].exp)
               for p, t in zo.leaves_with_path(
                   again["zo_feat_cls1"].state.params))
    print(f"rerun of zo_feat_cls1 (int) from the same seed: parameters "
          f"bitwise equal: {same}")
    if not same:
        raise AssertionError("an int8 rerun from the same seed differs")
    int8_mem = {}
    for name, _, _ in INT8_LANES:
        mem = lenet_int8_lanes(5, 32, lanes=[name])[name].memory_bytes
        int8_mem[name] = mem
        print(f"lenet {name:13s} training memory (parameters plus the loop's "
              f"peak growth), 5 steps at batch 32: int8 {mem} bytes, fp32 "
              f"{fp32_mem[name]} bytes (150 steps, 4 probes): fp32 / int8 = "
              f"{fp32_mem[name] / mem:.3f}")
    check_memory_agrees("lenet int8", int8_mem,
                        lenet_int8_measured_memory(32))
    return total


# --------------------------------------------------------------------- #
# the seed-ledger fleet: LeNet-5 INT8 and qwen3-4b, with a catch-up
# --------------------------------------------------------------------- #
LENET_INT8_WEIGHTS = 107_550
FLEET_INT8 = dict(num_workers=8, probes_per_worker=1, dropout=0.2,
                  max_delay=2, deadline=1, crashes=((3, 2, 2),),
                  snapshot_every=10)
FLEET_INT8_STEPS = 20
FLEET_LM = dict(num_workers=4, probes_per_worker=1, crashes=((1, 1, 2),),
                snapshot_every=10)
FLEET_LM_STEPS = 4


@contextlib.contextmanager
def recording(module, name, counter):
    """For the block, wraps ``module.<name>``: each call's records shape
    (S, n) and the kernel launches it made (``counter()`` before and
    after), and the arguments and result of each call with S > 1."""
    real = getattr(module, name)
    calls = []

    def wrapped(*args, **kwargs):
        n0 = counter()
        out = real(*args, **kwargs)
        S, n = args[1].shape
        calls.append(((S, n), counter() - n0,
                      (args, kwargs, out) if S > 1 else None))
        return out
    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def shapes_of(module, name, key):
    """For the block, wraps ``module.<name>`` and collects ``key(*args,
    **kwargs)`` of each call in a set."""
    real = getattr(module, name)
    seen = set()

    def wrapped(*args, **kwargs):
        seen.add(key(*args, **kwargs))
        return real(*args, **kwargs)
    setattr(module, name, wrapped)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def mm_shape(a, w):
    return a.shape[0], a.shape[1], w.shape[1]


def flash_shape(q, k, v, *, causal=True, window=0, scale=None,
                q_offset=0, return_lse=False):
    """A call's FLASH_CASES entry (without its label); a scale other than
    the wrapper's default 1 / sqrt(D), a query offset, or a log-sum-exp,
    is kept, so it matches no entry (check_flash_offset holds the offset
    calls, check_flash_lse the log-sum-exp)."""
    B, H, Sq, D = q.shape
    return (B, H, k.shape[1], Sq, k.shape[2], D, q.dtype, causal, window) \
        + (() if scale is None or scale == 1.0 / math.sqrt(D) else (scale,)) \
        + ((q_offset,) if q_offset else ()) \
        + (("lse",) if return_lse else ())


def check_shapes_held(name, seen, held):
    """Every shape the path gave the kernel is one that the kernel's own
    check holds against its plain version."""
    print(f"{name} shapes on this path: {sorted(map(str, seen))}")
    if not seen or seen - set(held):
        raise AssertionError(f"{name} ran at {sorted(map(str, seen - set(held)))}"
                             ", which its check against the plain version "
                             "does not cover")


def check_index_held(name, ends, held):
    """Every flat index the path gave the kernel (``ends``: offset +
    elements of each call) lies in the range [0, held) that its check
    against the plain version covers."""
    print(f"{name}: largest flat index on this path {max(ends) - 1}, "
          f"held to {held - 1}")
    if not ends or max(ends) > held:
        raise AssertionError(f"{name} ran past flat index {held - 1}, which "
                             "its check against the plain version does not "
                             "cover")


def check_catchup(calls, name, S, n, per_call):
    """Exactly ``per_call`` calls replay S x n records, each one kernel
    launch; every other call is a live apply (S = 1). Returns the catch-up
    calls."""
    catch = [c for c in calls if c[0] == (S, n)]
    print(f"{name}: {len(calls)} replay calls, {len(catch)} of them the "
          f"catch-up (S = {S} steps x n = {n} probes), launches "
          f"{[c[1] for c in catch]}")
    if len(catch) != per_call or any(c[1] != 1 for c in catch) \
            or any(c[0] != (1, n) for c in calls if c[0] != (S, n)):
        raise AssertionError(f"{name}: the catch-up is not one launch of "
                             f"S = {S} x n = {n} per call: "
                             f"{sorted(set(c[0] for c in calls))}")
    return [c[2] for c in catch]


def fleet_run(run_fleet, loss_fn, params, lane, cfg, batch_fn, steps,
              base, **kw):
    """One timed fleet run (every kernel built already); returns (result,
    wall s, peak device memory)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_fleet(loss_fn, params, lane, cfg, batch_fn, steps=steps,
                    base_seed=base, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def check_fleet_canon(res, launch_fleet):
    """Every live worker bitwise the coordinator's canon."""
    live = [w for w in res.workers if w.alive]
    bad = [w.id for w in live
           if not launch_fleet.trees_equal(w.params, res.params)]
    print(f"{len(live)}/{len(res.workers)} workers live at the end, "
          f"{len(live) - len(bad)} bitwise equal to the coordinator")
    if bad or len(live) != len(res.workers):
        raise AssertionError(f"workers {bad} differ from the canon")


def check_fleet_int8(zo_perturb, zo_replay, int8_mm, ref):
    """The paper's int8 deployment (LeNet-5, Alg. 2, one FC in the tail)
    through repro_torch.launch.fleet's assembly on the card: 8 workers x 1
    probe through dropout, stragglers and worker 3's crash, whose rejoin
    at step 4 replays steps 0-3 from the step-0 snapshot in one
    zo_fused_replay_int8 launch (S = 4, n = 8), held against the plain
    version; every worker and the single-process reference, on the card
    and on the CPU, bitwise the canon; 9-byte probe entries; every
    int8_matmul shape of the run one that check_int8_matmul holds bitwise
    (MM_FLEET). Then the int8 replay's device time at
    LeNet-5's 107,550 elements for S = 1..8. Returns the launches of the
    three int8 kernels in the fleet run."""
    from repro_torch.configs import FleetConfig
    from repro_torch.core import keys, zo
    from repro_torch.core.int8 import QTensor
    from repro_torch.fleet import run_fleet
    from repro_torch.fleet.coordinator import host_copy
    from repro_torch.kernels import ops
    from repro_torch.launch import fleet as launch_fleet
    params, lane, part, probe_fn, batch_fn = \
        launch_fleet.lenet_int8_fleet_setup(bp_tail_layers=1, batch=8)
    qs = [q for q in zo.leaves(params) if isinstance(q, QTensor)]
    if sum(q.data.numel() for q in qs) != LENET_INT8_WEIGHTS:
        raise AssertionError("LeNet-5 int8 is not at the paper's size")
    base = keys.key_data(1)
    zo_perturb.int8_launches = zo_replay.int8_launches = 0
    int8_mm.launches = 0
    with recording(ops, "zo_fused_replay_int8_leaves",
                   lambda: zo_replay.int8_launches) as calls, \
            shapes_of(int8_mm, "int8_matmul", mm_shape) as mm_shapes:
        res, wall, peak = fleet_run(
            run_fleet, None, params, lane, FleetConfig(**FLEET_INT8),
            batch_fn, FLEET_INT8_STEPS, base, partition_fn=part,
            probe_fn=probe_fn)
    n = {"int8_perturb": zo_perturb.int8_launches,
         "zo_fused_replay_int8": zo_replay.int8_launches,
         "int8_matmul": int8_mm.launches}
    s = res.stats
    n_rec = sum(len(r) for r in res.ledger.records.values())
    records = FLEET_INT8_STEPS * 8 - 2          # worker 3 down 2 steps
    print(f"fleet lenet int8: {FLEET_INT8_STEPS} steps, 8 workers x 1 probe, "
          f"{1e3 * wall / FLEET_INT8_STEPS:.3f} ms per fleet step "
          f"({wall:.3f} s), peak device memory {peak} bytes; dropped "
          f"{s['n_dropped']}, straggled {s['n_straggled']}, rejoins "
          f"{s['n_catchups']}; ledger {n_rec} records: ZO {s['ledger_bytes_zo']}"
          f" bytes, tail {s['ledger_bytes_tail']} bytes, host {res.ledger.nbytes}"
          f" bytes; catch-up slice {s['bytes_catchup']} bytes; launches {n}")
    want = {"int8_perturb": 2 * records,
            "zo_fused_replay_int8": FLEET_INT8_STEPS + records + 1,
            "int8_matmul": 12 * records}
    if n != want or s["n_catchups"] != 1 or not s["n_dropped"] \
            or not s["n_straggled"]:
        raise AssertionError(f"fleet lenet int8: launches {n}, want {want};"
                             f" stats {s}")
    some = next(iter(res.ledger.records[0].values()))
    if some.zo_probe_nbytes != 9:
        raise AssertionError(f"int8 ZO probe entry {some.zo_probe_nbytes} B")
    check_shapes_held("int8_matmul", mm_shapes, MM_FLEET)
    (args, kwargs, out), = check_catchup(calls, "fleet lenet int8", 4, 8, 1)
    thetas, seeds, gs, salts = args[:4]
    differ = sum(int((o != ref.zo_fused_replay_int8_ref(t, seeds, gs, salt,
                                                        *args[4:])).sum())
                 for t, o, salt in zip(thetas, out, salts))
    print(f"the catch-up against the plain version leaf by leaf "
          f"({sum(t.numel() for t in thetas)} elements): {differ} differ")
    if differ:
        raise AssertionError("the int8 catch-up differs from the plain "
                             "version")
    check_fleet_canon(res, launch_fleet)
    if not launch_fleet.verify_reference(res, params, probe_fn, None,
                                         batch_fn, FLEET_INT8_STEPS, base):
        raise AssertionError("the int8 fleet differs from the "
                             "single-process reference")
    print("single-process int8 reference with the realised masks: bitwise "
          "the canon")
    # the same reference on the CPU, where every int8 kernel is its plain
    # version: the lane is exact, so the card's canon must equal it
    t0 = time.perf_counter()
    cpu_params, _, _, cpu_probe_fn, cpu_batch_fn = \
        launch_fleet.lenet_int8_fleet_setup(bp_tail_layers=1, batch=8,
                                            device="cpu")
    on_host = types.SimpleNamespace(
        schema=res.schema, masks=res.masks, arrival_masks=res.arrival_masks,
        params=host_copy(res.params))
    if not launch_fleet.verify_reference(on_host, cpu_params, cpu_probe_fn,
                                         None, cpu_batch_fn,
                                         FLEET_INT8_STEPS, base):
        raise AssertionError("the int8 fleet on the card differs from the "
                             "single-process reference on the CPU")
    print(f"single-process int8 reference on the CPU (the plain versions): "
          f"bitwise the card's canon ({time.perf_counter() - t0:.1f} s)")
    # the replay at LeNet-5's whole-model total, S steps x 8 probes
    leaves = [q.data for q in qs]
    salts = [zo.path_salt(p) for p, _ in zo.leaves_with_path(params)]
    g = torch.Generator().manual_seed(3)
    sd = torch.randint(-2**31, 2**31, (8, 8), generator=g,
                       dtype=torch.int64).to(torch.int32).cuda()
    gg = torch.randint(-1, 2, (8, 8), generator=g, dtype=torch.int32).cuda()
    r = (lane.int8_r_max, lane.int8_p_zero, 1)

    outs = [torch.empty_like(t) for t in leaves]

    def replay_ms(S):
        # the profiler dropped this kernel's records after the earlier
        # phases' profiles (five runs running, twice): a CUDA graph instead
        return graph_ms(lambda: zo_replay.zo_fused_replay_int8_leaves(
            leaves, sd[:S], gg[:S], salts, *r, outs=outs))
    times = {S: replay_ms(S) for S in (1, 2, 4, 8)}
    print("zo_fused_replay_int8 over LeNet-5's 107,550 int8 weights, S steps "
          "x n = 8 probes, one launch (a CUDA graph of 100): "
          + ", ".join(f"S = {S}: {t:.5f} ms ({1e3 * t / S:.3f} us a step)"
                      for S, t in times.items()))
    return n


def check_fleet_lm(zo_perturb, zo_replay, flash_attn, ref):
    """The fp32 lane's fleet on qwen3-4b at full width (bf16, random
    weights from seed 0), depth cut to 2 layers (one ZO, one BP tail):
    4 workers x 1 probe at batch 1 x seq 128 for 4 steps, worker 1 down
    at steps 1-2 and back at 3 by replaying steps 0-2 from the step-0
    snapshot, one zo_fused_replay launch per ZO leaf (S = 3, n = 4) held
    against the plain version; every worker and the single-process
    reference (the realised masks) bitwise the canon; every
    flash_attention shape of the run one of FLASH_CASES. Returns the
    launches of zo_perturb, zo_fused_replay and flash_attention."""
    from repro_torch.configs import ARCHS, FleetConfig, LaneConfig
    from repro_torch.core import api, elastic, keys, zo
    from repro_torch.data.synthetic import token_batch
    from repro_torch.fleet import run_fleet
    from repro_torch.kernels import ops
    from repro_torch.launch import fleet as launch_fleet
    cfg = dataclasses.replace(ARCHS["qwen3-4b"], num_layers=2)
    lane = LaneConfig(lane="elastic_zo", bp_tail_layers=1, zo_num_probes=1,
                      learning_rate=1e-2, zo_eps=1e-3)
    dev = torch.device("cuda")
    params = api.init(cfg, lane, seed=0, device=dev)
    zo_part, bp_part = elastic.partition(params, lane)
    n_zo = len(list(zo.leaves_with_path(zo_part)))
    n_tail = sum(t.numel() for _, t in zo.leaves_with_path(bp_part))

    def loss_fn(p, b):
        return api.loss_fn(p, cfg, b)

    def batch_fn(step):
        x, y, m = token_batch(1, 128, cfg.vocab_size, seed=1, step=step)
        return {k: torch.from_numpy(v).to(dev)
                for k, v in (("tokens", x), ("labels", y), ("mask", m))}

    base = keys.key_data(1)
    zo_perturb.launches = zo_replay.launches = flash_attn.launches = 0
    with recording(ops, "zo_fused_replay", lambda: zo_replay.launches) \
            as calls, shapes_of(flash_attn, "flash_attention",
                                flash_shape) as fa_shapes:
        res, wall, peak = fleet_run(
            run_fleet, loss_fn, params, lane, FleetConfig(**FLEET_LM),
            batch_fn, FLEET_LM_STEPS, base)
    n = {"zo_perturb": zo_perturb.launches,
         "zo_fused_replay": zo_replay.launches,
         "flash_attention": flash_attn.launches}
    s = res.stats
    n_rec = sum(len(r) for r in res.ledger.records.values())
    records = FLEET_LM_STEPS * 4 - 2            # worker 1 down 2 steps
    some = next(iter(res.ledger.records[0].values()))
    print(f"fleet qwen3-4b (full width, 2 layers, {n_zo} ZO leaves, "
          f"{n_tail} tail elements): {FLEET_LM_STEPS} steps, 4 workers x 1 "
          f"probe, {1e3 * wall / FLEET_LM_STEPS:.1f} ms per fleet step "
          f"({wall:.3f} s), peak device memory {peak} bytes; ZO "
          f"{some.zo_probe_nbytes} bytes a probe, tail "
          f"{s['ledger_bytes_tail'] / n_rec:.0f} bytes a record; ledger "
          f"{n_rec} records, {res.ledger.nbytes} bytes on the host; "
          f"catch-up slice {s['bytes_catchup']} bytes; launches {n}")
    want = {"zo_perturb": 2 * n_zo * records,
            "zo_fused_replay": n_zo * (FLEET_LM_STEPS + records + 1),
            "flash_attention": 2 * records}
    if n != want or s["n_catchups"] != 1 or some.zo_probe_nbytes != 12:
        raise AssertionError(f"fleet qwen3-4b: launches {n}, want {want}; "
                             f"stats {s}")
    check_shapes_held("flash_attention", fa_shapes,
                      [c[1:] for c in FLASH_CASES + FLASH_EDGE_CASES])
    catch = check_catchup(calls, "fleet qwen3-4b", 3, 4, n_zo)
    differ = worst = 0
    for (theta, sd, cf, salt), _, out in catch:
        flat = theta.reshape(-1)
        count, far = ulp_diff(out, lambda lo, hi: ref.zo_fused_replay_ref(
            flat[lo:hi], sd, cf, salt, lo))
        differ, worst = differ + count, max(worst, far)
    print(f"the catch-up against the plain version, leaf by leaf "
          f"({sum(a[0].numel() for a, _, _ in catch)} elements): {differ} "
          f"differ (largest distance {worst} ulp)")
    if differ:
        raise AssertionError("the fp32 catch-up differs from the plain "
                             "version")
    del catch, calls
    check_fleet_canon(res, launch_fleet)
    for w in res.workers:                 # room for the reference's copies
        w.params = w.residual = None
    torch.cuda.empty_cache()
    if not launch_fleet.verify_reference(res, params, None, loss_fn,
                                         batch_fn, FLEET_LM_STEPS, base):
        raise AssertionError("the qwen3-4b fleet differs from the "
                             "single-process reference")
    print("single-process reference with the realised masks: bitwise the "
          "canon")
    return n


# --------------------------------------------------------------------- #
# training: qwen3-4b at full width and depth
# --------------------------------------------------------------------- #
TRAIN_ARGV = ["--arch", "qwen3-4b", "--lane", "elastic_zo",
              "--bp-tail-layers", "1", "--probes", "1", "--batch", "4",
              "--seq", "128", "--lr", "1e-2", "--eps", "1e-3", "--steps", "5"]


def train_run(trainer, run, LoopConfig, steps=5):
    """One warm-up step, then ``steps`` - 1 timed ones, through
    train_loop.run fed by the launcher's Prefetcher
    (``launch.train.prefetched``, as ``launch.train.main`` feeds it; the
    loss read on the host after every step). Returns (state, losses,
    timed wall s, peak device memory of the timed steps, peak device
    memory of the first step)."""
    from repro_torch.launch.train import prefetched

    def loop(total):
        return LoopConfig.for_lane(trainer.lane, total_steps=total,
                                   log_every=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with prefetched(trainer) as batch_fn:
        state, h0 = run(trainer.step_fn, trainer.state, batch_fn, loop(1),
                        log=None)
        torch.cuda.synchronize()
        peak0 = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, h1 = run(trainer.step_fn, state, batch_fn, loop(steps),
                        log=None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return state, [loss for _, loss in h0 + h1], wall, \
        torch.cuda.max_memory_allocated(), peak0


# --------------------------------------------------------------------- #
# training: qwen3-4b through the pipeline, a checkpoint and a resume
# --------------------------------------------------------------------- #
CKPT_DIR = ROOT / "_ckpt_smoke"  # listed in .gitignore; removed after use


def timed_run(trainer, state, batch_fn, run, LoopConfig, total):
    """``train_loop.run`` from ``state`` to step ``total``, the loss read
    after every step; returns (state, losses, wall s)."""
    loop = LoopConfig.for_lane(trainer.lane, total_steps=total, log_every=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = run(trainer.step_fn, state, batch_fn, loop, log=None)
    torch.cuda.synchronize()
    return state, [loss for _, loss in hist], time.perf_counter() - t0


FEED_ROUNDS = 2                  # ABBA rounds of the two feeds a config


def feed_pairs(title, trainer, state, run, LoopConfig, steps=4,
               rounds=FEED_ROUNDS):
    """ms a step of the trainer's plain batch function and of the
    launcher's Prefetcher (``launch.train.prefetched``) in one process,
    in ABBA order (plain, prefetched, prefetched, plain, ``rounds``
    times) so that neither feed always runs first or last. Each run
    continues from the last: one warm step (the prefetcher's start),
    then ``steps`` timed. Prints each feed's times and medians; returns
    (state, {feed: median ms})."""
    from statistics import median
    from repro_torch.launch.train import prefetched
    ms = {"plain": [], "prefetched": []}
    for feed in ("plain", "prefetched", "prefetched", "plain") * rounds:
        trainer.state = state
        with (prefetched(trainer) if feed == "prefetched"
              else contextlib.nullcontext(trainer.batch_fn)) as batch_fn:
            state, _, _ = timed_run(trainer, state, batch_fn, run,
                                    LoopConfig, state.step + 1)
            state, _, wall = timed_run(trainer, state, batch_fn, run,
                                       LoopConfig, state.step + steps)
        ms[feed].append(1e3 * wall / steps)
    med = {k: median(v) for k, v in ms.items()}
    print(f"{title}, the two feeds in ABBA order ({steps} timed steps a "
          f"run): plain {[round(v, 1) for v in ms['plain']]} ms a step, "
          f"median {med['plain']:.1f}; prefetched "
          f"{[round(v, 1) for v in ms['prefetched']]}, median "
          f"{med['prefetched']:.1f} "
          f"({100 * (med['prefetched'] / med['plain'] - 1):+.1f}%)")
    return state, med


def check_train_resume(zo_perturb, zo_replay, flash_attn, steps=8):
    """qwen3-4b at full width and depth through repro_torch.launch.train's
    own functions, twice from the same seed: ``steps`` steps fed by the
    plain batch function, and the same steps fed by the launcher's
    Prefetcher (``launch.train.prefetched``), interrupted half way by
    ``checkpoint.save`` and a resume through
    ``elastic_runtime.resume_on_mesh`` (``setup`` with ``--ckpt-dir``).
    The first run's launch counts (the flash kernel in the 35 ZO periods
    of each probe forward, none in the BP tail), finite losses, a
    changed head and tail (bit digests before and after); the second
    run's losses must be the first's bitwise and its final parameters
    bytes-equal (a bitwise rerun across a save and a resume). Prints ms
    a step of each feed after each run's first step (the allocator keeps
    the first run's blocks for the second), the device peak of the first
    and the timed steps, the save's and the restore's seconds and bytes,
    and the device peak of the restore; then the two feeds' ms a step in
    ABBA order (``feed_pairs``, after the counts are read) and the
    step's device time by kernel. Returns the launches, the first step's
    peak, the plain run's losses and the resumed trainer, its last state
    in ``trainer.state``."""
    import shutil
    from repro_torch.core import elastic, zo
    from repro_torch.launch import train as launch_train
    from repro_torch.obs.memory import tree_nbytes
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_loop import LoopConfig, run
    half = steps // 2
    argv = TRAIN_ARGV[:-1] + [str(steps)]
    args = launch_train.parse_args(argv)
    zo_perturb.launches = zo_replay.launches = flash_attn.launches = 0
    t0 = time.perf_counter()
    plain = launch_train.setup(args)
    torch.cuda.synchronize()
    print(f"train setup (init of "
          f"{sum(p.numel() for p in _leaves(plain.state.params))} bf16 "
          f"parameters) {time.perf_counter() - t0:.2f} s")
    parts = [[zo.keystr(p) for p, _ in zo.leaves_with_path(t)]
             for t in elastic.partition(plain.state.params, plain.lane)]
    zo_periods = plain.state.params["periods_zo"]["blk0"]["ln_attn"].shape[0]
    start = digests(plain.state.params)
    torch.cuda.reset_peak_memory_stats()
    state, losses_a, _ = timed_run(plain, plain.state, plain.batch_fn, run,
                                   LoopConfig, 1)
    peak0 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, more, wall_plain = timed_run(plain, state, plain.batch_fn, run,
                                        LoopConfig, steps)
    peak = torch.cuda.max_memory_allocated()
    losses_a += more
    want = digests(state.params)
    moved = [sum(start[k] != want[k] for k in names) for names in parts]
    print(f"train qwen3-4b elastic_zo, 1 probe: peak device memory {peak} "
          f"bytes over steps 1-{steps - 1} ({peak0} in the first step); "
          f"leaves changed by training: {moved[0]} of {len(parts[0])} ZO, "
          f"{moved[1]} of {len(parts[1])} BP-tail")
    if not moved[0] or not moved[1] or len(parts[0]) != 12 \
            or zo_periods != 35:
        raise AssertionError("training left the ZO head or the tail as it "
                             f"was, or {len(parts[0])} ZO leaves and "
                             f"{zo_periods} ZO periods (want 12 and 35)")
    del start
    nbytes = tree_nbytes(state.params)
    del plain, state

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        first = launch_train.setup(args)
        with launch_train.prefetched(first) as batch_fn:
            state, losses_b, _ = timed_run(first, first.state, batch_fn, run,
                                           LoopConfig, 1)
            state, more, wall_pf = timed_run(first, state, batch_fn, run,
                                             LoopConfig, half)
        losses_b += more
        t0 = time.perf_counter()
        path = ckpt.save(CKPT_DIR, half, state.params)
        save_s = time.perf_counter() - t0
        disk = sum(f.stat().st_size for f in path.iterdir())
        del first, state
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        resumed = launch_train.setup(launch_train.parse_args(
            argv + ["--ckpt-dir", str(CKPT_DIR)]))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restore_peak = torch.cuda.max_memory_allocated() - base
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    if resumed.state.step != half:
        raise AssertionError(f"resumed at step {resumed.state.step}, want "
                             f"{half}")
    with launch_train.prefetched(resumed) as batch_fn:
        state, more, wall_resumed = timed_run(resumed, resumed.state,
                                              batch_fn, run, LoopConfig,
                                              steps)
    losses_b += more
    got = digests(state.params)
    n_p, n_r, n_f = (zo_perturb.launches, zo_replay.launches,
                     flash_attn.launches)
    print(f"train qwen3-4b, batch {args.batch} x seq {args.seq}: plain feed "
          f"{1e3 * wall_plain / (steps - 1):.1f} ms a step (steps 1-"
          f"{steps - 1}), prefetched {1e3 * wall_pf / (half - 1):.1f} ms a "
          f"step (steps 1-{half - 1}), prefetched after the resume "
          f"{1e3 * wall_resumed / (steps - half):.1f} ms a step (steps "
          f"{half}-{steps - 1})")
    print(f"checkpoint of {nbytes} parameter bytes: save {save_s:.2f} s "
          f"({disk} bytes on disk, {nbytes / save_s / 1e9:.2f} GB/s); "
          f"resume_on_mesh {restore_s:.2f} s ({nbytes / restore_s / 1e9:.2f}"
          f" GB/s), device peak during the restore {restore_peak} bytes "
          f"({restore_peak / nbytes:.4f} x the parameters)")
    print(f"losses, plain feed: {losses_a}")
    print(f"losses, prefetched, saved at step {half} and resumed: "
          f"{losses_b}")
    print(f"launches (2 x {steps} steps): zo_perturb {n_p}, zo_fused_replay "
          f"{n_r}, flash_attention {n_f}")
    if (n_p, n_r, n_f) != (2 * steps * 24, 2 * steps * 12, 2 * steps * 70):
        raise AssertionError("want 24 zo_perturb, 12 zo_fused_replay and 70 "
                             "flash launches a step")
    if losses_b != losses_a or not all(np.isfinite(losses_a)):
        raise AssertionError("the prefetched and resumed losses differ from "
                             "the plain run's")
    same = got == want
    print(f"parameters after {half} + {steps - half} resumed steps "
          f"bytes-equal to {steps} straight ones: {same} ({len(got)} "
          "leaves)")
    if not same:
        raise AssertionError("the resumed run's parameters differ")
    state, med = feed_pairs("train qwen3-4b", resumed, state, run,
                            LoopConfig)
    profile_train_step(resumed, state, run, LoopConfig,
                       med["prefetched"] / 1e3)
    resumed.state = state
    del state
    return {"zo_perturb": n_p, "zo_fused_replay": n_r,
            "flash_attention": n_f}, peak0, losses_a, resumed


# --------------------------------------------------------------------- #
# training across a mesh (torch.distributed; ranks sharing the card)
# --------------------------------------------------------------------- #
MESH_AXES = ("data", "model")
MESH_LAYERS = 4                  # of qwen3-4b's 36, at full width
MESH_STEPS = 2                   # a lane's steps: the first untimed (it
#                                  pays the lane's one-time costs), the
#                                  second timed
MESH_LOSS_RTOL = 2e-3            # bf16 losses of a sharded run against one
#                                  device's: the row-parallel, vocab-parallel
#                                  and gather orders round apart (at most
#                                  1.6e-4 over the lanes on the H100, PERF.md,
#                                  PR 25). At this cut one step's update moves
#                                  the next loss by only 1.7e-4 at 4 x 128
#                                  and 1.5e-3 at 4 x 512 (read once against
#                                  the same steps at lr 0, PERF.md, PR 25),
#                                  so no loss tolerance that passes the
#                                  rounding fails a lost update: the leaves'
#                                  moves below do
MESH_MOVE_RTOL = 5e-2            # each leaf's summed |change| over a lane's
#                                  MESH_STEPS steps against one device's
#                                  (relative; at most 2.1e-2 over the lanes
#                                  after 1 and after 2 steps, PERF.md, PR
#                                  25): a lost update moves a leaf by 0, a
#                                  gradient summed twice by twice as much,
#                                  distance 1 either way
MESH_SMALL_TOL = 1e-4            # reduced f32 stacks, card against CPU
#                                  (losses and params, relative; each card
#                                  step against the CPU's from its state)
MESH_SMALL_ILL = ("rwkv 2x2 fsdp", "full_bp", 7.2e-4)
#                                  the one reduced step past MESH_SMALL_TOL,
#                                  (label, lane, bound on its params):
#                                  reduced RWKV6's 2x2 fsdp full_bp step 1
#                                  read 3.65e-4 card against CPU, and
#                                  moving each element of that step's input
#                                  one ulp moved the CPU's own step 3.60e-4
#                                  (its floor, which _mesh_small measures
#                                  there and check_mesh requires past
#                                  MESH_SMALL_TOL): held to 2 times that
#                                  floor (PERF.md §6)
MESH_LLAVA_LAYERS = 2            # of llava-next-34b's 60, at full width:
#                                  one ZO period and one tail period
MESH_MOE_LAYERS = 2              # of mixtral-8x7b's 32, at full width:
#                                  one ZO period and one tail period
MESH_WHISPER_LAYERS = 4          # of whisper-small's 12 decoder and 12
#                                  encoder layers (3 ZO periods, 1 tail)
MESH_RWKV_LAYERS = 2             # of rwkv6-1.6b's 24, at full width:
#                                  one ZO period and one tail period
MESH_MAMBA_LAYERS = 2            # of Jamba's blocks in the Mamba lane, at
#                                  full width: one ZO period and one tail
#                                  period
MESH_MAMBA_ONLY = (("block_pattern", ("mamba",)), ("num_experts", 0),
                   ("experts_per_token", 0))
#                                  the Mamba lane's overrides of Jamba's
#                                  config: its Mamba block (d_inner 8192,
#                                  configs.base.MAMBA) with a dense FFN in
#                                  every layer
MESH_DTYPES = {"whisper-small": "float32", "llava-next-34b": "float32",
               "mixtral-8x7b": "float32", "rwkv6-1.6b": "float32",
               "jamba-v0.1-52b": "float32"}
#                                  qwen3-4b's lanes in bf16. The first
#                                  (l+, l-) of whisper-small and of
#                                  LLaVA's cut differ by 2.2e-3 and
#                                  2.4e-2 (f32), little more than bf16
#                                  logits round (5.9e-4 in LLaVA's bf16 l+
#                                  between the 2x2 tp lane and one
#                                  device), so in bf16 the ZO coefficients,
#                                  and each ZO leaf's move, rounded apart:
#                                  0.364 and 0.0739 against MESH_MOVE_RTOL
#                                  (PERF.md §6); in f32 1.26e-2 and 1.89e-4.
#                                  Mixtral's cut likewise: l+ - l-
#                                  -1.2e-3 on one device, -7.6e-4 on the
#                                  2x2 tp lane in bf16, leaf moves 0.283
#                                  apart (PERF.md §6). The recurrent
#                                  lanes run in f32 from the start
# the mesh phase's lanes on a 2x2 mesh, one spawn: (label, arch, strategy,
# fused probes, batch, seq, overrides of the arch's config as pairs).
# qwen3-4b cut to MESH_LAYERS under tp (the four-card NCCL check's lane). whisper-small at full width, cut to
# MESH_WHISPER_LAYERS (for the Mixtral lane's time), at 4 x 128 in
# every strategy, fused under tp and fsdp beside the unfused lanes: it
# holds the
# fsdp and serve strategies and the fused pairs at full width, which
# qwen3-4b's lanes at 4 x 128 and 4 x 512 held before (on a slow host
# their timed steps read 9.0 to 44.5 s each, and the mesh phase 407 s,
# PERF.md §6). llava-next-34b cut to MESH_LLAVA_LAYERS at 2 x 3,008
# (2,880 image and 128 text tokens) under tp: under fsdp a rank would
# gather a layer's 2.2 GB (f32) through gloo's host side, so its other
# strategies are held by the reduced config. mixtral-8x7b cut to
# MESH_MOE_LAYERS at 4 x 128 under the ep plan (8 experts over 2 `model`
# ranks), fsdp: the 4 rows over (data, model), so the expert buffers go
# through the dispatch all-to-all; a rank gathers a layer's 4 experts
# over `data` (1.41 G parameters, f32). Its tp lane (each `model` rank
# the same rows and its own experts) took as long, 32.3 s a warm step,
# and its serve lane (experts resident) ran out of the card's memory in
# f32, four ranks at ~19.5 GB (PERF.md §6): both, and the MoE tp
# plan, are held by the reduced configs. rwkv6-1.6b cut to
# MESH_RWKV_LAYERS under tp at 4 x 128 (its 32 heads, 16 a `model` rank);
# Jamba's Mamba block with its dense FFN (MESH_MAMBA_ONLY) under serve at 4 x
# 128 (d_inner 8,192, 4,096 a rank: in_proj's product re-laid out over
# `model`, x_proj's row-parallel sum; the weights replicated over
# `data`, so no gather through gloo's host side). Jamba's whole period
# (four 16-expert MoE layers) is held by the reduced configs
MESH_LANES = (("tp", "qwen3-4b", "tp", False, 4, 128, ()),
              ("whisper tp", "whisper-small", "tp", False, 4, 128, ()),
              ("whisper fsdp", "whisper-small", "fsdp", False, 4, 128, ()),
              ("whisper serve", "whisper-small", "serve", False, 4, 128, ()),
              ("whisper tp fused", "whisper-small", "tp", True, 4, 128, ()),
              ("whisper fsdp fused", "whisper-small", "fsdp", True, 4, 128,
               ()),
              ("llava tp", "llava-next-34b", "tp", False, 2,
               LLAVA_IMAGE + 128, ()),
              ("mixtral fsdp", "mixtral-8x7b", "fsdp", False, 4, 128, ()),
              ("rwkv tp", "rwkv6-1.6b", "tp", False, 4, 128, ()),
              ("mamba serve", "jamba-v0.1-52b", "serve", False, 4, 128,
               MESH_MAMBA_ONLY))
# reduced f32 stacks card against CPU in the same world: (label, arch, mesh
# shape, strategy, batch, config overrides, text tokens). Whisper's and
# LLaVA's take random frames and image rows from a numpy seed (the
# launcher's are zeros, in which a row-slicing fault would not show); fsdp
# at batch 4 puts the rows over (data, model). The 6-head configs take the
# seq plan at 1x4 (4 ranks pad 6 heads to 8, 33% waste;
# tests/test_torch_strategies.py, tests/test_torch_mesh_encdec.py),
# Whisper's over 18 decoder rows and 18 frames, so its last rank holds 3
# of each. Mixtral's 4 experts take the ep plan at 2x2 (fsdp at batch 4:
# the dispatch all-to-all), its 6 experts over 4 ranks the MoE tp plan
# (tests/test_torch_mesh_moe.py). RWKV6's 4 heads over 2 and 4 `model`
# ranks (one head a rank at 1x4), and Jamba in its own 8-block pattern
# (Mamba blocks, an attention block, 4 experts at the MoE positions
# under the ep plan; tests/test_torch_mesh_rwkv.py,
# tests/test_torch_mesh_jamba.py)
MESH_SMALL = (("qwen3-4b 2x2 tp", "qwen3-4b", (2, 2), "tp", 2, {}, 16),
              ("qwen3-4b seq 1x4", "qwen3-4b", (1, 4), "tp", 2,
               {"num_heads": 6, "num_kv_heads": 2}, 16),
              ("whisper 2x2 tp", "whisper-small", (2, 2), "tp", 2, {}, 16),
              ("whisper 2x2 fsdp", "whisper-small", (2, 2), "fsdp", 4, {},
               16),
              ("whisper seq 1x4", "whisper-small", (1, 4), "tp", 2,
               {"num_heads": 6, "num_kv_heads": 6, "encoder_seq": 18}, 18),
              ("llava 2x2 tp", "llava-next-34b", (2, 2), "tp", 2, {}, 16),
              ("llava 2x2 fsdp", "llava-next-34b", (2, 2), "fsdp", 4, {},
               16),
              ("mixtral 2x2 tp", "mixtral-8x7b", (2, 2), "tp", 2, {}, 16),
              ("mixtral 2x2 fsdp", "mixtral-8x7b", (2, 2), "fsdp", 4, {},
               16),
              ("mixtral 2x2 serve", "mixtral-8x7b", (2, 2), "serve", 2, {},
               16),
              ("mixtral 1x4 tp, 6 experts", "mixtral-8x7b", (1, 4), "tp", 2,
               {"num_experts": 6}, 16),
              ("rwkv 2x2 tp", "rwkv6-1.6b", (2, 2), "tp", 2, {}, 16),
              ("rwkv 2x2 fsdp", "rwkv6-1.6b", (2, 2), "fsdp", 4, {}, 16),
              ("rwkv 1x4 tp", "rwkv6-1.6b", (1, 4), "tp", 2, {}, 16),
              ("jamba 2x2 tp", "jamba-v0.1-52b", (2, 2), "tp", 2, {}, 16),
              ("jamba 2x2 fsdp", "jamba-v0.1-52b", (2, 2), "fsdp", 4, {},
               16),
              ("jamba 2x2 serve", "jamba-v0.1-52b", (2, 2), "serve", 2, {},
               16))
# gloo's collectives tried on CUDA tensors in f32: the port's
# (GLOO_CUDA_OPS) are asserted, broadcast recorded. The two that move a
# bf16 lane's tensors as they are (the weight gathers, the MoE's dispatch
# all-to-all; the sums run in f32) are tried in bf16 too, and asserted
GLOO_PROBE_OPS = ("all_reduce", "broadcast", "all_gather", "reduce_scatter",
                  "all_to_all")
GLOO_PROBE_BF16 = ("all_gather", "all_to_all")


def gloo_cuda_probe(rank, world):
    """Each collective straight on CUDA tensors over the world group (the
    ranks sharing the card under gloo): {op: True where it ran and gave
    the right values, else what it raised}; the ops of GLOO_PROBE_BF16
    also on bf16 tensors ("<op> bfloat16"; small integers, exact in
    bf16)."""
    import torch.distributed as dist
    got = {}
    tri = world * (world + 1) / 2

    def calls(dt):
        x = torch.full((4,), float(rank + 1), device="cuda", dtype=dt)
        return {
            "all_reduce": lambda: (dist.all_reduce(y := x.clone()), y)[1],
            "broadcast": lambda: (dist.broadcast(y := x.clone(), 0), y)[1],
            "all_gather": lambda: (dist.all_gather_into_tensor(
                y := torch.empty(4 * world, device="cuda", dtype=dt), x),
                y)[1],
            "reduce_scatter": lambda: (dist.reduce_scatter_tensor(
                y := torch.empty(4, device="cuda", dtype=dt),
                torch.cat([x * (r + 1) for r in range(world)])), y)[1],
            "all_to_all": lambda: (dist.all_to_all_single(
                y := torch.empty(world, device="cuda", dtype=dt),
                torch.arange(world, device="cuda", dtype=dt)
                + 10 * rank), y)[1]}
    want = {"all_reduce": [tri] * 4, "broadcast": [1.0] * 4,
            "all_to_all": [float(10 * r + rank) for r in range(world)],
            "all_gather": [float(r + 1) for r in range(world)
                           for _ in range(4)],
            "reduce_scatter": [tri * (rank + 1)] * 4}
    tries = [(op, op, torch.float32) for op in GLOO_PROBE_OPS] + [
        (f"{op} bfloat16", op, torch.bfloat16) for op in GLOO_PROBE_BF16]
    for key, op, dt in tries:
        try:
            y = calls(dt)[op]()
            got[key] = y.dtype == dt and y.float().cpu().tolist() == want[op]
        except Exception as e:          # recorded: what this build refuses
            got[key] = f"{type(e).__name__}: {str(e)[:120]}"
    return got


def check_gloo_probe(got):
    """Which collectives this build's gloo runs on CUDA tensors (the 2x2
    phase's ranks, sharing the card): the ones the port calls on them
    (sharding/collectives.py::GLOO_CUDA_OPS) must run and give the right
    values, since the port sends them straight to gloo."""
    from repro_torch.sharding import collectives
    print(f"gloo on CUDA tensors, this build (torch {torch.__version__}): "
          f"{got}; the port calls {list(collectives.GLOO_CUDA_OPS)} on them,"
          f" {list(GLOO_PROBE_BF16)} also on bf16 ones (all_to_all: the "
          "MoE's dispatch under the ep plan)")
    for op in list(collectives.GLOO_CUDA_OPS) + [
            f"{op} bfloat16" for op in GLOO_PROBE_BF16]:
        if got.get(op) is not True:
            raise AssertionError(f"gloo's {op} on CUDA tensors: {got.get(op)}")


RWKV_BLOCK_LEAVES = 21          # models/ssm.py::init_rwkv_block
MAMBA_BLOCK_LEAVES = 13         # models/ssm.py::init_mamba_block


def mesh_per_step(cfg, fused=False):
    """Launches a rank makes a step (elastic_zo, 1 probe, a BP tail of one
    layer), from the config: 1 zo_fused_replay a ZO leaf (every rank
    holds a shard of each): the leaves outside periods_zo (embed, and
    pos_embed and the encoder's 2 + its block's leaves where the stack
    has them) and each pattern position's block leaves by kind (an
    attention block's, with cross-attention's 5 in Whisper; an RWKV6
    block's 21; a Mamba block's 13; after an attention or Mamba block
    ln_ffn and the MLP's 3 or a MoE FFN's router and 3 expert leaves);
    zo_perturb 2 a ZO leaf unfused, and fused 2 a leaf outside
    periods_zo and 2 a block's leaf a ZO period (one period's slice at a
    time); flash 2 a forward's attention calls without a gradient: each
    ZO period's self-attention (and cross-attention) blocks and each
    encoder block, in every strategy."""
    from repro_torch.configs import LaneConfig
    from repro_torch.configs.base import ATTN, MAMBA, RWKV
    from repro_torch.core.api import tail_periods
    from repro_torch.models.transformer import _ffn_is_moe
    zo_periods = cfg.num_periods - tail_periods(cfg, LaneConfig(
        bp_tail_layers=1))
    attn = 5 + 2 * cfg.qk_norm          # ln_attn, wq/wk/wv/wo, q/k norms
    cross = bool(cfg.encoder_layers)
    block = attn_blocks = 0
    for pos, kind in enumerate(cfg.pattern):
        if kind == RWKV:
            block += RWKV_BLOCK_LEAVES
            continue
        block += 5 if _ffn_is_moe(cfg, pos) else 4    # ln_ffn and the FFN
        if kind == MAMBA:
            block += MAMBA_BLOCK_LEAVES
        elif kind == ATTN:
            block += attn + cross * attn
            attn_blocks += 1
    encoder = 2 + attn + 4 if cross else 0
    whole = 1 + (cfg.rope_theta <= 0) + encoder
    perturb = 2 * whole + 2 * block * zo_periods if fused \
        else 2 * (whole + block)
    return {"zo_perturb": perturb, "zo_fused_replay": whole + block,
            "flash_attention": 2 * (zo_periods * attn_blocks * (1 + cross)
                                    + cfg.encoder_layers)}


def _mesh_noise(trainer, zo_perturb, zo_replay):
    """Every ZO leaf's shard perturbed and updated at its index map, and
    each period's slice of a stacked leaf's shard perturbed at its
    ``MeshRun.period_maps`` map (the fused pair's shard form) and, where
    ``MeshRun.weights`` gathers it, the gathered slice at its map
    (``period_maps(..., gathered=True)``: an expert leaf's block of
    experts under the ep plan), against the one-device kernels on a whole
    leaf sliced (a leaf of the global shape holding the shard at its
    place: the elements elsewhere do not reach the slice); returns the
    number of (leaf or slice) maps held."""
    from repro_torch.core import elastic, zo
    from repro_torch.sharding.params import kept_desc, period_map
    run = trainer.run
    zo_part, _ = elastic.partition(trainer.state.params, trainer.lane)
    seeds = zo.device_seeds([977, 1301], trainer.device)
    coeffs = torch.tensor([[1e-3, -2e-3]], device=trainer.device)
    n = 0
    for path, leaf in zo.leaves_with_path(zo_part):
        salt = zo.path_salt(path)
        d = run.desc_of(path, run.rank)
        whole = torch.zeros(d.global_shape, dtype=leaf.dtype,
                            device=leaf.device)
        whole[d.slices] = leaf
        pert = zo_perturb.zo_perturb(whole, seeds[:1], salt, 1e-3)
        ok = torch.equal(zo_perturb.zo_perturb(leaf, seeds[:1], salt, 1e-3,
                                               index=d.index),
                         pert[d.slices])
        ok &= torch.equal(
            zo_replay.zo_fused_replay(leaf, seeds.reshape(1, 2), coeffs,
                                      salt, index=d.index),
            zo_replay.zo_fused_replay(whole, seeds.reshape(1, 2), coeffs,
                                      salt)[d.slices])
        n += 1
        if path[0] == "periods_zo":
            kd = kept_desc(d, run.kept_axes(path))
            for p in range(leaf.shape[0]):
                ok &= torch.equal(
                    zo_perturb.zo_perturb(leaf[p], seeds[:1], salt, 1e-3,
                                          index=period_map(d, p)),
                    pert[p][d.slices[1:]])
                n += 1
                if kd.local_shape != d.local_shape:
                    ok &= torch.equal(
                        zo_perturb.zo_perturb(
                            whole[p][kd.slices[1:]].contiguous(), seeds[:1],
                            salt, 1e-3, index=period_map(kd, p)),
                        pert[p][kd.slices[1:]])
                    n += 1
        del whole, pert
        if not ok:
            raise AssertionError(f"rank {run.rank}: {zo.keystr(path)}'s "
                                 "shard noise is not the whole leaf's sliced")
    return n


def mesh_train(trainer, steps, counter=None):
    """``steps`` (at least 2) steps of a trainer through train_loop.run
    fed by the launcher's Prefetcher: the first untimed (it pays the
    process's and the shapes' one-time costs), the later ones timed, and
    recorded into ``counter`` (a ``kernels/cost.py::CostCounter``) when
    one is given. Returns (losses, ms a step (the mean of the later
    steps), device peak of the later steps, launch counts of all
    steps)."""
    from repro_torch.kernels import cost
    from repro_torch.kernels import flash_attn, zo_fused_replay, zo_perturb
    from repro_torch.launch.train import prefetched
    from repro_torch.train.train_loop import LoopConfig, run

    def loop(total):
        return LoopConfig.for_lane(trainer.lane, total_steps=total,
                                   log_every=1)
    if steps < 2:
        raise ValueError("mesh_train times the steps after the first")
    zo_perturb.launches = zo_fused_replay.launches = flash_attn.launches = 0
    with prefetched(trainer) as batch_fn:
        state, h0 = run(trainer.step_fn, trainer.state, batch_fn, loop(1),
                        log=None, param_shardings=trainer.run)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with (cost.counting(counter) if counter is not None
              else contextlib.nullcontext()):
            state, h1 = run(trainer.step_fn, state, batch_fn, loop(steps),
                            log=None, param_shardings=trainer.run)
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / (steps - 1)
    trainer.state = state
    counts = {"zo_perturb": zo_perturb.launches,
              "zo_fused_replay": zo_fused_replay.launches,
              "flash_attention": flash_attn.launches}
    return ([loss for _, loss in h0 + h1], ms,
            torch.cuda.max_memory_allocated(), counts)


def leaf_moves(params, init, run=None):
    """{keystr: the summed |theta - theta_init| of the leaf} (f64), over
    the global leaf: on a mesh (``run``) every rank's sum over its shard,
    the copies of a shard counted once. ``init``: the leaves' copies in
    ``zo.leaves`` order before the steps (they update in place)."""
    from repro_torch.core import zo
    paths = [p for p, _ in zo.leaves_with_path(params)]
    local = [float((t.float() - t0.float()).abs().sum(dtype=torch.float64))
             for t, t0 in zip(zo.leaves(params), init)]
    if run is None:
        return {zo.keystr(p): s for p, s in zip(paths, local)}
    import torch.distributed as dist
    every = [None] * run.world
    dist.all_gather_object(every, local)
    out = {}
    for i, p in enumerate(paths):
        held = {run.desc_of(p, r).starts: every[r][i]
                for r in range(run.world)}
        out[zo.keystr(p)] = sum(held.values())
    return out


def mesh_cfg(arch, overrides=()):
    """The stack a mesh lane of ``arch`` trains, at full width, with the
    lane's ``overrides`` of its config: qwen3-4b cut to MESH_LAYERS,
    whisper-small to MESH_WHISPER_LAYERS (decoder and encoder),
    llava-next-34b to MESH_LLAVA_LAYERS, mixtral-8x7b to MESH_MOE_LAYERS,
    rwkv6-1.6b to MESH_RWKV_LAYERS, jamba-v0.1-52b to MESH_MAMBA_LAYERS;
    in MESH_DTYPES' dtype where it names one."""
    from repro_torch.configs import ARCHS
    cut = {"qwen3-4b": MESH_LAYERS, "whisper-small": MESH_WHISPER_LAYERS,
           "llava-next-34b": MESH_LLAVA_LAYERS,
           "mixtral-8x7b": MESH_MOE_LAYERS, "rwkv6-1.6b": MESH_RWKV_LAYERS,
           "jamba-v0.1-52b": MESH_MAMBA_LAYERS}[arch]
    cfg = dataclasses.replace(ARCHS[arch], **dict(overrides))
    cfg = dataclasses.replace(cfg, dtype=MESH_DTYPES.get(arch, cfg.dtype),
                              num_layers=cut)
    if cfg.encoder_layers:
        cfg = dataclasses.replace(cfg, encoder_layers=cut)
    return cfg


def mesh_title(arch, overrides=()):
    """``arch``, its cut and the lane's ``overrides``, as the mesh phase
    prints them."""
    from repro_torch.configs import ARCHS
    cfg = mesh_cfg(arch, overrides)
    n, full = cfg.num_layers, ARCHS[arch].num_layers
    both = " decoder and encoder" if cfg.encoder_layers else ""
    cut = "" if n == full else f"{n} of {full}{both} layers, "
    over = "".join(f", {k} {v}" for k, v in overrides)
    return f"{arch} ({cut}{cfg.dtype}{over})"


def mesh_argv(arch, batch, seq):
    """The launcher's flags for ``arch`` at ``batch`` x ``seq`` for
    MESH_STEPS steps (TRAIN_ARGV's lane and rates)."""
    return family_argv(arch, batch, seq, MESH_STEPS)


def small_mesh_batches(cfg, batch, seq, rows):
    """step -> the rank's ``rows`` of the global batch of the launcher's
    token stream (seed 1), with random frames and image rows from a
    numpy seed in place of its zeros."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import lm_batch_fn
    whole = lm_batch_fn(cfg, ShapeConfig("train", seq_len=seq,
                                         global_batch=batch, kind="train"),
                        seed=1)

    def fn(step):
        b = whole(step)
        rng = np.random.default_rng(1000 + step)
        for k in ("frames", "img"):
            if k in b:
                b[k] = rng.standard_normal(b[k].shape).astype(np.float32)
        return {k: np.ascontiguousarray(v[rows]) for k, v in b.items()}
    return fn


def ulp_moved(params, pattern):
    """``params`` with every element moved one ulp up or down (the sign
    drawn from ``pattern``): the smallest change of the step's input."""
    from repro_torch.core import zo
    gen = torch.Generator().manual_seed(pattern)

    def f(_p, t):
        sign = torch.randint(0, 2, t.shape, generator=gen).to(t) * 2 - 1
        return torch.nextafter(t, t + sign * math.inf)
    return zo.map_with_path(f, params)


def _mesh_small(mesh, spec, lanes=("elastic_zo", "full_bp")):
    """The reduced f32 stack of ``spec`` (a MESH_SMALL entry), 2 steps of
    each of ``lanes`` on this mesh in the spec's strategy: the card's own
    run from the CPU init's shards (the two devices' generators draw
    apart), each of its steps held against the CPU's step from the same
    shards (the card's state before that step) and the same batch
    (``small_mesh_batches``), so that a step's rounding does not enter
    the next comparison through the ZO coefficients (a loss 2 ulps apart
    moved reduced Mixtral's leaves 1.4e-4 apart a step later, PERF.md
    §6). In MESH_SMALL_ILL's lane of its stack, each step's floor too:
    the CPU's step from that state with every element moved one ulp (two
    sign patterns), its largest distance from the CPU's step. Returns
    ({lane: (worst relative loss distance, worst relative param
    distance)} over the steps, the rules' attention plan, their MoE
    plan, the largest floor or None)."""
    from repro_torch.configs import ARCHS, ShapeConfig, reduced
    from repro_torch.core import zo
    from repro_torch.core.elastic import TrainState
    from repro_torch.data.pipeline import device_put_batch, rank_rows
    from repro_torch.launch import train as launch_train
    from repro_torch.train.train_loop import LoopConfig, run
    label, arch, _, strategy, batch, overrides, text = spec
    cfg = reduced(ARCHS[arch], dtype="float32", **overrides)
    seq = text + cfg.num_image_tokens
    out, floor = {}, None
    for lane in lanes:
        ts = {dev: launch_train.setup(launch_train.parse_args(
            ["--arch", arch, "--device", dev, "--lane", lane, "--batch",
             str(batch), "--seq", str(seq), "--steps", "2"]),
            cfg=cfg, mesh=mesh, strategy=strategy) for dev in ("cpu", "cuda")}
        run_ = ts["cpu"].run
        plan = run_.rules.attn.kind, run_.rules.moe
        host = small_mesh_batches(cfg, batch, seq, rank_rows(
            ShapeConfig("train", seq_len=seq, global_batch=batch,
                        kind="train"), run_.rules, run_.coords))
        seed = ts["cpu"].state.seed

        def step_on(dev, params, step):
            """(state, loss, gathered leaves) after one step on ``dev``
            from ``params``."""
            t = ts[dev]
            state, hist = run(t.step_fn, TrainState(params, step, seed),
                              lambda k: device_put_batch(host(k), t.device,
                                                         t.dtypes),
                              LoopConfig.for_lane(t.lane,
                                                  total_steps=step + 1,
                                                  log_every=1),
                              log=None, param_shardings=t.run)
            return state, hist[-1][1], [t.run.gather_leaf(p, leaf).cpu()
                                        for p, leaf in
                                        zo.leaves_with_path(state.params)]

        def distance(pa, pb):
            return max(float((a - b).abs().max() / max(float(b.abs().max()),
                                                       1.0))
                       for a, b in zip(pa, pb) if b.numel())
        card = zo.map_with_path(                 # the CPU's draws
            lambda p, x: x.clone().to("cuda"), ts["cpu"].state.params)
        dist_loss = dist_param = 0.0
        for step in range(2):
            # the card's state before this step, for the CPU (the card's
            # step updates its ZO leaves in place)
            before = zo.map_with_path(lambda p, x: x.cpu().clone(), card)
            state, lc, pc = step_on("cuda", card, step)
            card = state.params
            _, lh, ph = step_on("cpu", zo.map_with_path(
                lambda p, x: x.clone(), before), step)
            dist_loss = max(dist_loss, abs(lc - lh) / max(abs(lh), 1.0))
            dist_param = max(dist_param, distance(pc, ph))
            if (label, lane) == MESH_SMALL_ILL[:2]:
                floor = max([floor or 0.0] + [distance(step_on(
                    "cpu", ulp_moved(before, pattern), step)[2], ph)
                    for pattern in (1, 2)])
        out[lane] = (dist_loss, dist_param)
    return (out,) + plan + (floor,)


def _mesh_lane(mesh, lane_spec, zo_perturb, zo_replay, noise):
    """One lane of the mesh phase on this rank: the trainer from
    ``launch.train.setup`` for the lane's arch (``mesh_cfg``) in its
    strategy (the fused-probe lane through the lane override), the shard
    noise of every ZO leaf (``noise``), MESH_STEPS steps, the first
    untimed (the engine asserts each step's coefficients bitwise across
    ranks) with the first step's probe losses, each leaf's move over
    them, the calls of the MoE's dispatch all-to-all in them
    (``collectives.all_to_all``; its backward is the reverse one inside
    autograd, not counted), and the replicated leaves bitwise across
    ranks after them."""
    from repro_torch.core import zo
    from repro_torch.launch import train as launch_train
    from repro_torch.sharding import collectives
    label, arch, strategy, fused, batch, seq, overrides = lane_spec
    args = launch_train.parse_args(mesh_argv(arch, batch, seq))
    lane = dataclasses.replace(launch_train.lane_from_args(args),
                               fused_probes=fused)
    t0 = time.perf_counter()
    start = t0
    trainer = launch_train.setup(args, lane, cfg=mesh_cfg(arch, overrides),
                                 mesh=mesh, strategy=strategy)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    held = _mesh_noise(trainer, zo_perturb, zo_replay) if noise else 0
    torch.cuda.empty_cache()
    init = [t.detach().clone() for t in zo.leaves(trainer.state.params)]
    a2a, calls = collectives.all_to_all, [0]

    def counted(*a, **k):
        calls[0] += 1
        return a2a(*a, **k)
    collectives.all_to_all = counted
    from repro_torch.kernels import cost
    counter = cost.CostCounter() if label == COST_LANE else None
    try:
        with probe_losses() as seen:
            losses, ms, peak, counts = mesh_train(trainer, MESH_STEPS,
                                                  counter)
    finally:
        collectives.all_to_all = a2a
    moved = leaf_moves(trainer.state.params, init, trainer.run)
    del init
    res = dict(setup_s=setup_s, noise_maps=held, losses=losses, ms=ms,
               peak=peak, counts=counts, moved=moved, all_to_all=calls[0],
               pair=[float(x) for x in seen[:2]],
               replica_pairs=trainer.run.check_replicas(trainer.state.params),
               attn=trainer.run.rules.attn.kind, moe=trainer.run.rules.moe,
               batch_axes=list(trainer.run.batch_axes),
               records=None if counter is None else [
                   record_key(r) for r in counter.collectives],
               cost_launches=None if counter is None
               else counter.launch_counts(),
               shard_bytes=sum(t.numel() * t.element_size()
                               for t in _leaves(trainer.state.params)))
    del trainer
    torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - start
    return res


def _mesh_rank(rank, world, shape, backend, store, out_dir, lanes, small,
               serve=()):
    """One rank of the mesh phase on ``shape``, through the launcher's
    setup: each lane of ``lanes`` (``_mesh_lane``) in turn, the shard
    noise held in each arch's unfused lanes at its first lane's shape;
    then each serve lane of ``serve`` ((SERVE_MESH_LANES entry, one
    device's reference file) pairs, ``_serve_lane``); then each reduced
    stack of ``small`` (MESH_SMALL entries) card against CPU on its mesh
    of the same world. Writes its numbers to out_dir."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import zo_fused_replay, zo_perturb
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.init_ranks(backend, "cuda", rank, world, store)
    try:
        probe = gloo_cuda_probe(rank, world) if backend == "gloo" else None
        meshes = {tuple(shape): mesh_lib.make_mesh(shape, MESH_AXES)}
        res = dict(rank=rank, probe=probe,
                   device=str(torch.device("cuda",
                                           torch.cuda.current_device())),
                   lanes={}, small={}, serve={})
        first = {}
        for spec in lanes:
            first.setdefault(spec[1], spec[4:])
            res["lanes"][spec[0]] = _mesh_lane(
                meshes[tuple(shape)], spec, zo_perturb, zo_fused_replay,
                noise=not spec[3] and spec[4:] == first[spec[1]])
        for spec, ref_path in serve:
            res["serve"][spec[0]] = _serve_lane(meshes[tuple(shape)], spec,
                                                ref_path)
        t0 = time.perf_counter()
        for spec in small:
            if spec[2] not in meshes:
                meshes[spec[2]] = mesh_lib.make_mesh(spec[2], MESH_AXES)
            res["small"][spec[0]] = _mesh_small(meshes[spec[2]], spec)
        res["small_s"] = time.perf_counter() - t0
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def check_mesh(shape, backend, want_losses, want_moves, small=MESH_SMALL,
               lanes=MESH_LANES, serve_refs=None):
    """The mesh phase on ``prod(shape)`` spawned ranks, one spawn for all
    of ``lanes``: prints each rank's numbers per lane and asserts the
    launches a step (``mesh_per_step`` of the lane's stack), equal counts
    and losses on every rank, the losses within MESH_LOSS_RTOL of one
    device's at the lane's stack and shape (``want_losses``: {(arch,
    batch, seq, overrides): losses}), each leaf's move within
    MESH_MOVE_RTOL of one device's (``want_moves``: {(arch, batch, seq,
    overrides): leaf_moves}), the
    fused lanes' first (l+, l-) bitwise the unfused lane's at the same
    stack, shape and strategy, and the reduced stacks of ``small``
    (MESH_SMALL entries) card == CPU, the 6-head ones under the seq plan;
    with ``serve_refs`` ({batch: one device's reference file},
    ``serve_references``) the serve lanes of SERVE_MESH_LANES too
    (``check_serve_mesh``). Returns ({lane label: rank 0's launch
    counts}, {serve lane: rank 0's flash launches})."""
    import tempfile
    from repro_torch.launch import mesh as mesh_lib
    world = math.prod(shape)
    d = tempfile.mkdtemp(prefix="mesh_smoke_")
    t0 = time.perf_counter()
    try:
        store = "file://" + os.path.join(d, "store")
        serve = tuple((spec, serve_refs[spec[2]])
                      for spec in SERVE_MESH_LANES) if serve_refs else ()
        mesh_lib.spawn(_mesh_rank, world, (world, shape, backend, store, d,
                                           lanes, small, serve))
        res = [json.loads(Path(d, f"rank{r}.json").read_text())
               for r in range(world)]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    wall = time.perf_counter() - t0
    if backend == "gloo":
        check_gloo_probe(res[0]["probe"])
    name = "x".join(map(str, shape))
    worst = {}
    steps = MESH_STEPS
    for label, arch, strategy, fused, batch, seq, overrides in lanes:
        cfg = mesh_cfg(arch, overrides)
        per_step = mesh_per_step(cfg, fused)
        for r in res:
            x = r["lanes"][label]
            # the dispatch and its return, each ZO forward's MoE layers
            a2a = 2 * 2 * cfg.num_layers * steps if cfg.is_moe \
                and "model" in x["batch_axes"] else 0
            moe = f", MoE plan {x['moe']}, {x['all_to_all']} dispatch " \
                f"all-to-alls (want {a2a})" if cfg.is_moe else ""
            print(f"{name} {label} ({mesh_title(arch, overrides)} at {batch} x"
                  f" {seq}, "
                  f"{strategy}, attention plan {x['attn']}{moe}, batch over "
                  f"{x['batch_axes']}) over {backend}, rank "
                  f"{r['rank']} on {r['device']}: setup {x['setup_s']:.2f} s "
                  f"({x['shard_bytes']} bytes of shards); "
                  f"{x['noise_maps']} shard and period-slice noise maps "
                  f"bitwise the whole leaf's sliced; losses "
                  f"{[round(v, 5) for v in x['losses']]}, first (l+, l-) "
                  f"{x['pair']}; {x['ms']:.1f} ms a "
                  f"step after an untimed one; device peak {x['peak']} bytes"
                  f" (the timed step); launches "
                  f"{x['counts']} in {steps} steps; {x['replica_pairs']} "
                  "replicated (leaf, rank) pairs bitwise; coefficients "
                  "bitwise across ranks every step (asserted in the step); "
                  f"the lane {x['wall_s']:.1f} s wall")
            if x["counts"] != {k: v * steps for k, v in per_step.items()}:
                raise AssertionError(f"rank {r['rank']} {label}: launches "
                                     f"{x['counts']}, want {per_step} a step")
            if x["all_to_all"] != a2a or (cfg.is_moe and x["moe"] != "ep"):
                raise AssertionError(f"rank {r['rank']} {label}: MoE plan "
                                     f"{x['moe']}, {x['all_to_all']} "
                                     f"all-to-alls, want ep and {a2a}")
            if x["losses"] != res[0]["lanes"][label]["losses"]:
                raise AssertionError(f"{label}: the ranks' losses differ")
        x = res[0]["lanes"][label]
        want = want_losses[(arch, batch, seq, overrides)]
        worst[label] = max(abs(a - b) / abs(b)
                           for a, b in zip(x["losses"], want))
        print(f"{name} {label}: losses against one device's of the same cut "
              f"and shape {[round(v, 5) for v in want]}: worst relative "
              f"distance {worst[label]:.3g} (tolerance {MESH_LOSS_RTOL})")
        ref_moves = want_moves[(arch, batch, seq, overrides)]
        far = max(abs(x["moved"][k] - v) / max(v, 1e-30)
                  for k, v in ref_moves.items())
        print(f"{name} {label}: each leaf's summed |change| in {steps} "
              f"step(s) against one device's: worst relative distance "
              f"{far:.3g} (tolerance {MESH_MOVE_RTOL}; {len(ref_moves)} "
              "leaves)")
        if far > MESH_MOVE_RTOL:
            raise AssertionError(f"{label}: the leaves moved otherwise than "
                                 "one device's")
        if fused:
            plain = next(spec[0] for spec in lanes if not spec[3] and (
                spec[1:3] + spec[4:] == (arch, strategy, batch, seq,
                                         overrides)))
            y = res[0]["lanes"][plain]
            print(f"{name} {label}: first (l+, l-) {x['pair']}, the unfused "
                  f"lane's {y['pair']} (bitwise: {x['pair'] == y['pair']}); "
                  f"device peak {x['peak']} bytes, the unfused lane's "
                  f"{y['peak']} at the same shape")
            if x["pair"] != y["pair"]:
                raise AssertionError(f"{label}: the fused pair is not the "
                                     "unfused one")
    check_mesh_records(res, lanes, name, tuple(shape))
    served = check_serve_mesh(res, name, tuple(shape)) if serve_refs else {}
    bad = []                    # every reduced stack printed, then raised
    for label, arch, _, strategy, _, overrides, _ in small:
        for r in res:
            got, plan, moe, floor = r["small"][label]
            ill = MESH_SMALL_ILL[1] if label == MESH_SMALL_ILL[0] else None
            print(f"  rank {r['rank']}: reduced f32 {label} ({strategy}, "
                  f"attention plan {plan}, MoE plan {moe}), card against CPU"
                  f" (worst relative loss, param distance): {got}" + (
                      f"; the {ill} step's floor {floor} (its bound "
                      f"{MESH_SMALL_ILL[2]})" if ill else ""))
            if (plan == "seq") != (overrides.get("num_heads") == 6):
                bad.append(f"reduced {label}: attention plan {plan}")
            if arch in ("mixtral-8x7b", "jamba-v0.1-52b") and moe != (
                    "tp" if "num_experts" in overrides else "ep"):
                bad.append(f"reduced {label}: MoE plan {moe}")
            if any(loss > MESH_SMALL_TOL or param > (
                    MESH_SMALL_ILL[2] if lane == ill else MESH_SMALL_TOL)
                   for lane, (loss, param) in got.items()):
                bad.append(f"reduced {label} on the mesh, rank {r['rank']}:"
                           " card and CPU differ")
            if ill and not floor > MESH_SMALL_TOL:
                bad.append(f"reduced {label}: the {ill} step's floor {floor}"
                           f" is within {MESH_SMALL_TOL}, so its bound "
                           f"{MESH_SMALL_ILL[2]} is not")
    if bad:
        raise AssertionError("; ".join(bad))
    print(f"{name}: the phase took {wall:.1f} s with the ranks' start (the "
          f"reduced stacks {res[0].get('small_s', 0.0):.1f} s on rank 0); "
          f"worst relative loss distance over the lanes "
          f"{max(worst.values()):.3g}")
    if max(worst.values()) > MESH_LOSS_RTOL:
        raise AssertionError("the sharded losses left one device's")
    return ({label: res[0]["lanes"][label]["counts"] for label, *_ in lanes},
            served)


COST_LANE = "tp"                 # the mesh lane held to its dry run (c)


def check_mesh_records(res, lanes, name, shape):
    """(c) Each rank's collective records of the COST_LANE lane's timed
    step against a dry run of the same config, shape and lane on a fake
    world of the mesh (rank 0's records; the ranks' groups differ, not
    their kinds, sizes and bytes), in order, and its kernel launches."""
    from repro_torch.launch import train as launch_train
    spec = next((x for x in lanes if x[0] == COST_LANE), None)
    if spec is None:
        return
    label, arch, strategy, fused, batch, seq, overrides = spec
    args = launch_train.parse_args(mesh_argv(arch, batch, seq))
    lane = dataclasses.replace(launch_train.lane_from_args(args),
                               fused_probes=fused)
    t0 = time.perf_counter()
    want, launches = dry_mesh_records(arch, overrides, strategy, batch, seq,
                                      shape, lane)
    kinds = {}
    for r in want:
        kinds[r[0]] = kinds.get(r[0], 0) + 1
    for r in res:
        got = r["lanes"][label]["records"]
        same = got == want
        print(f"cost model, {name} {label} ({mesh_title(arch, overrides)}): "
              f"rank {r['rank']}'s {len(got)} collective records of the "
              f"timed step equal the dry run's {len(want)} ({kinds}; dry run "
              f"{time.perf_counter() - t0:.1f} s) in order: {same}; launches "
              f"{r['lanes'][label]['cost_launches']}, the dry run's "
              f"{launches}")
        if not same or r["lanes"][label]["cost_launches"] != launches:
            first = next((i for i, (a, b) in enumerate(zip(got, want))
                          if a != b), min(len(got), len(want)))
            raise AssertionError(
                f"{label}: rank {r['rank']}'s collectives differ from the dry "
                f"run's at record {first}: {got[first:first + 3]} against "
                f"{want[first:first + 3]}")


# --------------------------------------------------------------------- #
# serving across a mesh: prefill_step / decode_step with a MeshRun
# --------------------------------------------------------------------- #
SERVE_MESH_ROWS = 2              # prompts of the serve lanes
SERVE_MESH_PROMPT = 512          # tokens a prompt
SERVE_MESH_STEPS = 16            # greedy decode steps after the prefill
# (label, strategy, global batch): qwen3-4b cut to MESH_LAYERS at full
# width, bf16, on the mesh phase's 2x2 world. tp: KV heads over `model`
# (its weights' FSDP shards gathered over `data` each step); serve: the
# decode cache context-sharded over `model` (the seq plan at decode,
# weights replicated over `data`); context: a global batch of 1 below the
# 2 `data` ranks, the decode cache's slots over `data` (cache_seq_axes)
SERVE_MESH_LANES = (("serve tp", "tp", 2), ("serve seq", "serve", 2),
                    ("serve context", "serve", 1))
SERVE_TOKEN_TOL = 2.0**-7        # a greedy token other than one device's
#                                  only where one device's logits of the
#                                  two lie within two bf16 ulps of the
#                                  row's largest |logit| (a near tie the
#                                  row-parallel and combine sums, rounded
#                                  in another order, may flip)
SERVE_CACHE_TOL = 5e-2           # each cache leaf after the last step,
#                                  gathered, against one device's: the
#                                  largest |difference| over the leaf's
#                                  largest |value| (bf16 K / V of 528
#                                  positions through 4 layers whose sums
#                                  round in other orders)


def serve_mesh_shapes(B):
    """(prefill shape, decode shape) of a serve lane of B rows."""
    from repro_torch.configs import ShapeConfig
    total = SERVE_MESH_PROMPT + SERVE_MESH_STEPS
    return (ShapeConfig("p", seq_len=SERVE_MESH_PROMPT, global_batch=B,
                        kind="prefill"),
            ShapeConfig("d", seq_len=total, global_batch=B, kind="decode"))


def serve_references(out_dir):
    """One device's greedy run of each batch of SERVE_MESH_LANES on the
    card: the prompts (a numpy seed), the prefill and SERVE_MESH_STEPS
    decode steps, each feeding the last token, with their logits and
    the caches after the last step; saved to ``out_dir``/serve_ref_B<B>.pt
    for the ranks. Returns {B: path}."""
    from repro_torch.configs import LaneConfig
    from repro_torch.core import api
    from repro_torch.serve.kv_pages import grow_dense_caches
    cfg = mesh_cfg("qwen3-4b")
    rng = np.random.default_rng(11)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SERVE_MESH_ROWS, SERVE_MESH_PROMPT)).astype(
            np.int32))
    sp, sd = serve_mesh_shapes(SERVE_MESH_ROWS)
    params = api.init(cfg, LaneConfig(), seed=0, device="cuda",
                      max_seq=sd.seq_len)
    paths = {}
    for B in sorted({b for *_, b in SERVE_MESH_LANES}):
        tok, caches, lg = api.prefill_step(params, cfg,
                                           prompts[:B].to("cuda"),
                                           logits=True)
        caches = grow_dense_caches(caches, cfg, sd.seq_len)
        toks, logits = [tok], [lg[:, 0]]
        for i in range(SERVE_MESH_STEPS):
            tok, caches, lg = api.decode_step(params, cfg, toks[-1], caches,
                                              SERVE_MESH_PROMPT + i,
                                              logits=True)
            toks.append(tok)
            logits.append(lg[:, 0])
        paths[B] = os.path.join(out_dir, f"serve_ref_B{B}.pt")
        torch.save({"prompts": prompts[:B],
                    "tokens": torch.cat(toks, dim=1).cpu(),
                    "logits": torch.stack(logits).cpu(),
                    "caches": {f"{part}/{j}/{k}": t.cpu()
                               for part, es in caches.items()
                               for j, e in enumerate(es)
                               for k, t in e.items()}}, paths[B])
        del caches, toks, logits
    del params
    torch.cuda.empty_cache()
    return paths


def _serve_lane(mesh, spec, ref_path):
    """One serve lane on this rank: qwen3-4b (``mesh_cfg``) prefilled on
    the rank's rows of one device's prompts at the prefill shape's rules
    (``api.mesh_run``; once untimed with its collectives recorded,
    once timed), its caches re-laid for the decode shape's rules
    (gathered, grown, sharded), then SERVE_MESH_STEPS decode steps fed
    one device's tokens (the first with its collectives recorded, the
    rest timed). Returns the rank's tokens beside one device's, the
    near ties it took otherwise, the caches' distance from one device's
    after the last step (rank 0), its times, records and flash
    launches."""
    import torch.nn.functional as F
    from repro_torch.configs import LaneConfig
    from repro_torch.core import api
    from repro_torch.data.pipeline import rank_rows
    from repro_torch.kernels import cost, flash_attn
    from repro_torch.models.transformer import tree_map
    from repro_torch.sharding.params import map_with_names, shard_leaf
    label, strategy, B = spec
    cfg, lane = mesh_cfg("qwen3-4b"), LaneConfig()
    sp, sd = serve_mesh_shapes(B)
    ref = torch.load(ref_path)
    dev = torch.device("cuda", torch.cuda.current_device())
    t_lane = time.perf_counter()
    rp = api.mesh_run(cfg, sp, lane, mesh, strategy)
    rd = api.mesh_run(cfg, sd, lane, mesh, strategy)
    flash0 = flash_attn.launches
    params = api.init(cfg, lane, seed=0, device=dev, max_seq=sd.seq_len,
                      run=rp)
    rows = rank_rows(sp, rp.rules, rp.coords)
    prompts = ref["prompts"][rows].to(dev)
    with cost.counting() as counter:
        api.prefill_step(params, cfg, prompts, run=rp)
    pre_records = [record_key(r) for r in counter.collectives]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok, caches = api.prefill_step(params, cfg, prompts, run=rp)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    got = {0: tok[:, 0].cpu()}

    def descs_of(run, shape):
        a = api.abstract_caches(cfg, shape, lane, run)
        return a, [run.cache_descs(a, r) for r in range(run.world)]
    _, dps = descs_of(rp, sp)
    whole = tree_map(lambda t, *ds: rp.gather_shards(t, list(ds)), caches,
                     *dps)
    del caches
    slots = rd.decode_slots()
    dup = [r.rules.attn.kv_dup if r.rules.attn.kind == "tp" else 1
           for r in (rp, rd)]
    idx = [(j // dup[1]) * dup[0] for j in range(cfg.num_kv_heads * dup[1])]

    def relay(names, t):
        if names[-1] in ("k", "v"):
            t = t[..., idx, :]
            t = F.pad(t, (0, 0, 0, 0, 0, slots - t.shape[2]))
        return t
    whole = map_with_names(relay, whole)
    _, dds = descs_of(rd, sd)
    caches = tree_map(lambda t, d: shard_leaf(t, d).clone(), whole,
                      dds[rd.rank])
    del whole
    if rd.specs != rp.specs:            # the seq plan's weights at decode
        del params
        params = api.init(cfg, lane, seed=0, device=dev, max_seq=sd.seq_len,
                          run=rd)
    rows_d = rank_rows(sd, rd.rules, rd.coords)
    feed = ref["tokens"][rows_d].to(dev)
    dec_records, times = None, []
    for i in range(SERVE_MESH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with cost.counting() as counter:
            tok, caches = api.decode_step(params, cfg, feed[:, i:i + 1],
                                          caches, SERVE_MESH_PROMPT + i,
                                          run=rd)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if dec_records is None:
            dec_records = [record_key(r) for r in counter.collectives]
        got[i + 1] = tok[:, 0].cpu()
    flash = flash_attn.launches - flash0
    ties, wrong = [], 0
    for step, t in got.items():
        r_rows = rows if step == 0 else rows_d
        for i, (a, b) in enumerate(zip(t.tolist(),
                                       ref["tokens"][r_rows, step].tolist())):
            if a == b:
                continue
            lg = ref["logits"][step, r_rows.start + i]
            gap = float(lg[b] - lg[a]) / float(lg.abs().max())
            ties.append([step, r_rows.start + i, a, b, gap])
            wrong += gap > SERVE_TOKEN_TOL
    final = tree_map(lambda t, *ds: rd.gather_shards(t, list(ds)), caches,
                     *dds)
    cache_err = 0.0
    if rd.rank == 0:
        for part, es in final.items():
            for j, e in enumerate(es):
                for k, t in e.items():
                    w = ref["caches"][f"{part}/{j}/{k}"].to(dev).float()
                    cache_err = max(cache_err, float(
                        (t.float() - w).abs().max() / w.abs().max()))
    del params, caches, final
    torch.cuda.empty_cache()
    return dict(ties=ties, wrong=wrong,
                cache_err=cache_err, prefill_ms=prefill_ms,
                decode_ms=sum(times[1:]) / max(1, len(times) - 1),
                records={"prefill": pre_records, "decode": dec_records},
                flash=flash, plans=[rp.rules.attn.kind, rd.rules.attn.kind],
                slot_axes=list(rd.kv_layout(rd.decode_slots())[0]),
                wall_s=time.perf_counter() - t_lane)


def dry_serve_records(strategy, B, world_shape):
    """The collective records (``record_key``) of a dry run of a serve
    lane's prefill and decode steps on a fake world of the lane's mesh,
    rank 0, with their launches."""
    from repro_torch.configs import LaneConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.dryrun import analyze_serve
    out = {}
    for shape in serve_mesh_shapes(B):
        with mesh_lib.fake_world(math.prod(world_shape)):
            mesh = mesh_lib.make_mesh(world_shape, MESH_AXES)
            full = analyze_serve(mesh_cfg("qwen3-4b"), shape, LaneConfig(),
                                 mesh, strategy)
        out[shape.kind] = ([record_key(r) for r in full["records"]],
                           {k: v["launches"]
                            for k, v in full["kernels"].items()})
    return out


def check_serve_mesh(res, name, shape):
    """The serve lanes' numbers from every rank: tokens equal to one
    device's (or a near tie within SERVE_TOKEN_TOL), rank 0's gathered
    caches within SERVE_CACHE_TOL of one device's, each step's
    collective records equal on every rank and equal to the dry run's of
    the same step on a fake world of the mesh, flash launched by the
    prefill. Returns {lane: rank 0's flash launches}."""
    smi = nvidia_smi("name,power.limit")
    out, bad = {}, []
    for label, strategy, B in SERVE_MESH_LANES:
        t0 = time.perf_counter()
        dry = dry_serve_records(strategy, B, shape)
        dry_s = time.perf_counter() - t0
        x0 = res[0]["serve"][label]
        for r in res:
            x = r["serve"][label]
            same = {k: x["records"][k] == dry[k][0] for k in dry}
            print(f"{name} {label} (qwen3-4b, {MESH_LAYERS} of 36 layers, "
                  f"bf16, {B} x {SERVE_MESH_PROMPT} prefilled, "
                  f"{SERVE_MESH_STEPS} decode steps, {strategy}, plans "
                  f"{x['plans']}, decode cache slots over "
                  f"{x['slot_axes'] or 'no axis'}), rank {r['rank']}: "
                  f"{len(x['ties'])} token(s) other than one device's "
                  f"{x['ties']} ({x['wrong']} past SERVE_TOKEN_TOL); "
                  f"records equal the dry run's (prefill "
                  f"{len(x['records']['prefill'])}, decode "
                  f"{len(x['records']['decode'])}): {same}; flash launches "
                  f"{x['flash']}; warm prefill {x['prefill_ms']:.1f} ms, "
                  f"decode {x['decode_ms']:.2f} ms a step; the lane "
                  f"{x['wall_s']:.1f} s wall")
            if x["wrong"] or not all(same.values()) or not x["flash"]:
                bad.append(f"{label} rank {r['rank']}")
            if x["records"] != x0["records"]:
                bad.append(f"{label}: rank {r['rank']}'s records differ "
                           "from rank 0's")
        print(f"{name} {label}: rank 0's caches after the last step against "
              f"one device's: {x0['cache_err']:.3g} of each leaf's largest "
              f"|value| (tolerance {SERVE_CACHE_TOL}); dry run "
              f"{dry_s:.1f} s, its launches {dry['prefill'][1]} / "
              f"{dry['decode'][1]}; rank 0's warm prefill "
              f"{x0['prefill_ms']:.1f} ms and decode step "
              f"{x0['decode_ms']:.2f} ms on {smi} (4 ranks sharing the card "
              "over gloo)")
        if x0["cache_err"] > SERVE_CACHE_TOL:
            bad.append(f"{label}: caches {x0['cache_err']:.3g} from one "
                       "device's")
        out[label] = x0["flash"]
    if bad:
        raise AssertionError("serve lanes: " + "; ".join(bad))
    return out


def mesh_path(lane_spec):
    """A mesh lane's name on the kernels line."""
    label, arch, *_, overrides = lane_spec
    return (f"train {mesh_title(arch, overrides)}, 2x2 mesh over gloo, "
            f"{label}, rank 0")


def check_train_mesh():
    """Each mesh lane's stack at full width (``mesh_cfg``): one device's
    losses and leaf moves at each lane's stack and shape, and one
    device's serve runs (``serve_references``), in this process; then
    the lanes and the serve lanes on the 2x2 mesh of 4 ranks sharing the
    card over gloo. Returns (rank 0's launches by lane, the one-device
    qwen3-4b losses and leaf moves at 4 x 128, rank 0's flash launches
    by serve lane)."""
    from repro_torch.launch import train as launch_train
    from repro_torch.core import zo
    want, moves = {}, {}
    for key in sorted({(spec[1],) + spec[4:] for spec in MESH_LANES}):
        arch, batch, seq, overrides = key
        one = launch_train.setup(launch_train.parse_args(
            mesh_argv(arch, batch, seq)), cfg=mesh_cfg(arch, overrides))
        init = [t.detach().clone() for t in zo.leaves(one.state.params)]
        with probe_losses() as seen:
            want[key], ms, peak, counts = mesh_train(one, MESH_STEPS)
        moves[key] = leaf_moves(one.state.params, init)
        print(f"{mesh_title(arch, overrides)} at {batch} x {seq} on one "
              f"device: losses "
              f"{[round(v, 5) for v in want[key]]}, first (l+, l-) "
              f"{[float(x) for x in seen[:2]]}, {ms:.1f} ms a step, "
              f"peak {peak} bytes, launches {counts}")
        del one, init
        torch.cuda.empty_cache()
    import tempfile
    cut = ("qwen3-4b", 4, 128, ())
    d = tempfile.mkdtemp(prefix="serve_refs_")
    try:
        t0 = time.perf_counter()
        refs = serve_references(d)
        print(f"serve lanes' one-device references (qwen3-4b, {MESH_LAYERS} "
              f"of 36 layers, bf16, {SERVE_MESH_PROMPT} + {SERVE_MESH_STEPS} "
              f"tokens, batches {sorted(refs)}): "
              f"{time.perf_counter() - t0:.1f} s")
        n, served = check_mesh((2, 2), "gloo", want, moves, serve_refs=refs)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return n, want[cut], moves[cut], served


# --------------------------------------------------------------------- #
# the dry run's cost model (launch/dryrun.py) against the card
# --------------------------------------------------------------------- #
COST_PEAK_RTOL = 0.10            # the dry run's peak bytes against the
#                                  step's measured max_memory_allocated
COST_STEPS = 3                   # measured steps of (b); the fastest is
#                                  held to the bound
COST_UNITS = "bound at H100 SXM published peaks, 700 W"


COST_CLI_CELLS = (("train_4k", "tp"), ("decode_32k", "serve"))
#                                  (shape, strategy) of qwen3-4b's cells
#                                  the dry run's CLI runs in (a)


def start_cost_cli():
    """Starts (a), ``python -m repro_torch.launch.dryrun`` on the qwen3-4b
    cells of COST_CLI_CELLS on the 16x16 production mesh (the train cell,
    then a serve cell: the decode under the serve strategy's seq plan),
    one CLI run after the other in a subprocess: it needs no card, so it
    runs on the host beside the card's phases (from the end of the
    kernel phase, whose timings it would perturb). Returns the handle
    ``check_cost_cli`` reads; the process is killed at exit if it still
    runs."""
    import atexit
    import shlex
    import tempfile
    tmp = tempfile.mkdtemp(prefix="dryrun_smoke_")
    log = open(Path(tmp, "log"), "w")
    proc = subprocess.Popen(
        ["sh", "-c", " && ".join(" ".join(shlex.quote(a) for a in [
            sys.executable, "-W", "ignore", "-m",
            "repro_torch.launch.dryrun", "--arch", "qwen3-4b", "--shape",
            shape, "--mesh", "single", "--strategy", strategy, "--force",
            "--out", tmp]) for shape, strategy in COST_CLI_CELLS)],
        stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        start_new_session=True)

    def stop():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    atexit.register(stop)
    return proc, tmp, time.perf_counter(), stop


def check_cost_cli(handle):
    """(a) The dry runs started by ``start_cost_cli``: each cell's status,
    and per device its FLOPs, bytes, collective bytes by kind, peak bytes
    and the roofline's three terms and bottleneck (``benchmarks/
    roofline.py``; bounds at published peaks, not measurements)."""
    from repro_torch.benchmarks import roofline
    from repro_torch.launch.dryrun import out_name
    proc, tmp, t0, stop = handle
    try:
        rc = proc.wait(timeout=600)
        wall = time.perf_counter() - t0
        recs = {}
        for shape, strategy in COST_CLI_CELLS:
            out = Path(tmp, out_name("qwen3-4b", shape, "single", strategy,
                                     False))
            recs[shape] = json.loads(out.read_text()) if out.exists() else {}
        log = Path(tmp, "log").read_text()
    finally:
        stop()
    for (shape, strategy), rec in zip(COST_CLI_CELLS, recs.values()):
        if rc or rec.get("status") != "ok":
            raise AssertionError(f"dryrun qwen3-4b {shape} single "
                                 f"{strategy}: rc {rc}, status "
                                 f"{rec.get('status')}: {rec.get('error')}"
                                 f"\n{log[-3000:]}")
        full, row = rec["full"], roofline.row_of(rec)
        extra = f", cache_len {rec['cache_len']}" if "cache_len" in rec \
            else ""
        print(f"dryrun qwen3-4b {shape} on the 16x16 mesh ({strategy}, "
              f"attention plan {rec['attn_plan']['kind']}{extra}; rank 0 "
              f"of 256 on a fake process group, meta tensors; started after "
              f"the kernel phase, read {wall:.1f} s later; the cell "
              f"{rec['elapsed_s']} s): a device "
              f"{full['flops']:.4g} FLOPs ({full['flops_by_dtype']}), "
              f"{full['bytes_accessed']:.4g} bytes, collective bytes "
              f"{full['collective_bytes']:.4g} (" + ", ".join(
                  f"{k} {v['count']} calls {v['bytes']:.4g}"
                  for k, v in full["collectives"].items()) +
              f"), peak {full['memory']['peak_bytes']} bytes; launches " +
              str({k: v["launches"] for k, v in full["kernels"].items()}))
        print(f"dryrun qwen3-4b {shape} roofline ({COST_UNITS}): compute "
              f"{row['t_compute_s'] * 1e3:.2f} ms, memory "
              f"{row['t_memory_s'] * 1e3:.2f} ms, collective "
              f"{row['t_collective_s'] * 1e3:.2f} ms (NVLink "
              f"{row['t_nvlink_s'] * 1e3:.2f}, NDR "
              f"{row['t_ndr_s'] * 1e3:.2f}): bottleneck {row['bottleneck']};"
              f" MODEL / counted FLOPs {row['useful_flops_ratio']:.3f}")


def check_cost_step(trainer, kernels):
    """(b) The unfused qwen3-4b 4 x 128 elastic_zo step on one device
    (the train phase's trainer, its state in ``trainer.state``, which is
    consumed: no other reference to a state may hold stale tail leaves
    on the card while the steps are measured) against its dry run with no
    mesh and the same config, batch and lane: the dry run's launches
    equal the card's exactly (24 / 12 / 70), its peak bytes lie within
    COST_PEAK_RTOL of each measured step's max_memory_allocated, and its
    bound, max(compute, memory) at the H100's published peaks, is no
    larger than the fastest measured step. Prints the bound over the
    step as the step's roofline share."""
    from repro_torch.benchmarks import roofline
    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.launch.dryrun import analyze_step
    args = dict(zip(TRAIN_ARGV[::2], TRAIN_ARGV[1::2]))
    shape = ShapeConfig("train", seq_len=int(args["--seq"]),
                        global_batch=int(args["--batch"]), kind="train")
    t0 = time.perf_counter()
    full = analyze_step(ARCHS["qwen3-4b"], shape, trainer.lane)
    dry_s = time.perf_counter() - t0
    state, trainer.state = trainer.state, None
    mask = np.ones(trainer.lane.zo_num_probes, np.float32)
    times, peaks, counts = [], [], []
    for _ in range(COST_STEPS):
        batch = trainer.batch_fn(state.step)
        before = {k: getattr(m, a) for k, (m, a) in kernels.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        state, _ = trainer.step_fn(state, batch, mask)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        peaks.append(torch.cuda.max_memory_allocated())
        counts.append({k: getattr(m, a) - before[k]
                       for k, (m, a) in kernels.items()})
        del batch
    dry = {k: v["launches"] for k, v in full["kernels"].items()}
    want = {"zo_perturb": 24, "zo_fused_replay": 12, "flash_attention": 70}
    peak = full["memory"]["peak_bytes"]
    t_c = roofline.compute_seconds(full)
    t_m = full["bytes_accessed"] / roofline.HBM_BW
    bound = max(t_c, t_m)
    step_s = min(times)
    smi = nvidia_smi("name,power.limit")
    print(f"cost model, qwen3-4b unfused {shape.global_batch} x "
          f"{shape.seq_len} step on one device ({smi}): dry run "
          f"({dry_s:.1f} s) launches {dry}, the card's a step {counts}; "
          f"peak {peak} bytes (argument {full['memory']['argument_bytes']}, "
          f"temp {full['memory']['temp_bytes']}), measured "
          f"max_memory_allocated {peaks} (dry / measured " +
          ", ".join(f"{peak / p:.4f}" for p in peaks) + ")")
    print(f"cost model, qwen3-4b step bound ({COST_UNITS}): compute "
          f"{t_c * 1e3:.3f} ms ({full['flops']:.4g} FLOPs: "
          f"{full['flops_by_dtype']}, kernels' operations "
          f"{sum(k['ops_bound_s'] for k in full['kernels'].values()) * 1e3:.3f}"
          f" ms), memory {t_m * 1e3:.3f} ms ({full['bytes_accessed']:.4g} "
          f"bytes); measured steps {[round(t * 1e3, 2) for t in times]} ms; "
          f"roofline share (bound / fastest step) {bound / step_s:.4f} on "
          f"{smi}")
    bad = []
    if dry != want or any(c != want for c in counts):
        bad.append(f"launches: dry {dry}, card {counts}, want {want}")
    if any(abs(peak - p) > COST_PEAK_RTOL * p for p in peaks):
        bad.append(f"peak {peak} bytes, measured {peaks}: past "
                   f"{COST_PEAK_RTOL}")
    if bound > step_s:
        bad.append(f"bound {bound * 1e3:.3f} ms above the step's "
                   f"{step_s * 1e3:.3f} ms")
    del state
    if bad:
        raise AssertionError("cost model against the card: " + "; ".join(bad))


def check_cost_serve(kernels):
    """(d) qwen3-4b's serving steps (``mesh_cfg``: MESH_LAYERS of 36
    layers at full width, bf16): a prefill of SERVE_MESH_ROWS x
    SERVE_MESH_PROMPT tokens and a decode step against caches of
    SERVE_MESH_PROMPT + SERVE_MESH_STEPS slots at their last, dry run on
    a fake 1x1 world, against the same steps on the card on a 1x1 mesh
    (a gloo world of one rank on the card: every collective is the
    identity), COST_STEPS times each: the dry run's launches equal the
    card's, its peak bytes lie within COST_PEAK_RTOL of each step's
    max_memory_allocated less what the process held before the step's
    arguments were made (earlier phases leave ~0.44 GB allocated, which
    the 2.4 GB steps would show as a 15% miss), and its bound,
    max(compute, memory) at the H100's published peaks, is no larger
    than the fastest step. Prints the bound over the step as its
    roofline share."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.benchmarks import roofline
    from repro_torch.configs import LaneConfig
    from repro_torch.core import api
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.dryrun import analyze_serve
    from repro_torch.models.transformer import make_caches
    cfg, lane = mesh_cfg("qwen3-4b"), LaneConfig()
    shapes = serve_mesh_shapes(SERVE_MESH_ROWS)
    dry = {}
    t0 = time.perf_counter()
    for shape in shapes:
        with mesh_lib.fake_world(1):
            mesh = mesh_lib.make_mesh((1, 1), MESH_AXES)
            dry[shape.kind] = analyze_serve(cfg, shape, lane, mesh, "tp")
    dry_s = time.perf_counter() - t0
    store = tempfile.mkdtemp(prefix="serve_cost_")
    mesh_lib.init_ranks("gloo", "cuda", 0, 1,
                        "file://" + os.path.join(store, "store"))
    smi = nvidia_smi("name,power.limit")
    bad = []
    try:
        mesh = mesh_lib.make_mesh((1, 1), MESH_AXES)
        rng = np.random.default_rng(13)
        for shape in shapes:
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            run = api.mesh_run(cfg, shape, lane, mesh, "tp")
            params = api.init(cfg, lane, seed=0, device="cuda",
                              max_seq=shape.seq_len, run=run)
            B = shape.global_batch
            if shape.kind == "prefill":
                toks = torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (B, shape.seq_len)).astype(
                        np.int32)).to("cuda")
                caches = None

                def step():
                    return api.prefill_step(params, cfg, toks, run=run)
            else:
                toks = torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (B, 1)).astype(np.int32)).to("cuda")
                caches = api.split_caches(make_caches(
                    cfg, B, shape.seq_len, device="cuda", run=run), cfg,
                    lane)

                def step():
                    return api.decode_step(params, cfg, toks, caches,
                                           shape.seq_len - 1, run=run)
            times, peaks, counts = [], [], []
            for _ in range(COST_STEPS):
                before = {k: getattr(m, a) for k, (m, a) in kernels.items()}
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t1 = time.perf_counter()
                out = step()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
                peaks.append(torch.cuda.max_memory_allocated() - held)
                counts.append({k: getattr(m, a) - before[k]
                               for k, (m, a) in kernels.items()
                               if getattr(m, a) - before[k]})
                del out
            full = dry[shape.kind]
            want = {k: v["launches"] for k, v in full["kernels"].items()}
            peak = full["memory"]["peak_bytes"]
            t_c = roofline.compute_seconds(full)
            t_m = full["bytes_accessed"] / roofline.HBM_BW
            bound = max(t_c, t_m)
            print(f"cost model, qwen3-4b ({MESH_LAYERS} of 36 layers, bf16) "
                  f"{shape.kind} step, {B} x {shape.seq_len}, 1x1 mesh "
                  f"({smi}): dry run launches {want}, the card's {counts}; "
                  f"peak {peak} bytes (argument "
                  f"{full['memory']['argument_bytes']}, temp "
                  f"{full['memory']['temp_bytes']}), measured "
                  f"max_memory_allocated less the {held} bytes held before "
                  f"{peaks} (dry / measured " +
                  ", ".join(f"{peak / p:.4f}" for p in peaks) + "); bound "
                  f"({COST_UNITS}) compute {t_c * 1e3:.3f} ms, memory "
                  f"{t_m * 1e3:.3f} ms; measured "
                  f"{[round(t * 1e3, 3) for t in times]} ms; roofline share "
                  f"(bound / fastest step) {bound / min(times):.4f}")
            if any(c != want for c in counts):
                bad.append(f"{shape.kind} launches: dry {want}, card {counts}")
            if any(abs(peak - p) > COST_PEAK_RTOL * p for p in peaks):
                bad.append(f"{shape.kind} peak {peak} bytes, measured "
                           f"{peaks}: past {COST_PEAK_RTOL}")
            if bound > min(times):
                bad.append(f"{shape.kind} bound {bound * 1e3:.3f} ms above "
                           f"the step's {min(times) * 1e3:.3f} ms")
            del params, caches, toks
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    print(f"cost model, serving steps: the two dry runs took {dry_s:.1f} s")
    if bad:
        raise AssertionError("cost model against the card (serve): " +
                             "; ".join(bad))


def record_key(r):
    """A collective record as the ranks compare it: (kind, group size,
    output bytes, bytes moved)."""
    return [r[0], len(r[1]), r[2], r[3]]


def dry_mesh_records(arch, overrides, strategy, batch, seq, shape, lane):
    """The collective records of a dry run of a mesh lane's step (its
    config, shape and lane) on a fake world of the lane's mesh, rank 0,
    as ``record_key``s, and its launches."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.dryrun import analyze_step
    shp = ShapeConfig("train", seq_len=seq, global_batch=batch, kind="train")
    with mesh_lib.fake_world(math.prod(shape)):
        mesh = mesh_lib.make_mesh(shape, MESH_AXES)
        full = analyze_step(mesh_cfg(arch, overrides), shp, lane, mesh,
                            strategy)
    return ([record_key(r) for r in full["records"]],
            {k: v["launches"] for k, v in full["kernels"].items()})


def check_train_mesh_nccl(want_losses, cut_losses, cut_moves):
    """Whole qwen3-4b on a 1x1 mesh over NCCL in this process (world size
    1; the coefficient check all-gathers through NCCL every step),
    against the one-device run's losses (``want_losses``, the resume
    phase's plain run): bitwise, since a group of one rank is the
    identity. Then, where the machine has four cards, the 2x2 ``tp`` lane
    over NCCL, a card a rank, against one device's ``cut_losses`` and
    ``cut_moves``. Returns (the 1x1 run's launches, whether the
    four-card run ran)."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as launch_train
    store = tempfile.mkdtemp(prefix="nccl_smoke_")
    mesh_lib.init_ranks("nccl", "cuda", 0, 1,
                        "file://" + os.path.join(store, "store"))
    try:
        trainer = launch_train.setup(launch_train.parse_args(
            TRAIN_ARGV[:-1] + [str(MESH_STEPS)]),
            mesh=mesh_lib.make_mesh((1, 1), MESH_AXES))
        losses, ms, peak, counts = mesh_train(trainer, MESH_STEPS)
        del trainer
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    torch.cuda.empty_cache()
    same = losses == want_losses[:MESH_STEPS]
    print(f"whole qwen3-4b, 1x1 mesh over NCCL: losses {losses}, {ms:.1f} ms"
          f" a step, peak {peak} bytes, launches {counts}; bitwise the "
          f"one-device run's {want_losses[:MESH_STEPS]}: {same}")
    if not same or counts != {"zo_perturb": 24 * MESH_STEPS,
                              "zo_fused_replay": 12 * MESH_STEPS,
                              "flash_attention": 70 * MESH_STEPS}:
        raise AssertionError("the 1x1 mesh over NCCL left the one-device run")
    four = torch.cuda.device_count() >= 4
    if four:                # the cut's losses: check_train_mesh's one device
        cut = ("qwen3-4b", 4, 128, ())
        check_mesh((2, 2), "nccl", {cut: cut_losses}, {cut: cut_moves},
                   small=(), lanes=MESH_LANES[:1])
    print(f"2x2 over NCCL on four cards: {'ran' if four else 'not run'} "
          f"({torch.cuda.device_count()} card(s) here)")
    return counts, four


def check_autograd_workspace():
    """The one-time allocation of the process's first backward: cuBLAS
    keeps a workspace a (handle, stream), and the autograd engine's
    device thread takes its own handle, so its first product allocates
    one more workspace of CUBLAS_WORKSPACE_CONFIG's size (:4096:8 is 8 x
    4 MiB). Run before any backward of the process: a product on this
    thread first, then a product's backward; prints the allocator's
    growth and the 32 MiB blocks of memory_snapshot."""
    from repro_torch.core.api import deterministic
    size = 8 * 4096 * 1024
    a = torch.randn(64, 64, device="cuda")
    with deterministic():
        (a @ a).sum()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        blocks0 = _blocks_of(size)
        w = a.clone().requires_grad_(True)
        torch.autograd.grad((w @ a).sum(), w)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - before
    blocks = _blocks_of(size)
    print(f"first backward of the process: the allocator grew {grown} bytes "
          f"and holds {blocks} live blocks of {size} bytes ({blocks0} "
          "before it)")
    if blocks != blocks0 + 1 or grown < size:
        raise AssertionError("the autograd thread's first backward did not "
                             f"allocate one {size}-byte workspace")


def _blocks_of(size):
    return sum(1 for seg in torch.cuda.memory_snapshot()
               for b in seg["blocks"]
               if b["size"] == size and b["state"] == "active_allocated")


ADAM_CARD_ULP = 2                # an adam update, card against CPU (f32)


def check_optimizers():
    """train/optimizer.py on the card against the CPU: 20 updates of a
    512 x 2560 leaf and a 2560 bias (a slice of a qwen3-4b tail leaf: the
    CPU side of the whole 2560 x 9728 takes minutes), bf16 and f32, at a
    constant learning rate and host steps (the train loop's): sgd,
    momentum and Nesterov bitwise (updates, state, params); adam's state
    bitwise and every update within ADAM_CARD_ULP (its bias corrections
    are divided on the leaf's device), its params bitwise where the
    updates are (a few ulp of an update can move a parameter that crosses
    zero by millions of its own, so they are not held in ulps). Then the
    schedules at a device step counter, at step 0, the warmups' ends, mid
    and the end, within 1 ulp of the CPU's (pow and cos are each device's
    own)."""
    from repro_torch.benchmarks.bench_util import ulps
    from repro_torch.core import zo
    from repro_torch.train import optimizer as opt
    g = torch.Generator().manual_seed(0)
    p0 = {"w": torch.randn(512, 2560, generator=g) * 0.02,
          "b": torch.randn(2560, generator=g)}
    grads = [{k: torch.randn(v.shape, generator=g) for k, v in p0.items()}
             for _ in range(20)]
    makers = {"sgd": lambda: opt.sgd(1e-2),
              "momentum": lambda: opt.sgd(1e-2, momentum=0.9),
              "nesterov": lambda: opt.sgd(1e-2, momentum=0.9, nesterov=True),
              "adam": lambda: opt.adam(1e-3)}
    for dtype in (torch.bfloat16, torch.float32):
        for name, make in makers.items():
            runs = {d: make() for d in ("cpu", "cuda")}
            p = {d: {k: v.to(d, dtype) for k, v in p0.items()}
                 for d in runs}
            st = {d: o.init(p[d]) for d, o in runs.items()}
            du = 0
            for s, gr in enumerate(grads):
                upd = {}
                for d, o in runs.items():
                    upd[d], st[d] = o.update(
                        {k: v.to(d, dtype) for k, v in gr.items()}, st[d], s)
                    p[d] = opt.apply_updates(p[d], upd[d])
                du = max([du] + [ulps(upd["cuda"][k], upd["cpu"][k])
                                 for k in p0])
            dp = max(ulps(p["cuda"][k], p["cpu"][k]) for k in p0)
            diff = max(float((p["cuda"][k].cpu().float()
                              - p["cpu"][k].float()).abs().max())
                       for k in p0)
            ds = max([0] + [ulps(a, b) for a, b in
                            zip(zo.leaves(st["cuda"]), zo.leaves(st["cpu"]))]
                     if st["cpu"] != () else [0])
            print(f"optimizer {name:8s} {str(dtype)[6:]:8s}: card against "
                  f"CPU over 20 updates: updates {du} ulp (f32), state "
                  f"{ds} ulp, params {dp} ulp, max |difference| {diff:.3g} "
                  f"(largest |param| "
                  f"{max(float(v.abs().max()) for v in p['cpu'].values()):.3g})")
            if ds or du > (ADAM_CARD_ULP if name == "adam" else 0) \
                    or (du == 0 and dp):
                raise AssertionError(f"optimizer {name} {dtype}: updates "
                                     f"{du}, state {ds}, params {dp} ulp")
    worst = {}
    for name, f in (("step_decay", opt.step_decay(0.05, 0.8, 10)),
                    ("cosine", opt.cosine(0.3, 100, warmup=10)),
                    ("cosine_floor", opt.cosine(0.3, 100, warmup=7,
                                                floor=0.1))):
        worst[name] = max(ulps(f(torch.tensor(s, device="cuda")), f(s))
                          for s in (0, 7, 10, 25, 55, 60, 100, 130))
    print(f"schedules, card against CPU at steps 0-130: {worst} ulp")
    if max(worst.values()) > 1:
        raise AssertionError(f"schedules: {worst} ulp")


# --------------------------------------------------------------------- #
# the four examples at their JAX twins' defaults
# --------------------------------------------------------------------- #
# the kernels each example's path goes through on the card
EXAMPLE_KERNELS = {
    "quickstart": ("zo_perturb", "zo_fused_replay", "flash_attention"),
    "finetune_rotated": ("zo_perturb", "zo_fused_replay"),
    "int8_ondevice": ("int8_perturb", "zo_fused_replay_int8", "int8_matmul"),
    "lm_zo_finetune": ("zo_perturb", "zo_fused_replay", "flash_attention"),
}


def _brief(v):
    """A long list as its first and last items, in nested dicts too."""
    if isinstance(v, dict):
        return {k: _brief(x) for k, x in v.items()}
    if isinstance(v, list) and len(v) > 4:
        return [v[0], f"... {len(v) - 2} more ...", v[-1]]
    return v


def check_examples(counters):
    """repro_torch.examples.<name>.main() on the card at the JAX
    examples' defaults, each with its own assertions; prints their
    numbers and each example's launches, counted from 0 before it (each
    must launch its path's kernels). ``counters``: {kernel: (module,
    counter attribute)}."""
    import importlib
    for name, used in EXAMPLE_KERNELS.items():
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        for m, attr in counters.values():
            setattr(m, attr, 0)
        t0 = time.perf_counter()
        out = mod.main()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: getattr(m, attr) for k, (m, attr) in counters.items()}
        shown = {k: _brief(v) for k, v in out.items() if k != "state"}
        print(f"example {name}: {dt:.1f} s wall, {shown}; launches {counts}")
        if not all(counts[k] for k in used):
            raise AssertionError(f"example {name} did not launch {used}")


# --------------------------------------------------------------------- #
# training: qwen3-4b with the fused antithetic probe pair, seq 4096
# --------------------------------------------------------------------- #
FUSED_ARGV = ["--arch", "qwen3-4b", "--lane", "elastic_zo",
              "--bp-tail-layers", "1", "--probes", "1", "--batch", "1",
              "--seq", "4096", "--lr", "1e-2", "--eps", "1e-3", "--steps",
              "5"]
# launches a step at 1 probe: zo_perturb embed 2 + 11 periods_zo leaves x
# 35 periods x 2 signs; zo_fused_replay one per ZO leaf; flash 35 x 2
FUSED_PER_STEP = {"zo_perturb": 2 + 11 * 35 * 2, "zo_fused_replay": 12,
                  "flash_attention": 35 * 2}


@contextlib.contextmanager
def probe_losses():
    """Records the probe losses of the steps run inside, in order: l+ and
    l- of each fused pair (repro_torch.core.api.paired_loss), and each
    unfused probe forward's loss (api.loss_fn: +eps, then -eps)."""
    from repro_torch.core import api
    seen = []
    paired, single = api.paired_loss, api.loss_fn

    def p(*a, **k):
        out = paired(*a, **k)
        seen.extend(x.detach() for x in out)
        return out

    def s(*a, **k):
        out = single(*a, **k)
        seen.append(out.detach())
        return out
    api.paired_loss, api.loss_fn = p, s
    try:
        yield seen
    finally:
        api.paired_loss, api.loss_fn = paired, single


@contextlib.contextmanager
def probe_phase_peaks():
    """Records max_memory_allocated() when each step inside reaches its
    ZO update (Fp32Engine.zo_apply), i.e. the peak of its probe forwards
    and backwards; the rest of a step's peak is its update."""
    from repro_torch.core.engine import Fp32Engine
    seen = []
    apply = Fp32Engine.zo_apply

    def at_update(*a, **k):
        seen.append(torch.cuda.max_memory_allocated())
        return apply(*a, **k)
    Fp32Engine.zo_apply = staticmethod(at_update)
    try:
        yield seen
    finally:
        Fp32Engine.zo_apply = staticmethod(apply)


def check_train_fused(kernels, unfused_peak0):
    """The fused-probe elastic_zo lane on qwen3-4b at batch 1 x seq 4096,
    built through repro_torch.launch.train.setup with the lane override:
    launch counts a step, finite losses, a changed head and tail, a
    bitwise rerun; then one unfused step from the same init, whose
    (l+, l-) must equal the fused step's and whose peak device memory is
    printed beside it; and one fused step at the unfused train phase's
    shape, whose peak is printed beside that phase's first step's
    (``unfused_peak0``). Returns the fused run's launch counts."""
    from repro_torch.core import elastic, zo
    from repro_torch.launch import train as launch_train
    from repro_torch.train.train_loop import LoopConfig, run
    args = launch_train.parse_args(FUSED_ARGV)
    fused = dataclasses.replace(launch_train.lane_from_args(args),
                                fused_probes=True)
    trainer = launch_train.setup(args, fused)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    for k in kernels.values():
        k.launches = 0
    with probe_losses() as seen, probe_phase_peaks() as probe_peaks:
        state, losses, wall, peak, peak0 = train_run(trainer, run, LoopConfig)
    n = {name: k.launches for name, k in kernels.items()}
    pair_fused = [float(x) for x in seen[:2]]
    tokens = args.batch * args.seq
    print(f"train qwen3-4b elastic_zo fused probes, 1 probe, batch "
          f"{args.batch} x seq {args.seq}: losses "
          f"{[round(v, 4) for v in losses]}; {1e3 * wall / 4:.1f} ms per step, "
          f"{4 * tokens / wall:.1f} tokens/s over 4 timed steps; peak device "
          f"memory {peak0} bytes in the first step, {peak} in the timed ones "
          f"(parameters {base})")
    print(f"launches on the main path (5 steps): {n}")
    if n != {k: 5 * v for k, v in FUSED_PER_STEP.items()}:
        raise AssertionError(f"launches {n}, want 5 x {FUSED_PER_STEP}")
    if len(losses) != 5 or not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"losses {losses}")
    del trainer

    again = launch_train.setup(args, fused)
    final = dict((zo.keystr(p), t) for p, t in
                 zo.leaves_with_path(state.params))
    zo_part, bp_part = ([zo.keystr(p) for p, _ in zo.leaves_with_path(t)]
                        for t in elastic.partition(again.state.params, fused))
    fresh = dict((zo.keystr(p), t) for p, t in
                 zo.leaves_with_path(again.state.params))
    moved = {part: sum(not torch.equal(fresh[k], final[k]) for k in names)
             for part, names in (("zo", zo_part), ("bp", bp_part))}
    print(f"leaves changed by training: {moved['zo']} of {len(zo_part)} ZO, "
          f"{moved['bp']} of {len(bp_part)} BP-tail")
    if not moved["zo"] or not moved["bp"]:
        raise AssertionError("training left the ZO head or the tail as it was")
    del fresh
    state2, losses2, wall2, _, _ = train_run(again, run, LoopConfig)
    same = all(torch.equal(t, final[zo.keystr(p)])
               for p, t in zo.leaves_with_path(state2.params))
    print(f"rerun from the same seed: losses {[round(v, 4) for v in losses2]},"
          f" {1e3 * wall2 / 4:.1f} ms per step; parameters bitwise equal: "
          f"{same}")
    if not same or losses2 != losses:
        raise AssertionError("a fused rerun from the same parameters and "
                             "seed gave other parameters or losses")
    del state, final
    profile_train_step(again, state2, run, LoopConfig, wall2 / 4)
    del again, state2
    torch.cuda.empty_cache()

    unfused = launch_train.setup(args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with probe_losses() as seen, probe_phase_peaks() as probe_u:
        run(unfused.step_fn, unfused.state, unfused.batch_fn,
            LoopConfig.for_lane(unfused.lane, total_steps=1, log_every=1),
            log=None)
        torch.cuda.synchronize()
    peak_u = torch.cuda.max_memory_allocated()
    pair_unfused = [float(x) for x in seen[:2]]
    print(f"first step from the same init, batch {args.batch} x seq "
          f"{args.seq}: (l+, l-) "
          f"fused {pair_fused}, unfused {pair_unfused}; peak device memory "
          f"fused {peak0} bytes, unfused {peak_u} bytes (unfused - fused = "
          f"{peak_u - peak0} bytes; parameters {base}); peak up to the ZO "
          f"update fused {probe_peaks[0]}, unfused {probe_u[0]}")
    if pair_fused != pair_unfused:
        raise AssertionError("the fused pair's losses differ from the "
                             "unfused forwards'")
    del unfused
    torch.cuda.empty_cache()

    small = launch_train.parse_args(TRAIN_ARGV)
    trainer = launch_train.setup(small, dataclasses.replace(
        launch_train.lane_from_args(small), fused_probes=True))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with probe_phase_peaks() as probe_small:
        run(trainer.step_fn, trainer.state, trainer.batch_fn,
            LoopConfig.for_lane(trainer.lane, total_steps=1, log_every=1),
            log=None)
    torch.cuda.synchronize()
    print(f"first step at batch {small.batch} x seq {small.seq}: peak device "
          f"memory fused {torch.cuda.max_memory_allocated()} bytes "
          f"(allocated before it {base}; {probe_small[0]} up to the ZO "
          f"update), unfused {unfused_peak0} bytes (the unfused train "
          "phase's first step)")
    del trainer
    torch.cuda.empty_cache()
    return n


def profile_train_step(trainer, state, run, LoopConfig, step_s):
    """Device time by kernel over one more step, from torch.profiler
    tracing the device alone (a step launches thousands of kernels); the
    busy share is against an unprofiled step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    loop = LoopConfig.for_lane(trainer.lane, total_steps=state.step + 1,
                               log_every=1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(trainer.step_fn, state, trainer.batch_fn, loop, log=None)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    dev_us = _kernel_us(prof)
    print(f"train profile: {len(kernels)} kernel names, device time "
          f"{dev_us / 1e3:.1f} ms in one step = {100 * dev_us / 1e6 / step_s:.1f}% "
          f"of an unprofiled step's wall time")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for e in top[:12] + [e for e in top[12:]
                         if "zo_" in e.key or "flash" in e.key]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:90]}")


# --------------------------------------------------------------------- #
# training the MoE, RWKV6 and Mamba/hybrid families at full width
# --------------------------------------------------------------------- #
def family_argv(arch, batch, seq, steps):
    return ["--arch", arch, "--lane", "elastic_zo", "--bp-tail-layers", "1",
            "--probes", "1", "--batch", str(batch), "--seq", str(seq),
            "--lr", "1e-2", "--eps", "1e-3", "--steps", str(steps)]


def family_per_step(trainer, cfg):
    """Launches a step at 1 probe, from the ZO leaf list: zo_perturb 2 x
    the ZO leaves (fused: 2 x the leaves outside periods_zo + 2 x the
    periods_zo leaves x the ZO periods, one slice at a time),
    zo_fused_replay 1 x the ZO leaves, flash 2 x the ZO head's attention
    blocks, Whisper's cross-attention blocks and encoder blocks (the BP
    tail attends without it)."""
    from repro_torch.core import elastic, zo
    from repro_torch.models.transformer import num_periods
    zo_part, _ = elastic.partition(trainer.state.params, trainer.lane)
    paths = [p for p, _ in zo.leaves_with_path(zo_part)]
    pz = num_periods(zo_part["periods_zo"])
    stacked = sum(p[0] == "periods_zo" for p in paths)
    perturb = 2 * (len(paths) - stacked + stacked * pz) \
        if trainer.lane.fused_probes else 2 * len(paths)
    cross = 2 if cfg.encoder_layers else 1
    return {"zo_perturb": perturb, "zo_fused_replay": len(paths),
            "flash_attention": 2 * (pz * cfg.pattern.count("attn") * cross
                                    + cfg.encoder_layers)}


DIGEST_CHUNK = 1 << 26           # elements a digest pass


def bits_digest(t):
    """(sum of every element's bit pattern, sum of each pattern times a
    hash of its flat index), in int64 with wrap-around, on the tensor's
    device: equal for equal bits, and a change of any element changes
    the pair. It compares parameters of a stack too large for a second
    copy beside a training step (a copy on the host took most of a
    phase's time)."""
    ints = {2: torch.int16, 4: torch.int32}[t.element_size()]
    flat = t.detach().reshape(-1).view(ints)
    total = weighted = 0
    for s0 in range(0, flat.numel(), DIGEST_CHUNK):
        b = flat[s0:s0 + DIGEST_CHUNK].to(torch.int64)
        w = (torch.arange(s0 + 1, s0 + 1 + b.numel(), device=b.device)
             * 0x9E3779B1) & 0xFFFFFFFF
        total += int(b.sum())
        weighted += int((b * w).sum())
    return total, weighted


def digests(params):
    """{keystr: bits_digest} of a parameter tree."""
    from repro_torch.core import zo
    return {zo.keystr(p): bits_digest(t)
            for p, t in zo.leaves_with_path(params)}


def check_train_family(title, cfg, argv, kernels, held, *, fused=False,
                       steps=5, feeds=False):
    """ElasticZO on a full-width family stack through
    repro_torch.launch.train's own functions, as check_train_resume: launch
    counts a step (family_per_step), finite losses, a changed ZO head and
    BP part, and a rerun from the same seed with bitwise equal losses and
    parameters (two copies of a large stack do not fit beside a step's
    perturbed head, so the first run's are kept as digests). Prints ms a step,
    tokens/s, peak device memory and the device-busy share of one
    profiled step. With ``fused``, one unfused step from the same init
    follows, whose (l+, l-) must equal the fused first step's. Parameters
    are compared by ``digests``. Every flat index the run gives the ZO
    kernels lies below ``held``, the range check_zo_large holds. With
    ``feeds``, the rerun's trainer then times the plain and the
    prefetched feed (``feed_pairs``, ``steps`` - 1 timed steps a run).
    Returns the first run's launch counts."""
    from repro_torch.core import elastic, zo
    from repro_torch.launch import train as launch_train
    from repro_torch.train.train_loop import LoopConfig, run
    args = launch_train.parse_args(argv)
    lane = dataclasses.replace(launch_train.lane_from_args(args),
                               fused_probes=fused)
    t0 = time.perf_counter()
    trainer = launch_train.setup(args, lane, cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(trainer.state.params))
    print(f"{title}: setup (init of {n_params} bf16 parameters, "
          f"{torch.cuda.memory_allocated()} bytes) "
          f"{time.perf_counter() - t0:.2f} s")
    per_step = family_per_step(trainer, cfg)
    zo_part, bp_part = ([zo.keystr(p) for p, _ in zo.leaves_with_path(t)]
                        for t in elastic.partition(trainer.state.params,
                                                   lane))
    init = digests(trainer.state.params)
    for k in kernels.values():
        k.launches = 0
    with probe_losses() as seen, shapes_of(
            kernels["flash_attention"], "flash_attention",
            flash_shape) as fa_shapes, shapes_of(
            kernels["zo_perturb"], "zo_perturb",
            lambda theta, seed, salt, scale, offset=0, index=None:
            offset + theta.numel() if index is None
            else index.max_index + 1) as zp_ends, shapes_of(
            kernels["zo_fused_replay"], "zo_fused_replay",
            lambda theta, *a, index=None, **k: theta.numel()
            if index is None else index.max_index + 1) as zr_ends:
        state, losses, wall, peak, peak0 = train_run(trainer, run,
                                                     LoopConfig, steps)
    n = {name: k.launches for name, k in kernels.items()}
    pair = [float(x) for x in seen[:2]]
    timed = steps - 1
    tokens = args.batch * args.seq
    print(f"{title}, {'fused' if fused else 'unfused'} probes, batch "
          f"{args.batch} x seq {args.seq}: losses "
          f"{[round(v, 4) for v in losses]}; {1e3 * wall / timed:.1f} ms "
          f"per step, {timed * tokens / wall:.1f} tokens/s over {timed} "
          f"timed steps; peak device memory {peak0} bytes in the first "
          f"step, {peak} in the timed ones")
    want = {k: steps * v for k, v in per_step.items()}
    print(f"launches on the main path ({steps} steps): {n}, want {want}")
    if n != want:
        raise AssertionError(f"{title}: launches {n}, want {want}")
    if len(losses) != steps or not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"{title}: losses {losses}")
    if n["flash_attention"]:
        check_shapes_held("flash_attention", fa_shapes,
                          [c[1:] for c in FLASH_CASES])
    check_index_held("zo_perturb", zp_ends, held)
    check_index_held("zo_fused_replay", zr_ends, held)
    final = digests(state.params)
    del trainer, state
    torch.cuda.empty_cache()
    moved = {part: sum(init[k] != final[k] for k in names)
             for part, names in (("zo", zo_part), ("bp", bp_part))}
    print(f"leaves changed by training: {moved['zo']} of {len(zo_part)} ZO, "
          f"{moved['bp']} of {len(bp_part)} BP")
    if not moved["zo"] or not moved["bp"]:
        raise AssertionError(f"{title}: training left the ZO head or the BP "
                             "part as it was")
    del init

    again = launch_train.setup(args, lane, cfg)
    state2, losses2, wall2, _, _ = train_run(again, run, LoopConfig, steps)
    same = digests(state2.params) == final
    print(f"rerun from the same seed: losses {[round(v, 4) for v in losses2]},"
          f" {1e3 * wall2 / timed:.1f} ms per step; parameters bitwise "
          f"equal: {same}")
    if not same or losses2 != losses:
        raise AssertionError(f"{title}: a rerun from the same parameters "
                             "and seed gave other parameters or losses")
    del final
    if feeds:
        state2, _ = feed_pairs(title, again, state2, run, LoopConfig, timed)
    profile_train_step(again, state2, run, LoopConfig, wall2 / timed)
    del again, state2
    torch.cuda.empty_cache()

    if fused:
        unfused = launch_train.setup(args, dataclasses.replace(
            lane, fused_probes=False), cfg)
        with probe_losses() as seen:
            run(unfused.step_fn, unfused.state, unfused.batch_fn,
                LoopConfig.for_lane(unfused.lane, total_steps=1,
                                    log_every=1), log=None)
        pair_u = [float(x) for x in seen[:2]]
        print(f"first step from the same init: (l+, l-) fused {pair}, "
              f"unfused {pair_u}")
        if pair != pair_u:
            raise AssertionError(f"{title}: the fused pair's losses differ "
                                 "from the unfused forwards'")
        del unfused
        torch.cuda.empty_cache()
    return n


SMALL_TRAIN_TOL = 1e-4           # f32 step, card against CPU, relative to
#                                  max(1, |value|): matmul summation order,
#                                  amplified in g by 1 / 2 eps
SMALL_TAIL_TOL = 1e-4            # a BP leaf's change in the step, card
#                                  against CPU, beyond one ulp of its new
#                                  value, relative to the CPU's largest
#                                  change of that leaf
SMALL_GRAD_TOL = 1e-4            # a BP leaf's gradient of the +eps
#                                  probe's loss, card against CPU,
#                                  relative to the CPU's largest of the leaf


def tail_gradients(cfg, params, batch, seed):
    """The gradient of the +eps probe's loss over each non-empty BP leaf
    (autograd through the tail's backward), with params' device."""
    from repro_torch.configs import LaneConfig
    from repro_torch.core import api, elastic, zo
    lane = LaneConfig()
    zo_part, bp_part = elastic.partition(params, lane)
    with torch.no_grad():
        head = zo.perturb(zo_part, zo.device_seeds(
            [seed], next(iter(_leaves(params))).device), lane.zo_eps)
    bp = zo.map_with_path(lambda _p, t: t.detach().clone().requires_grad_(),
                          bp_part)
    leaves = [t for _, t in zo.leaves_with_path(bp) if t.numel()]
    return torch.autograd.grad(
        api.loss_fn(elastic.merge(head, bp), cfg, batch), leaves)


SMALL_TRAIN_CASES = (("mixtral-8x7b", {}), ("rwkv6-1.6b", {}),
                     ("jamba-v0.1-52b", {"num_layers": 16}))


def check_train_families_small(cases=SMALL_TRAIN_CASES):
    """Reduced ``cases`` in f32 (by default Mixtral, RWKV6 and Jamba at two
    periods, so that the BP tail holds MoE, RWKV6, Mamba and attention
    blocks; Whisper's tail holds cross-attention, over random frames, and
    LLaVA's batch has random image embeddings before the text): one elastic_zo
    step on the card (the ZO and flash kernels; the tail's backward) and
    one on the CPU (the plain versions) from the same parameters, at
    batch 2 x seq 24 (past reduced Mixtral's window of 16, not a multiple
    of the recurrent chunk). Losses, zo_g and every leaf within
    SMALL_TRAIN_TOL; each BP leaf's change in the step (lr x its tail
    gradient, a small part of the leaf) within SMALL_TAIL_TOL; each BP
    leaf's gradient of the +eps probe's loss within SMALL_GRAD_TOL (a
    change below an ulp of its leaf shows nothing of the gradient)."""
    from repro_torch import configs
    from repro_torch.core import api, elastic, zo
    from repro_torch.data.synthetic import token_batch
    from repro_torch.models.transformer import tree_map
    from repro_torch.train.train_loop import init_state
    for arch, kw in cases:
        cfg = configs.reduced(configs.ARCHS[arch], dtype="float32", **kw)
        lane = configs.LaneConfig()
        step = api.make_train_step(cfg, lane)
        x, y, m = token_batch(2, 24, cfg.vocab_size, seed=1, step=0)
        seq = 24 + cfg.num_image_tokens
        init = api.init(cfg, lane, seed=3, device="cpu", max_seq=seq)
        out, grads = [], []
        for d in ("cpu", "cuda"):
            params = api.init(cfg, lane, seed=3, device="cpu", max_seq=seq)
            batch = {k: torch.from_numpy(v).to(d)
                     for k, v in (("tokens", x), ("labels", y), ("mask", m))}
            batch.update(stub_batch(cfg, 2, d, seed=5))
            grads.append(tail_gradients(cfg, tree_map(lambda a: a.to(d),
                                                      init), batch, 11))
            state = init_state(tree_map(lambda a: a.to(d), params), seed=0)
            out.append(step(state, batch, np.ones((1,), np.float32)))
        (cs, cm), (gs, gm) = out
        errs = {k: abs(float(cm[k]) - float(gm[k]))
                / max(1.0, abs(float(cm[k]))) for k in ("loss", "zo_g")}
        leaves = list(zip(zo.leaves_with_path(init),
                          zo.leaves_with_path(cs.params),
                          zo.leaves_with_path(gs.params)))
        errs["leaves"] = max(
            ((a - b.cpu()).abs().max() / max(1.0, a.abs().max())).item()
            for _, (_, a), (_, b) in leaves if a.numel())
        tail = []
        for (path, w0), (_, a), (_, b) in leaves:
            if path[0] in elastic.ZO_GROUPS or not a.numel():
                continue
            da, db = a - w0, b.cpu() - w0
            ulp = torch.nextafter(a.abs(), torch.tensor(math.inf)) - a.abs()
            tail.append(((db - da).abs() - ulp).max().item()
                        / da.abs().max().item())
        grad_err = max(((gc - gg.cpu()).abs().max() / gc.abs().max()).item()
                       for gc, gg in zip(*grads))
        print(f"small {arch} at {cfg.num_periods} periods: loss "
              f"{float(gm['loss']):.6f} card, {float(cm['loss']):.6f} CPU; "
              f"max relative |card - CPU| {errs} (tolerance "
              f"{SMALL_TRAIN_TOL}); BP leaves' change in the step, "
              f"largest excess over one ulp relative to the leaf's largest "
              f"change {max(tail)} over {len(tail)} leaves (tolerance "
              f"{SMALL_TAIL_TOL}); their gradients, largest |card - CPU| "
              f"relative to the leaf's largest {grad_err} (tolerance "
              f"{SMALL_GRAD_TOL})")
        if not max(errs.values()) <= SMALL_TRAIN_TOL:
            raise AssertionError(f"{arch}: the card's step disagrees with "
                                 "the CPU's")
        if not max(tail) <= SMALL_TAIL_TOL:
            raise AssertionError(f"{arch}: the card's tail update disagrees "
                                 "with the CPU's")
        if not grad_err <= SMALL_GRAD_TOL:
            raise AssertionError(f"{arch}: the card's tail gradients "
                                 "disagree with the CPU's")


def check_profile_phases():
    """launch.train --profile-phases on RWKV6-1.6B at batch 4 x seq 128:
    the phase table, every phase timed, and the state left bitwise as it
    was."""
    from repro_torch.launch import train as launch_train
    args = launch_train.parse_args(family_argv("rwkv6-1.6b", 4, 128, 5)
                                   + ["--profile-phases"])
    trainer = launch_train.setup(args)
    before = digests(trainer.state.params)
    phases = launch_train.profile_phases(trainer)
    for name, us in phases.items():
        print(f"  phase {name:11s} {us:12.1f} us")
    want = {"partition", "probe", "loss_diff", "coeff", "zo_update",
            "bp_tail", "tail_update"}
    if set(phases) != want or not all(v > 0 for v in phases.values()):
        raise AssertionError(f"phases {phases}")
    if digests(trainer.state.params) != before:
        raise AssertionError("--profile-phases wrote the parameter state")
    del trainer
    torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import (_build, flash_attn, int8_matmul,
                                     paged_attn, ref, topk_mask,
                                     zo_fused_replay, zo_perturb)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("machine")
    smi = nvidia_smi("name,power.limit")
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    phase("build")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    check_tensor_core_sass()
    check_cluster_sass()

    # Whisper whole; 16 of LLaVA's 60 layers at full width: 9.84 G
    # parameters, 19.7 GB in bf16 (the whole stack's 68.8 GB fits the
    # card, but the init draws its largest leaf, w_gate, in f32 first:
    # 35.2 GB at 60 layers, 9.4 GB at 16)
    whisper = ARCHS["whisper-small"]
    llava = dataclasses.replace(ARCHS["llava-next-34b"], num_layers=16)

    phase("kernels against their plain versions")
    paged = check_paged(paged_attn, ref, serve_config().max_pages_per_seq)
    paged_whisper = check_paged_at(paged_attn, ref, "Whisper decode",
                                   whisper, whisper_serve_config(),
                                   PAGED_LENS_WHISPER)
    paged_llava = check_paged_at(paged_attn, ref, "LLaVA decode", llava,
                                 llava_serve_config(), PAGED_LENS_LLAVA)
    torch.cuda.empty_cache()
    topk = check_topk(topk_mask, ref, ARCHS["qwen3-4b"].padded_vocab)
    # Jamba's and RWKV6's vocab, a plan of fewer cluster CTAs
    topk_65536 = check_topk(topk_mask, ref, ARCHS["rwkv6-1.6b"].padded_vocab)
    # Whisper's (51,865 padded) and LLaVA's vocab
    topk_51968 = check_topk(topk_mask, ref, whisper.padded_vocab)
    topk_64000 = check_topk(topk_mask, ref, llava.padded_vocab)
    zo_times = check_zo(zo_perturb, zo_fused_replay, ref)
    torch.cuda.empty_cache()
    for name, shard in check_zo_maps(zo_perturb, zo_fused_replay,
                                     ref).items():
        zo_times[name]["at_shard_2x2"] = shard
    torch.cuda.empty_cache()
    zo_times.update(check_int8_noise(zo_perturb, zo_fused_replay, ref))
    torch.cuda.empty_cache()
    zo_times["int8_matmul"] = check_int8_matmul(int8_matmul, ref)
    torch.cuda.empty_cache()
    zo_times["flash_attention"] = check_flash(flash_attn, ref)
    torch.cuda.empty_cache()
    zo_times["flash_attention"]["at_q_offset"] = check_flash_offset(
        flash_attn, ref)
    zo_times["flash_attention"]["with_lse"] = check_flash_lse(flash_attn,
                                                              ref)

    # host work only, read in its phase: started after the kernels'
    # timings, which it would share the host's cores with
    cost_cli = start_cost_cli()

    phase("small model: card against CPU")
    check_small_model_on_card_vs_cpu(flash_attn, paged_attn)

    serve_kernels = (paged_attn, topk_mask, flash_attn,
                     paged["held"] | paged_whisper[0] | paged_llava[0])
    phase("serve qwen3-4b")
    n_paged, n_topk, n_flash_serve = check_serve(ARCHS["qwen3-4b"],
                                                 *serve_kernels)
    torch.cuda.empty_cache()

    # one period of Jamba's four (8 of 32 layers: 7 Mamba blocks, one
    # attention block, MoE FFNs at positions 1/3/5/7), full width: 26.6 GB
    # in bf16, where the whole stack's 103 GB does not fit on one card
    jamba = dataclasses.replace(ARCHS["jamba-v0.1-52b"], num_layers=8)
    phase("serve jamba-v0.1-52b (1 of 4 periods, full width)")
    n_jamba = check_serve(jamba, *serve_kernels)
    torch.cuda.empty_cache()

    phase(f"serve rwkv6-1.6b ({SERVE_RWKV_LAYERS} of 24 layers, full width)")
    n_rwkv = check_serve(dataclasses.replace(
        ARCHS["rwkv6-1.6b"], num_layers=SERVE_RWKV_LAYERS), *serve_kernels)
    torch.cuda.empty_cache()

    phase("serve whisper-small (whole)")
    n_whisper = check_serve(whisper, *serve_kernels,
                            sc=whisper_serve_config(),
                            lengths=WHISPER_PROMPTS)
    torch.cuda.empty_cache()

    phase("serve llava-next-34b (16 of 60 layers, full width)")
    n_llava = check_serve(llava, *serve_kernels, sc=llava_serve_config(),
                          lengths=LLAVA_PROMPTS)
    torch.cuda.empty_cache()

    # no phase before this one runs a backward (the kernel and serve
    # phases are inference), so it sees the process's first
    phase("the process's first backward: the autograd thread's workspace")
    check_autograd_workspace()

    phase("train LeNet-5: the paper's Table 1")
    fp32_mem = check_lenet(zo_perturb, zo_fused_replay)

    phase("train LeNet-5 INT8: Table 1's INT8 and INT8* columns")
    n_int8 = check_lenet_int8(zo_perturb, zo_fused_replay, int8_matmul,
                              fp32_mem)

    phase("fleet LeNet-5 INT8")
    n_fleet_int8 = check_fleet_int8(zo_perturb, zo_fused_replay, int8_matmul,
                                    ref)
    torch.cuda.empty_cache()

    phase("fleet qwen3-4b")
    n_fleet_lm = check_fleet_lm(zo_perturb, zo_fused_replay, flash_attn, ref)
    torch.cuda.empty_cache()

    phase("train PointNet: Table 1's PointNet column")
    n_pointnet = check_pointnet(zo_perturb, zo_fused_replay)
    torch.cuda.empty_cache()

    phase("PointNet INT8 forward: card against CPU")
    n_pointnet["int8_matmul"] = check_pointnet_int8(int8_matmul)
    torch.cuda.empty_cache()

    phase("paper tables")
    check_paper_tables()
    torch.cuda.empty_cache()

    phase("optimizers and schedules: card against CPU")
    check_optimizers()
    torch.cuda.empty_cache()

    phase("the four examples at their JAX defaults")
    check_examples({"zo_perturb": (zo_perturb, "launches"),
                    "zo_fused_replay": (zo_fused_replay, "launches"),
                    "int8_perturb": (zo_perturb, "int8_launches"),
                    "zo_fused_replay_int8": (zo_fused_replay,
                                             "int8_launches"),
                    "int8_matmul": (int8_matmul, "launches"),
                    "flash_attention": (flash_attn, "launches")})
    torch.cuda.empty_cache()

    # one phase carries the unfused qwen3-4b checks (launches, a moved
    # head and tail, a bitwise rerun) and the pipeline, checkpoint and
    # resume ones: both stepped the whole model at 4 x 128
    phase("train qwen3-4b: prefetched batches, checkpoint and elastic resume")
    n_resume, peak0, whole_losses, trainer = check_train_resume(
        zo_perturb, zo_fused_replay, flash_attn)
    n_zo = {k: n_resume[k] for k in ("zo_perturb", "zo_fused_replay")}
    n_zo.update(n_int8)

    phase("cost model against the card")
    check_cost_cli(cost_cli)
    check_cost_step(trainer, {
        "zo_perturb": (zo_perturb, "launches"),
        "zo_fused_replay": (zo_fused_replay, "launches"),
        "flash_attention": (flash_attn, "launches")})
    del trainer
    torch.cuda.empty_cache()
    check_cost_serve({"flash_attention": (flash_attn, "launches"),
                      "paged_attention_step": (paged_attn, "launches"),
                      "topk_topp_mask": (topk_mask, "launches")})

    phase("train qwen3-4b, fused probes, seq 4096")
    n_fused = check_train_fused({"zo_perturb": zo_perturb,
                                 "zo_fused_replay": zo_fused_replay,
                                 "flash_attention": flash_attn}, peak0)
    n_zo["flash_attention"] = n_fused["flash_attention"]
    print(f"flash_attention launches: {n_flash_serve} serving, "
          f"{n_resume['flash_attention']} in the unfused train runs, "
          f"{n_fused['flash_attention']} in the fused one (the kernels line "
          "reports the fused run's)")
    torch.cuda.empty_cache()

    phase("train qwen3-4b, whisper-small, llava-next-34b, mixtral-8x7b, "
          "rwkv6-1.6b and Jamba's Mamba block on a 2x2 mesh (reduced "
          "Jamba too), strategies tp / fsdp / serve, fused probes and the "
          "MoE's ep plan; serve qwen3-4b there: KV heads over model, the "
          "decode cache over model, and over data (4 ranks sharing the "
          "card over gloo)")
    n_mesh, cut_losses, cut_moves, n_serve_mesh = check_train_mesh()
    torch.cuda.empty_cache()

    phase("train qwen3-4b on a 1x1 mesh over NCCL")
    n_nccl, _ = check_train_mesh_nccl(whole_losses, cut_losses, cut_moves)
    torch.cuda.empty_cache()

    # the family phases hold every flat index they give the ZO kernels to
    # this check (check_index_held); it runs here, after the phases that
    # profile small kernels, whose records the profiler dropped in every
    # retry when it ran among the kernel checks
    phase("ZO kernels past 2**31 flat indices (Mixtral's expert leaf)")
    zo_large = check_zo_large(zo_perturb, zo_fused_replay, ref)
    torch.cuda.empty_cache()

    train_kernels = {"zo_perturb": zo_perturb,
                     "zo_fused_replay": zo_fused_replay,
                     "flash_attention": flash_attn}
    # RWKV6-1.6B whole: 23 ZO periods and one BP period; no attention, so
    # each run asserts 0 flash launches (family_per_step)
    phase("train rwkv6-1.6b")
    rwkv = ARCHS["rwkv6-1.6b"]
    n_rwkv_train = check_train_family(
        "train rwkv6-1.6b", rwkv, family_argv(rwkv.name, 4, 128, 5),
        train_kernels, zo_large)
    n_rwkv_fused = check_train_family(
        "train rwkv6-1.6b", rwkv, family_argv(rwkv.name, 1, 4096, 3),
        train_kernels, zo_large, fused=True, steps=3)
    # 8 of Mixtral's 32 layers at full width: 11.9 G parameters, 23.8 GB
    # in bf16 (the whole stack's ~93 GB does not fit on one card); seq
    # 4608 passes the sliding window of 4096 in flash and in the tail
    phase("train mixtral-8x7b (8 of 32 layers, full width)")
    mixtral = dataclasses.replace(ARCHS["mixtral-8x7b"], num_layers=8)
    n_mixtral = check_train_family(
        "train mixtral-8x7b (8 of 32 layers)", mixtral,
        family_argv(mixtral.name, 4, 128, 5), train_kernels, zo_large)
    n_mixtral_fused = check_train_family(
        "train mixtral-8x7b (8 of 32 layers)", mixtral,
        family_argv(mixtral.name, 1, 4608, 3), train_kernels, zo_large,
        fused=True, steps=3)
    # one period: the reference's empty BP-period tail (the BP part is the
    # final norm and the unembedding)
    phase("train jamba-v0.1-52b (1 of 4 periods, full width)")
    n_jamba_train = check_train_family(
        "train jamba-v0.1-52b (1 of 4 periods)", jamba,
        family_argv(jamba.name, 4, 128, 5), train_kernels, zo_large)

    # each train shape is batch x text tokens; LLaVA's --seq counts its
    # 2,880 image tokens (2 x 3,008 keeps the tail's f32 scores ~4 GB)
    phase("train whisper-small (whole)")
    (b, n), (b_f, n_f) = WHISPER_TRAIN
    n_whisper_train = check_train_family(
        "train whisper-small", whisper, family_argv(whisper.name, b, n, 5),
        train_kernels, zo_large, feeds=True)
    n_whisper_fused = check_train_family(
        "train whisper-small", whisper,
        family_argv(whisper.name, b_f, n_f, 3), train_kernels, zo_large,
        fused=True, steps=3)
    torch.cuda.empty_cache()

    phase("train llava-next-34b (16 of 60 layers, full width)")
    (b, n), (b_f, n_f) = LLAVA_TRAIN
    n_llava_train = check_train_family(
        "train llava-next-34b (16 of 60 layers)", llava,
        family_argv(llava.name, b, LLAVA_IMAGE + n, 3), train_kernels,
        zo_large, steps=3, feeds=True)
    n_llava_fused = check_train_family(
        "train llava-next-34b (16 of 60 layers)", llava,
        family_argv(llava.name, b_f, LLAVA_IMAGE + n_f, 3), train_kernels,
        zo_large, fused=True, steps=3)
    torch.cuda.empty_cache()

    phase("train reduced families: card against CPU")
    check_train_families_small()
    torch.cuda.empty_cache()

    phase("reduced whisper and llava: card against CPU")
    check_small_model_on_card_vs_cpu(flash_attn, paged_attn,
                                     archs=("whisper-small", "llava-next-34b"))
    check_train_families_small((("whisper-small", {}),
                                ("llava-next-34b", {})))
    torch.cuda.empty_cache()

    phase("train rwkv6-1.6b --profile-phases")
    check_profile_phases()
    phase(None)

    # launches of the kernels on the serve, PointNet and fleet paths and
    # the paths before them, each counted from 0 just before its phase
    # (RWKV6 runs no attention kernel: its phase asserts 0 launches)
    family_runs = {
        "train rwkv6-1.6b": n_rwkv_train,
        "train rwkv6-1.6b, fused probes, seq 4096": n_rwkv_fused,
        "train mixtral-8x7b (8 of 32 layers)": n_mixtral,
        "train mixtral-8x7b (8 of 32 layers), fused probes, seq 4608":
            n_mixtral_fused,
        "train jamba-v0.1-52b (1 of 4 periods)": n_jamba_train,
        "train whisper-small": n_whisper_train,
        "train whisper-small, fused probes, seq 448": n_whisper_fused,
        "train llava-next-34b (16 of 60 layers)": n_llava_train,
        "train llava-next-34b (16 of 60 layers), fused probes": n_llava_fused}
    resumed = "train qwen3-4b, plain, then prefetched and resumed"
    mesh_1x1 = "train qwen3-4b, 1x1 mesh over NCCL"
    spec_of = {spec[0]: spec for spec in MESH_LANES}
    mesh_paths = {k: {**{mesh_path(spec_of[label]): n[k]
                         for label, n in n_mesh.items()},
                      mesh_1x1: n_nccl[k]}
                  for k in n_nccl}
    # the mesh lanes whose stacks attend (RWKV6's and the Mamba lane's
    # assert 0 flash launches a step: mesh_per_step)
    attending = {mesh_path(spec) for spec in MESH_LANES
                 if mesh_per_step(mesh_cfg(spec[1], spec[6]),
                                  spec[3])["flash_attention"]}
    attending.add(mesh_1x1)
    paths = {"zo_perturb": {resumed: n_resume["zo_perturb"],
                            **mesh_paths["zo_perturb"],
                            "train PointNet": n_pointnet["zo_perturb"],
                            "fleet qwen3-4b": n_fleet_lm["zo_perturb"],
                            **{k: v["zo_perturb"]
                               for k, v in family_runs.items()}},
             "zo_fused_replay": {
                 resumed: n_resume["zo_fused_replay"],
                 **mesh_paths["zo_fused_replay"],
                 "train PointNet": n_pointnet["zo_fused_replay"],
                 "fleet qwen3-4b": n_fleet_lm["zo_fused_replay"],
                 **{k: v["zo_fused_replay"] for k, v in family_runs.items()}},
             "int8_perturb": {
                 "train LeNet-5 INT8": n_zo["int8_perturb"],
                 "fleet LeNet-5 INT8": n_fleet_int8["int8_perturb"]},
             "zo_fused_replay_int8": {
                 "train LeNet-5 INT8": n_zo["zo_fused_replay_int8"],
                 "fleet LeNet-5 INT8": n_fleet_int8["zo_fused_replay_int8"]},
             "int8_matmul": {
                 "train LeNet-5 INT8": n_zo["int8_matmul"],
                 "PointNet INT8 forward": n_pointnet["int8_matmul"],
                 "fleet LeNet-5 INT8": n_fleet_int8["int8_matmul"]},
             "paged_attention_step": {
                 "serve qwen3-4b": n_paged,
                 "serve jamba-v0.1-52b": n_jamba[0],
                 "serve whisper-small": n_whisper[0],
                 "serve llava-next-34b": n_llava[0]},
             "topk_topp_mask": {
                 "serve qwen3-4b": n_topk,
                 "serve jamba-v0.1-52b": n_jamba[1],
                 "serve rwkv6-1.6b": n_rwkv[1],
                 "serve whisper-small": n_whisper[1],
                 "serve llava-next-34b": n_llava[1]},
             "flash_attention": {
                 "serve qwen3-4b": n_flash_serve,
                 **{f"serve qwen3-4b ({MESH_LAYERS} of 36 layers), 2x2 mesh "
                    f"over gloo, {label}, rank 0": n
                    for label, n in n_serve_mesh.items()},
                 "serve jamba-v0.1-52b": n_jamba[2],
                 "serve whisper-small": n_whisper[2],
                 "serve llava-next-34b": n_llava[2],
                 resumed: n_resume["flash_attention"],
                 **{k: v for k, v in mesh_paths["flash_attention"].items()
                    if k in attending},
                 "train qwen3-4b, fused probes, seq 4096":
                     n_fused["flash_attention"],
                 "fleet qwen3-4b": n_fleet_lm["flash_attention"],
                 **{k: v["flash_attention"] for k, v in family_runs.items()
                    if "rwkv" not in k}}}
    for name, by_path in paths.items():
        if not all(by_path.values()):
            raise AssertionError(f"{name} was not launched on every path: "
                                 f"{by_path}")
    kernels = [
        dict(name="paged_attention_step", route="cuda",
             source="src/repro_torch/csrc/paged_attn.cu",
             replaces="src/repro/kernels/paged_attn.py:150",
             launches=n_paged, max_abs_err=paged["max_abs_err"],
             ms=paged["ms"], plain_ms=paged["plain_ms"],
             bound_ms=paged["bound_ms"], bound_by="bytes",
             library_ms=paged["library_ms"],
             at_whisper_decode=paged_whisper[1],
             at_llava_decode=paged_llava[1],
             launches_by_path=paths["paged_attention_step"]),
        dict(name="topk_topp_mask", route="cuda",
             source="src/repro_torch/csrc/topk_mask.cu",
             replaces="src/repro/kernels/topk_mask.py:94",
             launches=n_topk, max_abs_err=topk["max_abs_err"],
             ms=topk["ms"], plain_ms=topk["plain_ms"],
             bound_ms=topk["bound_ms"], bound_by="bytes",
             library_ms=topk["library_ms"],
             at_vocab_65536=topk_65536, at_vocab_51968=topk_51968,
             at_vocab_64000=topk_64000,
             launches_by_path=paths["topk_topp_mask"]),
    ] + [dict(name=name, route="cuda",
              source=f"src/repro_torch/csrc/{name}.cu",
              replaces=f"src/repro/kernels/{where}", launches=n_zo[name],
              **zo_times[name],
              **({"launches_by_path": paths[name]} if name in paths else {}))
         for name, where in (("zo_perturb", "zo_perturb.py:72"),
                             ("zo_fused_replay", "zo_fused_replay.py:58"),
                             ("int8_perturb", "zo_perturb.py:117"),
                             ("zo_fused_replay_int8",
                              "zo_fused_replay.py:123"),
                             ("int8_matmul", "int8_matmul.py:40"))] + [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attn.cu",
             replaces="src/repro/kernels/flash_attn.py:79",
             launches=n_zo["flash_attention"],
             **zo_times["flash_attention"],
             launches_by_path=paths["flash_attention"])]
    print(f"chip_smoke: {time.perf_counter() - _PHASE['start']:.1f} s in all")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
