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
Mamba, attention and MoE blocks) and with RWKV6-1.6B whole, trains LeNet-5 in the paper's four fp32
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
the CPU, and ``launch.train --profile-phases`` on RWKV6-1.6B. The LeNet-5
and PointNet lanes run through the package's own harness
(``benchmarks/paper_tables.py``).

The last three lines of its output are the card's name and power limit
(nvidia-smi), a JSON line of per-kernel numbers, and
``{"ok": true, "device": {...}}``. Any failing phase raises: the script
then exits non-zero and prints no result. It needs one CUDA card and
imports nothing of JAX.
"""
import contextlib
import dataclasses
import json
import math
import os
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
INT32_LANES = 132 * 64           # INT32 (ALU) pipe: 64 lanes a clock an SM
SCHED_LANES = 132 * 4 * 32       # one warp instruction a clock per scheduler
# SASS instructions that run on the INT32 (ALU) pipe; IMAD goes to the
# FMA pipe, and ops of unknown pipe are left out, so a bound from this
# set stays a lower bound
ALU_OPS = {"LOP3", "SHF", "IADD3", "ISETP", "VIMNMX", "IMNMX", "VIADD",
           "SEL", "PRMT", "IABS", "LEA"}
WARM_CALLS = 8                   # device_ms's discarded calls a profile
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
        raise RuntimeError(f"the profiler dropped kernel records in "
                           f"{attempts} runs")
    base = full(False) if flush is not None else 0.0
    return (full(True) - base) / iters / 1e3


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
    raise RuntimeError(f"the profiler dropped kernel records in {attempts} "
                       "runs")


# --------------------------------------------------------------------- #
# paged attention at the serve path's shapes
# --------------------------------------------------------------------- #
def paged_case(dtype, window, P, seed=0):
    """B=8 rows of qwen3-4b decode (KV=8 heads, G=4, Dh=128, page 16):
    row 0 inactive (seq_len 0, all-null table), the others at lengths of
    the serve mix. With a window, row 6's out-of-window pages are
    reclaimed (nulled), as the scheduler does."""
    dev = torch.device("cuda")
    B, KVd, G, Dh, ps, N = 8, 8, 4, 128, 16, 256
    lens = [0, 140, 270, 400, 530, 160, 290, 415]
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
    # yardstick: SDPA on the already-gathered cache (not used by the port)
    B, KVd, G, Dh = q.shape
    ps = kp.shape[1]
    k = kp[table.long()].reshape(B, -1, KVd, Dh).transpose(1, 2)
    v = vp[table.long()].reshape(B, -1, KVd, Dh).transpose(1, 2)
    k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    t = torch.arange(k.shape[2], device="cuda")
    mask = (t[None, :] <= sl[:, None]) & \
        (table != 0).repeat_interleave(ps, 1)
    qh = q.reshape(B, KVd * G, 1, Dh)
    library_ms = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, k, v, attn_mask=mask[:, None, None, :]), flush=flush)
    live = live_positions(table, sl, ps, 0)
    isz = 2
    nbytes = (q.numel() + kn.numel() + vn.numel()) * isz \
        + 2 * B * KVd * Dh * isz \
        + live * 2 * KVd * Dh * isz \
        + table.numel() * 4 + sl.numel() * 4 + q.numel() * isz
    ops = live * KVd * 4 * G * Dh
    bound = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
    print(f"paged_attention_step bf16 B=8 live positions {live}: kernel "
          f"{ms:.4f} ms ({name[:60]}), plain {plain_ms:.4f} ms, SDPA on "
          f"gathered cache {library_ms:.4f} ms, bound {bound:.4f} ms "
          f"({nbytes} bytes); kernel / SDPA {ms / library_ms:.2f}")
    return dict(max_abs_err=out[(torch.bfloat16, 0)], ms=ms,
                plain_ms=plain_ms, bound_ms=bound, library_ms=library_ms,
                f32_err=max(out[(torch.float32, 0)],
                            out[(torch.float32, 64)]), held=held)


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


def visible_pairs(Sq, Sk, causal, window):
    """The (query, key) pairs the causal and window masks leave."""
    n = 0
    for q in range(Sq):
        lo = max(0, q - window + 1) if window > 0 else 0
        hi = min(q, Sk - 1) if causal else Sk - 1
        n += max(0, hi - lo + 1)
    return n


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
    ops = 4 * B * H * D * visible_pairs(Sq, Sk, causal, window)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_tc = ops / BF16_OPS_PER_S * 1e3
    bound = max(by_bytes, by_tc)
    ratio = f"{ms / library_ms:.2f}x SDPA" if library_ms else "SDPA refused"
    print(f"flash_attention (a): kernel {ms:.4f} ms "
          f"({ops / ms / 1e9:.1f} TFLOP/s, {ratio}), plain {plain_ms:.4f} "
          f"ms, SDPA {library_ms} ms; bound {bound:.4f} ms by operations "
          f"({ops:.4g} on the bf16 tensor cores; the three-term P.V design's "
          f"tensor work is twice that, a {2 * by_tc:.4f} ms floor; bytes "
          f"{by_bytes:.4f} ms)")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if by_bytes >= by_tc else "operations",
                library_ms=library_ms)


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
    hz = max_sm_hz()
    mix = {"zo_perturb": noise_paths(
        "zo_perturb", "zo_perturb_kernelI13__nv_bfloat16Li8E", 8)[0]}
    mix["zo_fused_replay"], record = noise_paths(
        "zo_fused_replay", "zo_replay_kernelI13__nv_bfloat16Li8E", 8)
    out = {}
    ms = event_ms(lambda: zo_perturb.zo_perturb(theta, seed, salt, 1e-3), 10)
    plain_ms = event_ms(chunked(lambda lo, hi: ref.zo_perturb_ref(
        flat[lo:hi], seed, salt, 1e-3, lo)), 2)
    bound, by = noise_bound_ms(n, 2, mix["zo_perturb"], hz)
    out["zo_perturb"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, library_ms=None)
    ms = event_ms(lambda: zo_replay.zo_fused_replay(theta, sd, cf, salt), 10)
    plain_ms = event_ms(chunked(lambda lo, hi: ref.zo_fused_replay_ref(
        flat[lo:hi], sd, cf, salt, lo)), 2)
    bound, by = noise_bound_ms(n, 2, mix["zo_fused_replay"], hz)
    out["zo_fused_replay"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound, bound_by=by,
                                  library_ms=None)
    catch_up_ms = event_ms(lambda: zo_replay.zo_fused_replay(
        theta, seeds, coeffs, salt), 3)
    catch_up_bound, catch_up_by = noise_bound_ms(
        n, 2, tuple(32 * c for c in record), hz)
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
    scheduler), at SM clock ``hz``."""
    total, alu = per_element
    by_bytes = 2 * n * itemsize / HBM_BYTES_PER_S
    by_ops = max(alu * n / (INT32_LANES * hz), total * n / (SCHED_LANES * hz))
    return max(by_bytes, by_ops) * 1e3, \
        "bytes" if by_bytes >= by_ops else "operations"


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
            t = device_ms(lambda: one[name](leaf, leaf_salt))
            b, by_ = noise_bound_ms(leaf.numel(), 1, mix, hz)
            print(f"  {name} (S=1 P=1) on LeNet-5's {layer} "
                  f"({leaf.numel()} elements) alone: {t:.4f} ms a launch, "
                  f"bound {b:.3g} ms by {by_}")
        per_leaf = device_ms(lambda: [one[name](t, s)
                                      for t, s in zip(leaves, salts)])
        once = device_ms(lambda: whole[name](leaves, salts))
        b, by_ = noise_bound_ms(total, 1, mix, hz)
        print(f"{name} on LeNet-5's {len(leaves)} int8 leaves ({total} "
              f"elements, 4 a thread): one whole-model launch {once:.4f} ms; "
              f"the {len(leaves)} per-leaf launches it replaces "
              f"{per_leaf:.4f} ms in all; bound {b:.3g} ms by {by_}")
        # the kernels take 16 elements a thread from 264 tiles of 4,096 on:
        # 9 copies of LeNet-5's leaves make 261 (4 a thread), 10 make 290
        at = {c: device_ms(lambda: whole[name](leaves * c, salts * c))
              for c in (9, 10)}
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
def requests(cfg, rng):
    """8 requests, prompts of 128/256/384/512 tokens (two of each), 32
    new tokens; even ones greedy, odd ones sampled with distinct seeds."""
    from repro_torch.serve import SamplingParams
    out = []
    for i, n in enumerate((128, 128, 256, 256, 384, 384, 512, 512)):
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
SMALL_LOGIT_TOL = 1e-4           # f32 prefill logits, card against CPU


def attention_blocks(cfg):
    """The attention blocks of a stack: one flash launch a prefill and
    one paged launch a decode tick each."""
    return cfg.num_periods * cfg.pattern.count("attn")


def check_small_model_on_card_vs_cpu(flash_attn, paged_attn):
    """Reduced qwen3-4b, Jamba (Mamba, attention and MoE blocks, one
    period), RWKV6 and Mixtral (MoE, sliding window 16) in f32: the same
    requests on the card (CUDA kernels; the flash kernel at head dim 16)
    and on the CPU (plain versions) give the same streams, and prefill
    logits within SMALL_LOGIT_TOL."""
    from repro_torch import configs
    from repro_torch.core import api
    from repro_torch.models.transformer import tree_map
    from repro_torch.serve import Engine, SamplingParams, ServeConfig
    sc = ServeConfig(page_size=4, num_pages=64, max_batch_slots=4,
                     max_seq_len=48, max_new_tokens=12, megastep=4)
    for arch in SMALL_ARCHS:
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
        last = torch.tensor([len(reqs[3][0]) - 1])
        want, _ = api.prefill_logits(cpu.params, cfg, toks, last)
        got, _ = api.prefill_logits(card.params, cfg, toks.cuda(),
                                    last.cuda())
        err = (got.cpu() - want).abs().max().item()
        print(f"small {arch}: card == CPU for {len(a)} streams of 12 "
              f"tokens; flash_attention (head dim 16) launched {n} times for "
              f"{len(prefills)} prefills of {n_attn} attention blocks, "
              f"paged_attention_step {n_paged} times in {card.ticks_run} "
              f"ticks; prefill logits max |card - CPU| = {err:.3g} "
              f"(tolerance {SMALL_LOGIT_TOL})")
        if n != n_attn * len(prefills) or n_paged != n_attn * card.ticks_run:
            raise AssertionError(f"{arch}: the small model missed the "
                                 "attention kernels")
        if not err <= SMALL_LOGIT_TOL:
            raise AssertionError(f"{arch}: prefill logits disagree")


def serve_config():
    from repro_torch.serve import ServeConfig
    return ServeConfig(page_size=16, max_batch_slots=8, max_seq_len=544)


def check_serve(cfg, paged_attn, topk_mask, flash_attn, paged_held):
    """Serves ``requests`` (8 prompts of 128-512 tokens, 32 new; 4
    sampled) with ``cfg`` at full width (random bf16 weights from seed
    0). Asserts the launches from the pattern (flash once per attention
    block a prefill, paged once per attention block a tick, top-k/top-p
    on sampled ticks), one prefill per prompt length (exact lengths: no
    bucketing), every flash and paged shape one that its check holds,
    and a fresh engine reproducing all 8 streams. Prints tok/s cold and
    warm, ms a tick, peak device memory and the busy share. Returns the
    launches of paged_attention_step, topk_topp_mask and
    flash_attention."""
    from repro_torch.core import api
    from repro_torch.serve import Engine
    sc = serve_config()
    t0 = time.perf_counter()
    params = api.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_attn = attention_blocks(cfg)
    print(f"{cfg.name}: {cfg.num_layers} layers ({n_attn} attention), "
          f"d_model {cfg.d_model}, vocab {cfg.padded_vocab}, {n_params} "
          f"parameters ({cfg.dtype}), init {time.perf_counter() - t0:.2f} s")
    reqs = requests(cfg, np.random.default_rng(0))

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
    if n_flash != n_attn * len(prefills):
        raise AssertionError(f"flash attention launched {n_flash} times, "
                             f"want {n_attn} x {len(prefills)}")
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
        torch.tensor([len(reqs[0][0]) - 1], device="cuda"))
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


def check_lenet(zo_perturb, zo_replay, steps=150, batch=32):
    """Each lane through repro_torch.benchmarks.paper_tables.lenet_lanes,
    one lane a call so that its launches can be read: from the same init
    (seed 7) and key (11) for ``steps`` steps on glyphs(2048, seed=0),
    evaluated on glyphs(512, seed=1, start=10000), the settings behind
    BENCH_paper.json's Table 1."""
    from repro_torch.benchmarks.paper_tables import lenet_lanes
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
              f"{n_p / steps:g}, zo_fused_replay {n_r / steps:g}")
        want = LENET_PERTURB_PER_STEP[name]
        if n_p != want * steps or n_r != want // 8 * steps:
            raise AssertionError(f"lenet {name}: {n_p} zo_perturb and {n_r} "
                                 f"zo_fused_replay launches in {steps} "
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
              f"launches per step: zo_perturb {n_p / steps:g}, "
              f"zo_fused_replay {n_r / steps:g}")
        want_p, want_r = POINTNET_PER_STEP[name]
        if (n_p, n_r) != (want_p * steps, want_r * steps):
            raise AssertionError(f"pointnet {name}: {n_p} zo_perturb and "
                                 f"{n_r} zo_fused_replay launches in {steps} "
                                 f"steps, want {want_p} and {want_r} a step")
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
                  f"int8_perturb {n[0] / steps:g}, zo_fused_replay_int8 "
                  f"{n[1] / steps:g}, int8_matmul {(n[2] - 5) / steps:g} "
                  "(+5 for the test set)")
            p, u, m = LENET_INT8_PER_STEP[name]
            if n != (p * steps, u * steps, m * steps + 5):
                raise AssertionError(
                    f"lenet int8 {mode} {name}: launches {n}, want "
                    f"{(p * steps, u * steps, m * steps + 5)}")
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
    for name, _, _ in INT8_LANES:
        mem = lenet_int8_lanes(5, 32, lanes=[name])[name].memory_bytes
        print(f"lenet {name:13s} training memory (parameters plus the loop's "
              f"peak growth), 5 steps at batch 32: int8 {mem} bytes, fp32 "
              f"{fp32_mem[name]} bytes (150 steps, 4 probes): fp32 / int8 = "
              f"{fp32_mem[name] / mem:.3f}")
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


def flash_shape(q, k, v, *, causal=True, window=0, scale=None):
    """A call's FLASH_CASES entry (without its label); a scale other than
    the wrapper's default 1 / sqrt(D) is kept, so it matches no entry."""
    B, H, Sq, D = q.shape
    return (B, H, k.shape[1], Sq, k.shape[2], D, q.dtype, causal, window) \
        + (() if scale is None or scale == 1.0 / math.sqrt(D) else (scale,))


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
    train_loop.run (the loss read on the host after every step). Returns
    (state, losses, timed wall s, peak device memory of the timed steps,
    peak device memory of the first step)."""
    def loop(total):
        return LoopConfig.for_lane(trainer.lane, total_steps=total,
                                   log_every=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, h0 = run(trainer.step_fn, trainer.state, trainer.batch_fn,
                    loop(1), log=None)
    torch.cuda.synchronize()
    peak0 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, h1 = run(trainer.step_fn, state, trainer.batch_fn, loop(steps),
                    log=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return state, [loss for _, loss in h0 + h1], wall, \
        torch.cuda.max_memory_allocated(), peak0


def check_train_lm(zo_perturb, zo_replay, flash_attn):
    """ElasticZO on qwen3-4b through repro_torch.launch.train's own
    functions; launch counts (the flash kernel in the 35 ZO periods of
    each probe forward, none in the BP tail), finite losses, a changed
    head and tail, and a bitwise rerun. Returns the launch counts of the
    first run."""
    from repro_torch.core import elastic, zo
    from repro_torch.launch import train as launch_train
    from repro_torch.train.train_loop import LoopConfig, run
    args = launch_train.parse_args(TRAIN_ARGV)
    t0 = time.perf_counter()
    trainer = launch_train.setup(args)
    torch.cuda.synchronize()
    print(f"train setup (init of {sum(p.numel() for p in _leaves(trainer.state.params))} "
          f"bf16 parameters) {time.perf_counter() - t0:.2f} s")
    zo_part, bp_part = ([zo.keystr(p) for p, _ in zo.leaves_with_path(t)]
                        for t in elastic.partition(trainer.state.params,
                                                   trainer.lane))
    zo_perturb.launches = zo_replay.launches = flash_attn.launches = 0
    state, losses, wall, peak, peak0 = train_run(trainer, run, LoopConfig)
    n_p, n_r, n_f = (zo_perturb.launches, zo_replay.launches,
                     flash_attn.launches)
    tokens = args.batch * args.seq
    print(f"train qwen3-4b elastic_zo, 1 probe, batch {args.batch} x seq "
          f"{args.seq}: losses {[round(v, 4) for v in losses]}; "
          f"{1e3 * wall / 4:.1f} ms per step, {4 * tokens / wall:.1f} tokens/s "
          f"over 4 timed steps; peak device memory {peak} bytes ({peak0} in "
          "the first step)")
    print(f"launches on the main path (5 steps): zo_perturb {n_p}, "
          f"zo_fused_replay {n_r}, flash_attention {n_f}")
    zo_periods = trainer.state.params["periods_zo"]["blk0"]["ln_attn"].shape[0]
    if n_p != 24 * 5 or n_r != 12 * 5 or len(zo_part) != 12 \
            or n_f != 2 * zo_periods * 5 or zo_periods != 35:
        raise AssertionError(f"{len(zo_part)} ZO leaves, {n_p} zo_perturb, "
                             f"{n_r} zo_fused_replay and {n_f} flash "
                             "launches in 5 steps, want 12, 24 a step, 12 a "
                             "step and 70 a step (35 ZO periods x 2)")
    if len(losses) != 5 or not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"losses {losses}")
    del trainer
    torch.cuda.empty_cache()

    again = launch_train.setup(args)
    final = dict((zo.keystr(p), t) for p, t in
                 zo.leaves_with_path(state.params))
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
        raise AssertionError("a rerun from the same parameters and seed gave "
                             "other parameters or losses")
    del final, state
    profile_train_step(again, state2, run, LoopConfig, wall2 / 4)
    return n_p, n_r, n_f, peak0


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
    blocks (the BP tail attends without it)."""
    from repro_torch.core import elastic, zo
    from repro_torch.models.transformer import num_periods
    zo_part, _ = elastic.partition(trainer.state.params, trainer.lane)
    paths = [p for p, _ in zo.leaves_with_path(zo_part)]
    pz = num_periods(zo_part["periods_zo"])
    stacked = sum(p[0] == "periods_zo" for p in paths)
    perturb = 2 * (len(paths) - stacked + stacked * pz) \
        if trainer.lane.fused_probes else 2 * len(paths)
    return {"zo_perturb": perturb, "zo_fused_replay": len(paths),
            "flash_attention": 2 * pz * cfg.pattern.count("attn")}


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
                       steps=5):
    """ElasticZO on a full-width family stack through
    repro_torch.launch.train's own functions, as check_train_lm: launch
    counts a step (family_per_step), finite losses, a changed ZO head and
    BP part, and a rerun from the same seed with bitwise equal losses and
    parameters (two copies of a large stack do not fit beside a step's
    perturbed head, so the first run's are kept as digests). Prints ms a step,
    tokens/s, peak device memory and the device-busy share of one
    profiled step. With ``fused``, one unfused step from the same init
    follows, whose (l+, l-) must equal the fused first step's. Parameters
    are compared by ``digests``. Every flat index the run gives the ZO
    kernels lies below ``held``, the range check_zo_large holds. Returns
    the first run's launch counts."""
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
            lambda theta, seed, salt, scale, offset=0:
            offset + theta.numel()) as zp_ends, shapes_of(
            kernels["zo_fused_replay"], "zo_fused_replay",
            lambda theta, *a, **k: theta.numel()) as zr_ends:
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


def check_train_families_small():
    """Reduced Mixtral, RWKV6 and Jamba at two periods in f32, so that the
    BP tail holds MoE, RWKV6, Mamba and attention blocks: one elastic_zo
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
    for arch, kw in (("mixtral-8x7b", {}), ("rwkv6-1.6b", {}),
                     ("jamba-v0.1-52b", {"num_layers": 16})):
        cfg = configs.reduced(configs.ARCHS[arch], dtype="float32", **kw)
        lane = configs.LaneConfig()
        step = api.make_train_step(cfg, lane)
        x, y, m = token_batch(2, 24, cfg.vocab_size, seed=1, step=0)
        init = api.init(cfg, lane, seed=3, device="cpu")
        out, grads = [], []
        for d in ("cpu", "cuda"):
            params = api.init(cfg, lane, seed=3, device="cpu")
            batch = {k: torch.from_numpy(v).to(d)
                     for k, v in (("tokens", x), ("labels", y), ("mask", m))}
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

    phase("kernels against their plain versions")
    paged = check_paged(paged_attn, ref, serve_config().max_pages_per_seq)
    topk = check_topk(topk_mask, ref, ARCHS["qwen3-4b"].padded_vocab)
    # Jamba's and RWKV6's vocab, a plan of fewer cluster CTAs
    topk_65536 = check_topk(topk_mask, ref, ARCHS["rwkv6-1.6b"].padded_vocab)
    zo_times = check_zo(zo_perturb, zo_fused_replay, ref)
    torch.cuda.empty_cache()
    zo_times.update(check_int8_noise(zo_perturb, zo_fused_replay, ref))
    torch.cuda.empty_cache()
    zo_times["int8_matmul"] = check_int8_matmul(int8_matmul, ref)
    torch.cuda.empty_cache()
    zo_times["flash_attention"] = check_flash(flash_attn, ref)
    torch.cuda.empty_cache()

    phase("small model: card against CPU")
    check_small_model_on_card_vs_cpu(flash_attn, paged_attn)

    serve_kernels = (paged_attn, topk_mask, flash_attn, paged["held"])
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

    phase("serve rwkv6-1.6b")
    n_rwkv = check_serve(ARCHS["rwkv6-1.6b"], *serve_kernels)
    torch.cuda.empty_cache()

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

    phase("train qwen3-4b")
    n_lm = check_train_lm(zo_perturb, zo_fused_replay, flash_attn)
    n_zo = dict(zip(("zo_perturb", "zo_fused_replay"), n_lm))
    n_zo.update(n_int8)
    torch.cuda.empty_cache()

    phase("train qwen3-4b, fused probes, seq 4096")
    n_fused = check_train_fused({"zo_perturb": zo_perturb,
                                 "zo_fused_replay": zo_fused_replay,
                                 "flash_attention": flash_attn}, n_lm[3])
    n_zo["flash_attention"] = n_fused["flash_attention"]
    print(f"flash_attention launches: {n_flash_serve} serving, {n_lm[2]} in "
          f"the unfused train run, {n_fused['flash_attention']} in the fused "
          "one (the kernels line reports the fused run's)")
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

    phase("train reduced families: card against CPU")
    check_train_families_small()
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
        "train jamba-v0.1-52b (1 of 4 periods)": n_jamba_train}
    paths = {"zo_perturb": {"train qwen3-4b": n_zo["zo_perturb"],
                            "train PointNet": n_pointnet["zo_perturb"],
                            "fleet qwen3-4b": n_fleet_lm["zo_perturb"],
                            **{k: v["zo_perturb"]
                               for k, v in family_runs.items()}},
             "zo_fused_replay": {
                 "train qwen3-4b": n_zo["zo_fused_replay"],
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
                 "serve jamba-v0.1-52b": n_jamba[0]},
             "topk_topp_mask": {
                 "serve qwen3-4b": n_topk,
                 "serve jamba-v0.1-52b": n_jamba[1],
                 "serve rwkv6-1.6b": n_rwkv[1]},
             "flash_attention": {
                 "serve qwen3-4b": n_flash_serve,
                 "serve jamba-v0.1-52b": n_jamba[2],
                 "train qwen3-4b": n_lm[2],
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
             launches_by_path=paths["paged_attention_step"]),
        dict(name="topk_topp_mask", route="cuda",
             source="src/repro_torch/csrc/topk_mask.cu",
             replaces="src/repro/kernels/topk_mask.py:94",
             launches=n_topk, max_abs_err=topk["max_abs_err"],
             ms=topk["ms"], plain_ms=topk["plain_ms"],
             bound_ms=topk["bound_ms"], bound_by="bytes",
             library_ms=topk["library_ms"],
             at_vocab_65536=topk_65536,
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
