#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the repository root: ``python3 chip_smoke.py``. It builds the
CUDA kernels from ``src/repro_torch/csrc`` with nvcc, holds each kernel
against its plain PyTorch version at the shapes the serve path gives it,
checks a small model on the card against the CPU, then serves eight
requests with qwen3-4b at full width and depth (36 layers, bf16, random
weights from a seed) and checks that the path went through the kernels.

The last three lines of its output are the card's name and power limit
(nvidia-smi), a JSON line of per-kernel numbers, and
``{"ok": true, "device": {...}}``. Any failing phase raises: the script
then exits non-zero and prints no result. It needs one CUDA card and
imports nothing of JAX.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
PAGED_BF16_TOL = 3e-2            # a few bf16 ulps of |o| <~ 1 (the plain
#                                  version rounds the softmax weights to
#                                  bf16 before the weighted sum; the kernel
#                                  keeps them in f32)
PAGED_F32_TOL = 1e-5             # summation order only


def phase(name):
    print(f"== {name}", flush=True)


def _kernel_us(prof):
    return sum(e.self_device_time_total for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA"))


def device_ms(fn, iters=30, flush=None):
    """Device time of one fn() call in ms: the kernels' own durations as
    the profiler (CUPTI) records them, summed over ``iters`` calls, so
    the host's time to issue a call is not counted. ``flush`` (a buffer
    larger than L2) is rewritten before every call so fn meets a cold
    cache; the flush kernels' time, from a run of flushes alone, is
    subtracted."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()

    def run(call):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush.zero_()
                if call:
                    fn()
            torch.cuda.synchronize()
        return _kernel_us(prof)
    total = run(True)
    if total <= 0:
        raise RuntimeError("the profiler recorded no device time")
    base = run(False) if flush is not None else 0.0
    return (total - base) / iters / 1e3


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


def check_paged(paged_attn, ref, P):
    out = {}
    for dtype, tol in ((torch.float32, PAGED_F32_TOL),
                       (torch.bfloat16, PAGED_BF16_TOL)):
        for window in (0, 64):
            q, kn, vn, kp, vp, table, sl = paged_case(dtype, window, P)
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

    # timing at the main path's case: bf16, full attention
    q, kn, vn, kp, vp, table, sl = paged_case(torch.bfloat16, 0, P)
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
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA on gathered cache "
          f"{library_ms:.4f} ms, bound {bound:.4f} ms ({nbytes} bytes)")
    return dict(max_abs_err=out[(torch.bfloat16, 0)], ms=ms,
                plain_ms=plain_ms, bound_ms=bound, library_ms=library_ms,
                f32_err=max(out[(torch.float32, 0)],
                            out[(torch.float32, 64)]))


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


def check_small_model_on_card_vs_cpu():
    """Reduced qwen3-4b in f32: the same requests on the card (CUDA
    kernels) and on the CPU (plain versions) give the same streams."""
    from repro_torch import configs
    from repro_torch.models.transformer import tree_map
    from repro_torch.serve import Engine, SamplingParams, ServeConfig
    cfg = configs.reduced(configs.ARCHS["qwen3-4b"], dtype="float32")
    sc = ServeConfig(page_size=4, num_pages=64, max_batch_slots=4,
                     max_seq_len=48, max_new_tokens=12, megastep=4)
    cpu = Engine(cfg, sc, device="cpu", init_seed=3)
    card = Engine(cfg, sc, device="cuda",
                  params=tree_map(lambda a: a.cuda(), cpu.params))
    rng = np.random.default_rng(3)
    reqs = [(list(rng.integers(0, cfg.vocab_size, n)), sp) for n, sp in
            ((5, SamplingParams()),
             (9, SamplingParams(temperature=0.8, top_k=7, seed=11)),
             (14, SamplingParams(temperature=1.1, top_p=0.9, seed=23)),
             (8, SamplingParams(temperature=0.7, top_k=20, top_p=0.8,
                                seed=5)))]
    a, b = serve(cpu, reqs, 12), serve(card, reqs, 12)
    if a != b:
        raise AssertionError(f"card streams {b} != CPU streams {a}")
    print(f"small model: card == CPU for {len(a)} streams of 12 tokens")


def check_serve(paged_attn, topk_mask):
    from repro_torch import configs
    from repro_torch.core import api
    from repro_torch.serve import Engine, ServeConfig
    cfg = configs.ARCHS["qwen3-4b"]
    sc = ServeConfig(page_size=16, max_batch_slots=8, max_seq_len=544)
    t0 = time.perf_counter()
    params = api.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"qwen3-4b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.padded_vocab}, {n_params} parameters (bf16), init "
          f"{time.perf_counter() - t0:.2f} s")
    reqs = requests(cfg, np.random.default_rng(0))

    engine = Engine(cfg, sc, params=params)
    torch.cuda.reset_peak_memory_stats()
    paged_attn.launches = 0
    topk_mask.launches = 0
    t0 = time.perf_counter()
    streams = serve(engine, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_paged, n_topk = paged_attn.launches, topk_mask.launches
    n_tok = sum(len(s) for s in streams)
    print(f"serve: {n_tok} tokens for 8 requests in {wall:.3f} s "
          f"({n_tok / wall:.1f} tok/s), {engine.steps_run} engine steps, "
          f"{engine.ticks_run} decode ticks, peak device memory "
          f"{torch.cuda.max_memory_allocated()} bytes")
    print(f"launches on the main path: paged_attention_step {n_paged}, "
          f"topk_topp_mask {n_topk}")
    if n_paged != cfg.num_layers * engine.ticks_run or n_paged == 0:
        raise AssertionError(f"paged attention launched {n_paged} times, "
                             f"want {cfg.num_layers} x {engine.ticks_run}")
    if n_topk == 0:
        raise AssertionError("top-k/top-p kernel never launched")
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
    return n_paged, n_topk


def profile_serve(engine, reqs, warm_s):
    """Device time by kernel over one more run of the same requests,
    from torch.profiler; the busy share is against the unprofiled warm
    run's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve(engine, reqs)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    dev_us = _kernel_us(prof)
    print(f"profile: {len(kernels)} kernel names, device time "
          f"{dev_us / 1e3:.1f} ms = {100 * dev_us / 1e6 / warm_s:.1f}% of "
          f"the warm run's wall time")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ARCHS, ServeConfig
    from repro_torch.kernels import _build, paged_attn, ref, topk_mask
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("machine")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
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

    phase("kernels against their plain versions")
    P = ServeConfig(page_size=16, max_seq_len=544).max_pages_per_seq
    paged = check_paged(paged_attn, ref, P)
    topk = check_topk(topk_mask, ref, ARCHS["qwen3-4b"].padded_vocab)

    phase("small model: card against CPU")
    check_small_model_on_card_vs_cpu()

    phase("serve qwen3-4b")
    n_paged, n_topk = check_serve(paged_attn, topk_mask)

    kernels = [
        dict(name="paged_attention_step", route="cuda",
             source="src/repro_torch/csrc/paged_attn.cu",
             replaces="src/repro/kernels/paged_attn.py:150",
             launches=n_paged, max_abs_err=paged["max_abs_err"],
             ms=paged["ms"], plain_ms=paged["plain_ms"],
             bound_ms=paged["bound_ms"], bound_by="bytes",
             library_ms=paged["library_ms"]),
        dict(name="topk_topp_mask", route="cuda",
             source="src/repro_torch/csrc/topk_mask.cu",
             replaces="src/repro/kernels/topk_mask.py:94",
             launches=n_topk, max_abs_err=topk["max_abs_err"],
             ms=topk["ms"], plain_ms=topk["plain_ms"],
             bound_ms=topk["bound_ms"], bound_by="bytes",
             library_ms=topk["library_ms"]),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
