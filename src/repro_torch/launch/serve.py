"""Serving launcher: the paged continuous-batching engine (or the dense
baseline).

``python -m repro_torch.launch.serve --arch qwen3-4b --paged``

With ``--paged`` it serves ``--batch`` random prompts through
``repro_torch.serve.Engine``; without it, the dense static-batch greedy
loop (``dense_generate``) runs, as in the JAX launcher. Every arch of
``configs.ARCHS`` serves (dense, MoE, RWKV6, the Jamba hybrid, Whisper's
encoder-decoder on zero frames, LLaVA behind zero image tokens), at full
size or with ``--smoke``. It runs on the card; ``--device cpu``
runs the plain versions on the CPU (use it with ``--smoke``). Weights
are random, drawn from ``--seed``. The flight recorder's ``--trace``,
``--metrics``, ``--memory`` and ``--quiet`` flags are the JAX launcher's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import obs
from ..configs import ServeConfig, get_arch, reduced
from ..core import api
from ..serve import Engine, SamplingParams, dense_generate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config")
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged continuous-batching engine")
    ap.add_argument("--batch", type=int, default=2,
                    help="number of requests")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="pool pages per layer (0 = auto-size)")
    ap.add_argument("--slots", type=int, default=0,
                    help="decode batch slots (0 = --batch)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    obs.add_observability_args(ap)
    args = ap.parse_args(argv)
    obs.configure_from_args(args)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    total = cfg.num_image_tokens + args.prompt_len + args.tokens
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    dev = api.resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    if not args.paged:
        if args.temperature != 0.0 or args.top_k or args.top_p != 1.0:
            ap.error("--temperature/--top-k/--top-p require --paged "
                     "(the dense baseline is greedy-only)")
        params = api.init(cfg, seed=args.seed, device=dev, max_seq=total)
        t0 = time.perf_counter()
        out = dense_generate(cfg, params, prompts, args.tokens)
        dt = time.perf_counter() - t0
        obs.log("serve", f"dense: {args.tokens} tok/seq x{args.batch} in "
                f"{dt:.2f}s ({args.batch * args.tokens / dt:.1f} tok/s) on "
                f"{where}")
        obs.log("serve", f"sample: {out[0][:16].tolist()}")
        obs.write_outputs(args)
        return

    slots = args.slots or args.batch
    ps = args.page_size
    num_pages = args.num_pages or (
        1 + slots * (-(-(total + 1) // ps)))      # null + worst case/slot
    serve = ServeConfig(page_size=ps, num_pages=num_pages,
                        max_batch_slots=slots, max_seq_len=total,
                        max_new_tokens=args.tokens)
    eng = Engine(cfg, serve, init_seed=args.seed, device=dev)
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p,
                              seed=args.seed)
    t0 = time.perf_counter()
    outs = eng.generate([list(p) for p in prompts], sampling, args.tokens)
    dt = time.perf_counter() - t0
    util = eng.page_utilization()
    n_tok = sum(len(o) for o in outs)
    obs.log("serve", f"paged: {n_tok} tokens across {args.batch} requests "
            f"in {dt:.2f}s ({n_tok / dt:.1f} tok/s, {eng.steps_run} engine "
            f"steps) on {where}")
    obs.log("serve", f"pages: peak {util['peak_pages']}/"
            f"{util['total_pages']} ({100 * util['peak_util']:.0f}%), mean "
            f"{100 * util['mean_util']:.0f}%")
    obs.log("serve", f"sample: {outs[0][:16]}")
    obs.write_outputs(args)


if __name__ == "__main__":
    main()
