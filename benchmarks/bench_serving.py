#!/usr/bin/env python
"""Continuous-batching serving throughput (tok/s) through the Scheduler —
the host-side admission/eviction loop + prefill/decode programs together,
not just the decode kernel (bench_decode.py measures that floor).

Modes: --backend linear|paged (KV backend), --prefill-chunk C (Sarathi
chunked prefill). Mixed prompt lengths drawn from a fixed-seed zipf-ish
ladder exercise bucketing, slot reuse, and (paged) page recycling.

Usage: python benchmarks/bench_serving.py [--requests 32] [--batch 8]
       [--backend paged] [--prefill-chunk 256] [--int8] [--layers 8]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--backend", choices=("linear", "paged"), default="linear")
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--multi-step", type=int, default=1,
                    help="device-resident decode window (1 = per-token)")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=2048)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--tiny", action="store_true", help="tiny shapes (a quick check of the path)")
    args = ap.parse_args()

    import jax

    from flashattention_kernel_project_tpu.utils import platform

    platform.require_gpu()
    platform.enable_compile_cache()

    import jax.numpy as jnp
    from flashattention_kernel_project_tpu import models
    from flashattention_kernel_project_tpu.models.serving import Scheduler

    if args.tiny:
        cfg = models.TransformerConfig(
            vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=128, dtype=jnp.float32,
        )
        args.max_len, args.max_new = 256, 8
    else:
        cfg = models.TransformerConfig(
            vocab_size=32000, d_model=args.d_model, n_layers=args.layers,
            n_heads=16, n_kv_heads=4, d_head=128, d_ff=5504,
            dtype=jnp.bfloat16,
        )

    params = models.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    # mixed prompt ladder: mostly short, a few long (forces bucket variety)
    lens = rng.choice(
        [32, 64, 128, 256, 512] if not args.tiny else [8, 16, 24],
        size=args.requests,
        p=[0.35, 0.3, 0.2, 0.1, 0.05] if not args.tiny else None,
    )
    prompts = [
        rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
        for n in lens
    ]

    def run_once():
        sched = Scheduler(
            cfg, params, max_batch=args.batch, max_len=args.max_len,
            quantized_cache=args.int8,
            prefill_chunk=args.prefill_chunk,
            paged=args.backend == "paged",
            multi_step=args.multi_step,
        )
        for p in prompts:
            sched.submit(p, max_new_tokens=args.max_new)
        sched.run()
        return sched.metrics()

    run_once()  # warmup: compiles every bucket/decode program
    m = run_once()
    print(
        f"serving backend={args.backend} chunk={args.prefill_chunk} "
        f"int8={args.int8} multi_step={args.multi_step}: {m}"
    )


if __name__ == "__main__":
    main()
