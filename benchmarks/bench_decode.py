#!/usr/bin/env python
"""Decode throughput (tok/s) — the BASELINE.md "decode throughput tracked"
metric, at the engine level (full transformer decode_step incl. KV-cache
append + split-KV flash decode), not just the attention kernel.

Chained timing: decode_step's (tokens, cache) feed forward naturally, so the
whole loop runs inside one jit via lax.fori_loop and per-dispatch overhead
cancels in the delta. Needs a GPU.

Usage: python benchmarks/bench_decode.py [--batch 8] [--ctx 4096] [--int8]
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ctx", type=int, default=4096)
    ap.add_argument("--int8", action="store_true", help="int8 KV cache")
    ap.add_argument(
        "--int8-weights", action="store_true",
        help="int8 weight-only decode projections (fused dequant)",
    )
    ap.add_argument("--layers", type=int, default=8)
    args = ap.parse_args()

    import jax

    from flashattention_kernel_project_tpu.utils import platform

    platform.require_gpu()
    platform.enable_compile_cache()
    import jax.numpy as jnp
    from flashattention_kernel_project_tpu import models
    from flashattention_kernel_project_tpu.models import engine

    cfg = models.TransformerConfig(
        vocab_size=32000, d_model=2048, n_layers=args.layers, n_heads=16,
        n_kv_heads=4, d_head=128, d_ff=5504, dtype=jnp.bfloat16,
    )
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    b = args.batch
    cache = engine.init_cache(cfg, b, args.ctx + 1024, quantized=args.int8)
    prompt = jnp.asarray(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (b, args.ctx)),
        jnp.int32,
    )
    _, cache = engine.prefill(cfg, params, prompt, cache)
    params = engine.fuse_decode_params(cfg, params)
    if args.int8_weights:
        params = engine.quantize_decode_params(cfg, params)
    tok0 = jnp.zeros((b,), jnp.int32)

    @jax.jit
    def run_n(n, params, tok, cache):
        # runtime trip count: ONE executable serves both delta points.
        # params are an argument, not a closure, so weights don't bloat
        # the HLO.
        def body(_, carry):
            tok, cache = carry
            logits, cache = engine.decode_step(cfg, params, tok, cache)
            return jnp.argmax(logits, -1).astype(jnp.int32), cache

        return jax.lax.fori_loop(0, n, body, (tok, cache), unroll=False)

    np.asarray(run_n(1, params, tok0, cache)[0])  # compile + warm
    times = {}
    for n in (8, 136):
        best = float("inf")
        for _ in range(4):
            t0 = time.perf_counter()
            np.asarray(jax.tree.leaves(run_n(n, params, tok0, cache))[0])
            best = min(best, time.perf_counter() - t0)
        times[n] = best
    per_step = (times[136] - times[8]) / 128
    toks = b / per_step
    kind = "int8" if args.int8 else "bf16"
    if args.int8_weights:
        kind += "+w8"
    print(
        f"decode {kind} b={b} ctx={args.ctx} layers={cfg.n_layers} "
        f"d_model={cfg.d_model}: {per_step*1e3:.3f} ms/step, "
        f"{toks:,.0f} tok/s"
    )


if __name__ == "__main__":
    main()
