#!/usr/bin/env python
"""Training throughput (tokens/s) — full transformer fwd+bwd+SGD on one card.

The flagship GQA decoder with the attention forward and backward in the
loss graph. Chained timing: params feed forward through lax.fori_loop so
per-dispatch overhead cancels. Needs a GPU.

Usage: python benchmarks/bench_train.py [--batch 4] [--seq 4096] [--layers 4]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--moe-experts", type=int, default=0,
                    help="replace every MLP with a top-2 MoE of N experts")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from flashattention_kernel_project_tpu import models
    from flashattention_kernel_project_tpu.models import transformer as tfm
    from flashattention_kernel_project_tpu.utils import platform

    platform.require_gpu()
    platform.enable_compile_cache()

    cfg = models.TransformerConfig(
        vocab_size=32000, d_model=2048, n_layers=args.layers, n_heads=16,
        n_kv_heads=4, d_head=128, d_ff=5504, dtype=jnp.bfloat16,
        moe_experts=args.moe_experts,
    )
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jnp.asarray(
        np.random.default_rng(0).integers(
            0, cfg.vocab_size, (args.batch, args.seq)
        ),
        jnp.int32,
    )

    @jax.jit
    def run_n(n, params, tokens):
        # carry the loss and fetch IT (not a param leaf): fetching only one
        # updated leaf let XLA schedule the rest lazily and the delta read
        # 20x over hardware peak — the loss value pins every step.
        def body(_, carry):
            params, _ = carry
            new_params, loss = tfm.sgd_train_step(cfg, params, tokens, lr=1e-4)
            return new_params, loss

        return jax.lax.fori_loop(
            0, n, body, (params, jnp.float32(0)), unroll=False
        )

    np.asarray(run_n(1, params, tokens)[1])  # compile+warm
    times = {}
    for n in (2, 12):
        best = float("inf")
        for _ in range(4):
            t0 = time.perf_counter()
            np.asarray(run_n(n, params, tokens)[1])
            best = min(best, time.perf_counter() - t0)
        times[n] = best
    per_step = (times[12] - times[2]) / 10
    toks = args.batch * args.seq / per_step
    # ~6x params-flops per token (fwd 2x + bwd 4x) + attention
    n_params = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(params))
    flops = 6 * n_params * args.batch * args.seq
    print(
        f"train b={args.batch} seq={args.seq} layers={cfg.n_layers} "
        f"moe={args.moe_experts}: "
        f"{per_step*1e3:.1f} ms/step, {toks:,.0f} tok/s, "
        f"~{flops/per_step/1e12:.1f} TFLOP/s (param-flops only)"
    )


if __name__ == "__main__":
    main()
