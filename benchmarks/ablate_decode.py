#!/usr/bin/env python
"""Decode-step ablation: where does the time beyond the weight/KV
bandwidth bound go? Reruns the engine decode loop with stages knocked out
(attention kernel, KV append, lm_head) and reports per-step deltas.

Usage: python benchmarks/ablate_decode.py [--batch 8] [--ctx 2048]
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
    ap.add_argument("--ctx", type=int, default=2048)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--int8-weights", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from flashattention_kernel_project_tpu import models
    from flashattention_kernel_project_tpu.models import engine
    from flashattention_kernel_project_tpu.utils import platform

    platform.require_gpu()
    platform.enable_compile_cache()
    from flashattention_kernel_project_tpu.models import transformer as tfm
    from flashattention_kernel_project_tpu.ops.flash_decode import flash_decode

    cfg = models.TransformerConfig(
        vocab_size=32000, d_model=2048, n_layers=args.layers, n_heads=16,
        n_kv_heads=4, d_head=128, d_ff=5504, dtype=jnp.bfloat16,
    )
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    b = args.batch
    cache = engine.init_cache(cfg, b, args.ctx + 1024)
    prompt = jnp.asarray(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (b, args.ctx)),
        jnp.int32,
    )
    _, cache = engine.prefill(cfg, params, prompt, cache)
    params = engine.fuse_decode_params(cfg, params)
    if args.int8_weights:
        params = engine.quantize_decode_params(cfg, params)
    tok0 = jnp.zeros((b,), jnp.int32)

    def step(params, tokens, cache, *, attn=True, write=True, head=True,
             mlp=True):
        bsz = tokens.shape[0]
        x = params["embed"][tokens][:, None]
        sin, cos = tfm.rope_tables(cfg, cache.lengths[:, None])
        k_all, v_all = cache.k, cache.v
        new_lengths = cache.lengths + 1
        for i in range(cfg.n_layers):
            layer = jax.tree.map(lambda p: p[i], params["layers"])
            h = tfm.rms_norm(x, layer["rms_attn"])
            q, k, v = engine._qkv(cfg, layer, h, bsz, 1)
            q = tfm.apply_rope(q, sin, cos)
            k = tfm.apply_rope(k, sin, cos)
            if write:
                cache_view = engine.KVCache(
                    k_all, v_all, None, None, cache.lengths
                )
                k_all, v_all, _, _ = engine._quantize_and_write(
                    cache_view, i, k.transpose(0, 2, 1, 3),
                    v.transpose(0, 2, 1, 3), cache.lengths,
                )
            q_dec = q.reshape(bsz, cfg.n_heads, cfg.d_head)
            if attn:
                o = flash_decode(
                    q_dec.astype(cfg.dtype), k_all[i], v_all[i], new_lengths
                )
            else:
                o = q_dec * 0.5
            x = x + engine._proj(
                o.reshape(bsz, 1, cfg.q_dim), layer, "wo", x.dtype
            )
            if mlp:
                x = engine._mlp(layer, x)
        x = tfm.rms_norm(x, params["rms_final"])
        if head:
            logits = engine._lm_head(params, x[:, 0])
        else:
            logits = (
                jnp.zeros((bsz, cfg.vocab_size), jnp.float32) + x[:, 0, :1]
            )
        return logits, engine.KVCache(k_all, v_all, None, None, new_lengths)

    variants = {
        "full": dict(),
        "no_attn": dict(attn=False),
        "no_write": dict(write=False),
        "no_head": dict(head=False),
        "no_mlp": dict(mlp=False),
        "proj_only": dict(attn=False, write=False, head=False),
    }

    results = {}
    for name, kw in variants.items():
        stepper = functools.partial(step, **kw)

        @jax.jit
        def run_n(n, params, tok, cache, stepper=stepper):
            def body(_, carry):
                tok, cache = carry
                logits, cache = stepper(params, tok, cache)
                return jnp.argmax(logits, -1).astype(jnp.int32), cache

            return jax.lax.fori_loop(0, n, body, (tok, cache), unroll=False)

        cache0 = engine.KVCache(cache.k, cache.v, None, None, cache.lengths)
        np.asarray(run_n(1, params, tok0, cache0)[0])
        times = {}
        for n in (8, 136):
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                np.asarray(jax.tree.leaves(run_n(n, params, tok0, cache0))[0])
                best = min(best, time.perf_counter() - t0)
            times[n] = best
        per_step = (times[136] - times[8]) / 128
        results[name] = per_step
        print(f"{name:10s} {per_step*1e3:7.3f} ms/step")

    full = results["full"]
    for name in ("no_attn", "no_write", "no_head", "no_mlp"):
        print(f"stage {name[3:]:6s} costs ~{(full - results[name])*1e3:6.3f} ms")
    print(f"residual (proj_only) {results['proj_only']*1e3:7.3f} ms")


if __name__ == "__main__":
    main()
