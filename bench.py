#!/usr/bin/env python
"""Headline benchmark: causal GQA attention forward on one GPU.

Shape: the flagship decoder's attention (16 q heads, 4 KV heads, d_head
128) at seq 4096, bf16 in / f32 accumulate, through `ops.flash_attention`
(which routes this call to cuDNN's fused attention; see
`ops.flash_attention.select_impl`). Reports TFLOP/s (causal: half the
dense 4·B·H·N²·D) and the share of the card's published bf16 peak, next to
the card's name and power limit. Prints exactly one JSON line to stdout;
exits non-zero without a GPU.
"""

import functools
import json
import subprocess
import sys

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import ops
    from flashattention_kernel_project_tpu.utils import platform
    from flashattention_kernel_project_tpu.utils.benchmarking import benchmark

    dev = platform.require_gpu()
    platform.enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    B, H, HKV, N, D = 1, 16, 4, 4096, 128
    rng = np.random.default_rng(42)
    q = jnp.asarray(rng.standard_normal((B, H, N, D)), dtype=jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((B, HKV, N, D)), dtype=jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((B, HKV, N, D)), dtype=jnp.bfloat16)
    fn = jax.jit(functools.partial(ops.flash_attention, causal=True))
    flops = 2 * B * H * N * N * D  # causal half of 4*B*H*N^2*D
    r = benchmark(fn, q, k, v, name="fwd", iters=50, flops=flops)
    peak = platform.peak_flops("bf16", dev.device_kind)
    print(json.dumps({
        "metric": "flashattention_fwd_causal_gqa_d128_seq4k_tflops",
        "value": round(r.tflops, 2),
        "unit": "TFLOP/s",
        "share_of_peak": round(r.tflops * 1e12 / peak, 4),
        "card": card,
        "device_kind": dev.device_kind,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
