"""Time each attention kernel on the card against what XLA makes of the
plain version and against a library kernel where one covers the call.

Shapes are the flagship decoder's (16 q heads, 4 KV heads, d_head 128,
bf16): the 4K causal training forward and backward, decode at context 8K
with mixed lengths over a linear and a paged cache in bf16 and int8, the
paged extend of a 512-token chunk, and the paged append.

    python benchmarks/bench_kernels.py [--out build/bench_kernels.json]

Prints one line per (kernel, implementation) with the median time per call
(bursts of back-to-back calls), the card's name and power limit, and each
kernel's rel-L2 against the plain version. Needs a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from flashattention_kernel_project_tpu import ops  # noqa: E402
from flashattention_kernel_project_tpu.utils.platform import (  # noqa: E402
    enable_compile_cache,
)

B, HQ, HKV, D = 1, 16, 4, 128


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def median_ms(fn, *args, burst=50, reps=5):
    """Median over `reps` bursts of `burst` back-to-back calls, per call:
    the card stays busy through a burst, so host dispatch is hidden."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(burst):
            out = fn(*args)
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / burst)
    return 1e3 * float(np.median(ts))


def rel_l2(a, b):
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    return float(jnp.linalg.norm(a - b) / jnp.linalg.norm(b))


def plain_decode(q, k, v, lengths, k_scale=None, v_scale=None):
    """Decode as plain jnp over the whole padded cache (what XLA fuses)."""
    b, hq, d = q.shape
    hkv = k.shape[1]
    if k_scale is not None:
        k = k.astype(jnp.bfloat16) * k_scale.astype(jnp.bfloat16)
        v = v.astype(jnp.bfloat16) * v_scale.astype(jnp.bfloat16)
    qg = q.reshape(b, hkv, hq // hkv, d)
    s = jnp.einsum("bhgd,bhsd->bhgs", qg, k,
                   preferred_element_type=jnp.float32) / np.sqrt(d)
    mask = jnp.arange(k.shape[2])[None, None, None, :] < lengths[:, None,
                                                                 None, None]
    p = jax.nn.softmax(jnp.where(mask, s, -jnp.inf), axis=-1)
    o = jnp.einsum("bhgs,bhsd->bhgd", p.astype(v.dtype), v,
                   preferred_element_type=jnp.float32)
    return o.reshape(b, hq, d).astype(q.dtype)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/bench_kernels.json")
    ap.add_argument("--n", type=int, default=4096)
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        print("no GPU found", file=sys.stderr)
        return 1
    enable_compile_cache()
    name = card()
    print("card:", name, "| device_kind:", jax.devices()[0].device_kind,
          flush=True)
    rows = []
    failed = []

    @contextlib.contextmanager
    def section(name):
        try:
            yield
        except Exception:  # report and go on to the next kernel
            traceback.print_exc()
            print(f"{name}: FAILED", flush=True)
            failed.append(name)

    def record(kernel, impl, ms, err=None):
        rows.append(dict(kernel=kernel, impl=impl, ms=ms, rel_l2=err))
        e = "" if err is None else f" rel_l2={err:.2e}"
        print(f"{kernel:28s} {impl:8s} {ms:9.3f} ms{e}", flush=True)

    key = jax.random.split(jax.random.key(0), 8)
    n = args.n
    q = jax.random.normal(key[0], (B, HQ, n, D), jnp.bfloat16)
    k = jax.random.normal(key[1], (B, HKV, n, D), jnp.bfloat16)
    v = jax.random.normal(key[2], (B, HKV, n, D), jnp.bfloat16)
    w = jax.random.normal(key[3], (B, HQ, n, D), jnp.bfloat16)

    # A. causal forward
    with section("A"):
        t = lambda x: jnp.swapaxes(x, 1, 2)  # noqa: E731

        def dpa(q, k, v, impl):
            return t(jax.nn.dot_product_attention(
                t(q), t(k), t(v), is_causal=True, implementation=impl))

        fwd = {
            "xla": jax.jit(functools.partial(dpa, impl="xla")),
            "cudnn": jax.jit(functools.partial(dpa, impl="cudnn")),
            "pallas": jax.jit(functools.partial(
                ops.flash_attention, causal=True, implementation="pallas")),
        }
        ref = fwd["xla"](q, k, v)
        for impl, f in fwd.items():
            record("A fwd causal 4K", impl, median_ms(f, q, k, v),
                   rel_l2(f(q, k, v), ref))

        # window + sinks and 8-bit K/V: calls cuDNN does not cover
        f = jax.jit(functools.partial(ops.flash_attention, causal=True,
                                      window=1024, sinks=4,
                                      implementation="pallas"))
        record("A fwd window1024+sinks4", "pallas", median_ms(f, q, k, v))
        # plain: the same mask in jnp (f32 scores)
        f = jax.jit(functools.partial(
            ops.reference_attention, causal=True, window=1024, sinks=4))
        record("A fwd window1024+sinks4", "xla", median_ms(f, q, k, v))
        # 8-bit K/V forward: the kernel against dequantise-then-XLA
        kq, ks, vq, vs = ops.quantize_kv(k, v, fmt="int8")
        f = jax.jit(functools.partial(ops.flash_attention_kv_quant,
                                      causal=True))
        record("A fwd int8 KV causal 4K", "pallas",
               median_ms(f, q, kq, ks, vq, vs))
        f = jax.jit(lambda q, kq, ks, vq, vs: dpa(
            q, (kq * ks).astype(q.dtype), (vq * vs).astype(q.dtype), "xla"))
        record("A fwd int8 KV causal 4K", "xla",
               median_ms(f, q, kq, ks, vq, vs))

        # B. backward (time of value_and_grad minus nothing: fwd+bwd step)
        def loss(fn, q, k, v):
            return jnp.sum(fn(q, k, v).astype(jnp.float32) * w)

        grads = {i: jax.jit(jax.grad(functools.partial(loss, f), (0, 1, 2)))
                 for i, f in fwd.items()}
        gref = grads["xla"](q, k, v)
        for impl, g in grads.items():
            got = g(q, k, v)
            err = max(rel_l2(a, b_) for a, b_ in zip(got, gref))
            record("B fwd+bwd causal 4K", impl, median_ms(g, q, k, v), err)

        # C. linear decode, context 8K, mixed lengths, batch 8
        bd, s = 8, 8192
        lens = jnp.asarray([8192, 7000, 5000, 4096, 3000, 2048, 1024, 300],
                           jnp.int32)
        qd = jax.random.normal(key[4], (bd, HQ, D), jnp.bfloat16)
        kc = jax.random.normal(key[5], (bd, HKV, s, D), jnp.bfloat16)
        vc = jax.random.normal(key[6], (bd, HKV, s, D), jnp.bfloat16)
        dref = jax.jit(plain_decode)
        r = dref(qd, kc, vc, lens)
        record("C decode bf16 8K", "xla", median_ms(dref, qd, kc, vc, lens))
        f = jax.jit(ops.flash_decode)
        record("C decode bf16 8K", "pallas", median_ms(f, qd, kc, vc, lens),
               rel_l2(f(qd, kc, vc, lens), r))
        kq, ks, vq, vs = ops.quantize_kv(kc, vc, fmt="int8")
        r8 = dref(qd, kq, vq, lens, ks, vs)
        record("C decode int8 8K", "xla",
               median_ms(dref, qd, kq, vq, lens, ks, vs))
        f = jax.jit(ops.flash_decode_int8)
        record("C decode int8 8K", "pallas",
               median_ms(f, qd, kq, ks, vq, vs, lens),
               rel_l2(f(qd, kq, ks, vq, vs, lens), r8))
        fq, fs, gq, gs = ops.quantize_kv(kc, vc, fmt="fp8")
        record("C decode fp8 8K", "pallas",
               median_ms(f, qd, fq, fs, gq, gs, lens),
               rel_l2(f(qd, fq, fs, gq, gs, lens),
                      dref(qd, fq, gq, lens, fs, gs)))

        # D. paged decode over the same contexts, 128-token pages, shuffled
        page = 128
        maxp = s // page
        n_pages = bd * maxp + 1
        perm = np.random.default_rng(0).permutation(np.arange(1, n_pages))
        tbl = jnp.asarray(perm.reshape(bd, maxp), jnp.int32)

        def to_pages(x):
            x = x.reshape(bd, x.shape[1], maxp, page, -1)
            x = jnp.moveaxis(x, 2, 1).reshape(bd * maxp, x.shape[1], page, -1)
            x = x[jnp.asarray(np.argsort(perm.reshape(-1)))]
            return jnp.concatenate([jnp.zeros_like(x[:1]), x], axis=0)

        kp, vp = to_pages(kc), to_pages(vc)
        f = jax.jit(ops.paged_flash_decode)
        record("D paged decode bf16 8K", "pallas",
               median_ms(f, qd, kp, vp, tbl, lens),
               rel_l2(f(qd, kp, vp, tbl, lens), r))
        pplain = jax.jit(lambda q, kp, vp, tbl, lens: plain_decode(
            q, ops.gather_pages(kp, tbl), ops.gather_pages(vp, tbl), lens))
        record("D paged decode bf16 8K", "xla",
               median_ms(pplain, qd, kp, vp, tbl, lens))
        kpq, kps, vpq, vps = ops.quantize_kv(kp, vp, fmt="int8")
        f = jax.jit(ops.paged_flash_decode_quant)
        record("D paged decode int8 8K", "pallas",
               median_ms(f, qd, kpq, kps, vpq, vps, tbl, lens),
               rel_l2(f(qd, kpq, kps, vpq, vps, tbl, lens), r8))

        # E. paged extend: a 512-token chunk per row on top of the contexts
        te = 512
        qe = jax.random.normal(key[7], (bd, HQ, te, D), jnp.bfloat16)
        new = jnp.minimum(lens + te, s)
        old = new - te
        f = jax.jit(ops.paged_flash_extend)
        record("E paged extend 512", "pallas",
               median_ms(f, qe, kp, vp, tbl, new, old))

        def extend_plain(q, kp, vp, tbl, new, old):
            kk = jnp.repeat(ops.gather_pages(kp, tbl), HQ // HKV, axis=1)
            vv = jnp.repeat(ops.gather_pages(vp, tbl), HQ // HKV, axis=1)
            sc = jnp.einsum("bhnd,bhsd->bhns", q, kk,
                            preferred_element_type=jnp.float32) / np.sqrt(D)
            pos = old[:, None] + jnp.arange(te)[None, :]
            mask = jnp.arange(s)[None, None, :] <= pos[:, :, None]
            p = jax.nn.softmax(jnp.where(mask[:, None], sc, -jnp.inf), -1)
            return jnp.einsum("bhns,bhsd->bhnd", p.astype(vv.dtype), vv)

        f2 = jax.jit(extend_plain)
        record("E paged extend 512", "xla",
               median_ms(f2, qe, kp, vp, tbl, new, old),
               rel_l2(f(qe, kp, vp, tbl, new, old), f2(qe, kp, vp, tbl, new,
                                                       old)))

        # F. paged append of one token per row (donated pool: in place)
        app = jax.jit(ops.paged_append, donate_argnums=(0, 1))
        kn = qd.reshape(bd, HKV, 4, D)[:, :, 0]
        kp2, vp2 = kp + 0, vp + 0

        def step(kp2, vp2):
            return app(kp2, vp2, kn, kn, tbl, lens - 1)

        for _ in range(3):
            kp2, vp2 = step(kp2, vp2)
        jax.block_until_ready(kp2)
        old_lens = lens - 1
        t0 = time.perf_counter()
        for _ in range(50):
            kp2, vp2 = app(kp2, vp2, kn, kn, tbl, old_lens)
        jax.block_until_ready(kp2)
        record("F paged append 1 token", "xla",
               1e3 * (time.perf_counter() - t0) / 50)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(dict(card=name, device_kind=jax.devices()[0].device_kind,
                       rows=rows, failed=failed), fh, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
