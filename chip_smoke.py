"""Smoke run of the main path, compiled on one GPU.

    python chip_smoke.py                # one card: kernels, trainer, server
    python chip_smoke.py --four-cards   # four cards: TP serving, CP training
                                        # (flagship widths, 2 layers)

Phases (each prints its results before the next starts; any failure exits
non-zero):
  1. environment: JAX version and devices, the card's name and power limit,
     the compile cache in use; no GPU -> exit 1;
  2. every attention kernel of the path against plain `jnp` attention in
     float32 (highest matmul precision) on the card, at the flagship's
     widths, rel-L2 next to its tolerance; then the suite's `gpu`-marked
     tests, in this process;
  3. trainer: 5 AdamW steps of the flagship decoder (B=4, N=4096) on a
     one-device mesh; loss finite and falling; the step's memory analysis;
  4. server: the continuous-batching Scheduler answers 8 requests on the
     linear bf16 cache and on the paged int8 pool (chunked prefill). The
     logits every token was picked from, prefill and decode steps, agree
     with a plain float32 forward teacher-forced on the served tokens; and
     on the paged pool each request's tokens equal those of the same
     scheduler serving it alone (same batch shapes, so the same compiled
     programs).
With --four-cards: the TP scheduler's logits (and the one-card
scheduler's) against the float32 forward as in phase 4, and the
context-parallel step's loss and gradient norm against the same step on
one card.
The last line is the JSON result: {"ok": true, "device": {...}}.

Weights are random, made from a fixed seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

# flagship decoder (benchmarks/bench_train.py, bench_serving.py): ~0.42 B
FLAGSHIP = dict(vocab_size=32000, d_model=2048, n_layers=8, n_heads=16,
                n_kv_heads=4, d_head=128, d_ff=5504)
TOL_FWD = 1e-2   # bf16 forward and decode (the tests' bound)
# gradients: dq/dk/dv are bf16 and their products take bf16-rounded P and
# dS operands, so they carry about twice the forward's rounding
TOL_GRAD = 2e-2


def log(*a):
    print(*a, flush=True)


def card_name_and_power() -> str:
    """nvidia-smi in a child that does not import JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def rel_l2(a, b) -> float:
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    return float(jnp.linalg.norm(a - b) / jnp.linalg.norm(b))


class Checks:
    def __init__(self):
        self.failed = []

    def check(self, name, value, tol):
        ok = bool(np.isfinite(value)) and value <= tol
        log(f"  {name:44s} rel_l2={value:.3e}  tol={tol:.3g}  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.failed.append(name)

    def require(self, name, cond, detail=""):
        log(f"  {name:44s} {'ok' if cond else 'FAIL'} {detail}")
        if not cond:
            self.failed.append(name)


# ---------------------------------------------------------------------------
# Phase 2: kernels against the plain reference
# ---------------------------------------------------------------------------

def phase_kernels(ck: Checks):
    from flashattention_kernel_project_tpu import ops

    ref = functools.partial(ops.reference_attention, q_chunk=1024)

    def reference(*a, **kw):
        with jax.default_matmul_precision("highest"):
            return jax.jit(functools.partial(ref, **kw))(*a)

    key = jax.random.split(jax.random.key(1), 12)
    b, hq, hkv, n, d = 1, 16, 4, 4096, 128
    q = jax.random.normal(key[0], (b, hq, n, d), jnp.bfloat16)
    k = jax.random.normal(key[1], (b, hkv, n, d), jnp.bfloat16)
    v = jax.random.normal(key[2], (b, hkv, n, d), jnp.bfloat16)
    w = jax.random.normal(key[3], (b, hq, n, d), jnp.float32)

    # causal GQA forward + grad: the routed call (cuDNN) and the Pallas kernel
    want = reference(q, k, v, causal=True)

    def loss_ref(q, k, v):
        return jnp.sum(ref(q, k, v, causal=True) * w)

    with jax.default_matmul_precision("highest"):
        gref = jax.jit(jax.grad(loss_ref, (0, 1, 2)))(
            *(x.astype(jnp.float32) for x in (q, k, v)))
    for impl in ("cudnn", "pallas"):
        f = functools.partial(ops.flash_attention, causal=True,
                              implementation=impl)
        ck.check(f"fwd causal 4K [{impl}]", rel_l2(jax.jit(f)(q, k, v), want),
                 TOL_FWD)
        g = jax.jit(jax.grad(
            lambda q, k, v, f=f: jnp.sum(f(q, k, v).astype(jnp.float32) * w),
            (0, 1, 2)))(q, k, v)
        for name, a, r in zip("qkv", g, gref):
            ck.check(f"grad d{name} causal 4K [{impl}]", rel_l2(a, r),
                     TOL_GRAD)
    route = ops.select_impl(q.dtype, n, n, d, causal=True, q_offset=0,
                            window=None, sinks=0, interpret=None,
                            platform="gpu")
    log(f"  (default route for this call: {route})")

    # window 1024 + 4 sinks (Pallas: cuDNN has no sinks)
    f = jax.jit(functools.partial(ops.flash_attention, causal=True,
                                  window=1024, sinks=4))
    ck.check("fwd window1024+sinks4", rel_l2(
        f(q, k, v), reference(q, k, v, causal=True, window=1024, sinks=4)),
        TOL_FWD)

    # 8-bit KV forward (int8, fp8) against the dequantised cache
    for fmt in ("int8", "fp8"):
        kq, ks, vq, vs = ops.quantize_kv(k, v, fmt=fmt)
        kd = kq.astype(jnp.float32) * ks
        vd = vq.astype(jnp.float32) * vs
        got = ops.flash_attention_kv_quant(q, kq, ks, vq, vs, causal=True)
        ck.check(f"fwd 8-bit KV [{fmt}]",
                 rel_l2(got, reference(q, kd, vd, causal=True)), TOL_FWD)

    # ragged extend: 512-token chunks at per-row offsets into a 4K cache
    br, t = 4, 512
    qr = jax.random.normal(key[4], (br, hq, t, d), jnp.bfloat16)
    kr = jax.random.normal(key[5], (br, hkv, n, d), jnp.bfloat16)
    vr = jax.random.normal(key[6], (br, hkv, n, d), jnp.bfloat16)
    lens = jnp.asarray([4096, 1000, 2600, 512], jnp.int32)
    offs = lens - t
    got = ops.flash_attention_ragged(qr, kr, vr, lens, offs)
    ck.check("ragged extend 512 @ offsets", rel_l2(
        got, reference(qr, kr, vr, causal=True, q_offsets=offs,
                       kv_lens=lens)), TOL_FWD)

    # linear decode, context 8K, mixed lengths, batch 8
    bd, s = 8, 8192
    dl = jnp.asarray([8192, 7000, 5000, 4096, 3000, 2048, 1024, 300],
                     jnp.int32)
    qd = jax.random.normal(key[7], (bd, hq, d), jnp.bfloat16)
    kc = jax.random.normal(key[8], (bd, hkv, s, d), jnp.bfloat16)
    vc = jax.random.normal(key[9], (bd, hkv, s, d), jnp.bfloat16)

    def dref(k, v, **kw):
        return reference(qd[:, :, None], k, v, causal=True, q_offsets=dl - 1,
                         kv_lens=dl, **kw)[:, :, 0]

    ck.check("decode bf16 8K", rel_l2(ops.flash_decode(qd, kc, vc, dl),
                                      dref(kc, vc)), TOL_FWD)
    ck.check("decode bf16 8K window1024+sinks4", rel_l2(
        ops.flash_decode(qd, kc, vc, dl, window=1024, sinks=4),
        dref(kc, vc, window=1024, sinks=4)), TOL_FWD)
    deq = {}
    for fmt in ("int8", "fp8"):
        kq, ks, vq, vs = ops.quantize_kv(kc, vc, fmt=fmt)
        deq[fmt] = (kq, ks, vq, vs)
        r8 = dref(kq.astype(jnp.float32) * ks, vq.astype(jnp.float32) * vs)
        ck.check(f"decode {fmt} 8K", rel_l2(
            ops.flash_decode_int8(qd, kq, ks, vq, vs, dl), r8), TOL_FWD)

    # paged: 128-token pages in shuffled order, bf16 and int8; then append
    # one token and extend a 64-token chunk
    page = 128
    maxp = s // page
    n_pages = bd * maxp + 1
    perm = np.random.default_rng(0).permutation(np.arange(1, n_pages))
    tbl = jnp.asarray(perm.reshape(bd, maxp), jnp.int32)
    order = jnp.asarray(np.argsort(perm))

    def to_pages(x):
        x = x.reshape(bd, x.shape[1], maxp, page, x.shape[-1])
        x = jnp.moveaxis(x, 2, 1).reshape(bd * maxp, x.shape[1], page, -1)
        return jnp.concatenate([jnp.zeros_like(x[:1]), x[order]], axis=0)

    kp, vp = to_pages(kc), to_pages(vc)
    ck.check("paged decode bf16 8K", rel_l2(
        ops.paged_flash_decode(qd, kp, vp, tbl, dl), dref(kc, vc)), TOL_FWD)
    kq, ks, vq, vs = deq["int8"]
    kpq, kps, vpq, vps = (to_pages(x) for x in (kq, ks, vq, vs))
    r8 = dref(kq.astype(jnp.float32) * ks, vq.astype(jnp.float32) * vs)
    ck.check("paged decode int8 8K", rel_l2(
        ops.paged_flash_decode_quant(qd, kpq, kps, vpq, vps, tbl, dl), r8),
        TOL_FWD)

    live = dl < s
    kn = jax.random.normal(key[10], (bd, 64, hkv, d), jnp.bfloat16)
    vn = jax.random.normal(key[11], (bd, 64, hkv, d), jnp.bfloat16)
    old = jnp.where(live, dl, s - 64)
    kp2, vp2 = ops.paged_append_chunk(kp, vp, kn, vn, tbl, old)
    lin_k = ops.gather_pages(kp2, tbl)
    want_k = jax.vmap(lambda c, x, o: jax.lax.dynamic_update_slice(
        c, jnp.swapaxes(x, 0, 1), (0, o, 0)))(kc, kn, old)
    ck.check("paged append chunk (gathered back)", rel_l2(lin_k, want_k),
             0.0)
    qe = jax.random.normal(key[0], (bd, hq, 64, d), jnp.bfloat16)
    want_v = jax.vmap(lambda c, x, o: jax.lax.dynamic_update_slice(
        c, jnp.swapaxes(x, 0, 1), (0, o, 0)))(vc, vn, old)
    got = ops.paged_flash_extend(qe, kp2, vp2, tbl, old + 64, old)
    ck.check("paged extend 64", rel_l2(got, reference(
        qe, want_k, want_v, causal=True, q_offsets=old, kv_lens=old + 64)),
        TOL_FWD)
    kp2, ksp2, vp2, vsp2 = ops.paged_append_chunk_quant(
        kpq, kps, vpq, vps, kn, vn, tbl, old)
    got = ops.paged_flash_extend(qe, kp2, vp2, tbl, old + 64, old,
                                 k_scale_pages=ksp2, v_scale_pages=vsp2)
    deq_k = ops.gather_pages(kp2.astype(jnp.float32) * ksp2, tbl)
    deq_v = ops.gather_pages(vp2.astype(jnp.float32) * vsp2, tbl)
    ck.check("paged extend 64 int8", rel_l2(got, reference(
        qe, deq_k, deq_v, causal=True, q_offsets=old, kv_lens=old + 64)),
        TOL_FWD)


def phase_card_tests(ck: Checks):
    """The suite's `gpu`-marked tests, in this process (one process per
    card)."""
    import pytest

    os.environ["FKP_TEST_GPU"] = "1"
    root = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(root, "tests")])
    ck.require("pytest -m gpu", rc == 0, f"exit code {int(rc)}")


# ---------------------------------------------------------------------------
# Phase 3: trainer
# ---------------------------------------------------------------------------

def phase_trainer(ck: Checks, cfg):
    import optax

    from flashattention_kernel_project_tpu import models, parallel

    params = models.init_params(cfg, jax.random.key(0))
    tokens = jax.random.randint(jax.random.key(1), TRAIN_SHAPE, 0,
                                cfg.vocab_size)
    mesh = parallel.make_mesh({"data": 1, "model": 1},
                              devices=jax.devices()[:1])
    init_fn, step_fn, rules, _ = parallel.make_optax_train_step(
        cfg, mesh, optax.adamw(3e-4), params)
    p = parallel.shard_params(params, mesh, rules)
    s = init_fn(p)
    t0 = time.perf_counter()
    compiled = jax.jit(step_fn).lower(p, s, tokens).compile()
    log(f"  step compiled in {time.perf_counter() - t0:.1f} s")
    log(f"  memory_analysis: {compiled.memory_analysis()}")
    losses = []
    for i in range(5):
        t0 = time.perf_counter()
        p, s, loss = compiled(p, s, tokens)
        losses.append(float(loss))
        log(f"  step {i}: loss {losses[-1]:.5f} "
            f"({1e3 * (time.perf_counter() - t0):.1f} ms)")
    ck.require("losses finite", all(np.isfinite(losses)))
    ck.require("loss falling", losses[-1] < losses[0],
               f"{losses[0]:.5f} -> {losses[-1]:.5f}")


# ---------------------------------------------------------------------------
# Phase 4: server
# ---------------------------------------------------------------------------

TRAIN_SHAPE = (4, 4096)
PROMPT_LENS = (128, 2048, 512, 1024, 128, 2048, 512, 1024)
N_NEW = 32
MAX_LEN = 2560
CP_LEN = 16384
FOUR_CARD_LAYERS = 2


def _plain_forward(cfg, params, tokens, rows, dtype, kv_fmt=None):
    """Logits at positions `rows` of the flagship's forward over `tokens`
    [1, N], in `dtype` with plain `jnp` attention. kv_fmt ("int8", "fp8")
    rounds K and V through that cache format first."""
    from flashattention_kernel_project_tpu import ops
    from flashattention_kernel_project_tpu.models import transformer as tfm

    p = jax.tree.map(lambda x: x.astype(dtype), params)
    b, n = tokens.shape
    x = p["embed"][tokens]
    sin, cos = tfm.rope_tables(cfg, jnp.arange(n)[None, :])
    t = lambda a: a.transpose(0, 2, 1, 3)  # noqa: E731
    for i in range(cfg.n_layers):
        layer = jax.tree.map(lambda a: a[i], p["layers"])
        h = tfm.rms_norm(x, layer["rms_attn"])
        q = (h @ layer["wq"]).reshape(b, n, cfg.n_heads, cfg.d_head)
        k = (h @ layer["wk"]).reshape(b, n, cfg.n_kv_heads, cfg.d_head)
        v = (h @ layer["wv"]).reshape(b, n, cfg.n_kv_heads, cfg.d_head)
        q, k = tfm.apply_rope(q, sin, cos), tfm.apply_rope(k, sin, cos)
        q, k, v = t(q), t(k), t(v)
        if kv_fmt:
            kq, ks, vq, vs = ops.quantize_kv(k, v, fmt=kv_fmt)
            k = (kq.astype(jnp.float32) * ks).astype(dtype)
            v = (vq.astype(jnp.float32) * vs).astype(dtype)
        o = ops.reference_attention(q, k, v, causal=True,
                                    q_chunk=1024).astype(dtype)
        x = x + t(o).reshape(b, n, cfg.q_dim) @ layer["wo"]
        x = tfm._mlp_block(layer, x)
    x = tfm.rms_norm(x[:, rows], p["rms_final"])
    return jnp.matmul(x, p["embed"].T, preferred_element_type=jnp.float32)


def serve(ck: Checks, cfg, params, prompts, label, *, one_at_a_time=False,
          **kw):
    """Serve `prompts` on one Scheduler: all submitted at once, or one
    request per `run()`. Returns, per request, its tokens and the logits
    each token was picked from."""
    from flashattention_kernel_project_tpu.models.serving import Scheduler

    class Recording(Scheduler):
        """Keeps the logits of every pick: row 0 of a prefill's [1, V],
        the slot's row of a decode step's [B, V]."""

        def _pick(self, logits, temps=None):
            self.last_logits = logits
            return super()._pick(logits, temps)

        def _on_token(self, slot, token):
            row = 0 if self.last_logits.shape[0] == 1 else slot
            picked_from.setdefault(self.slots[slot].uid, []).append(
                np.asarray(self.last_logits[row], np.float32))
            super()._on_token(slot, token)

    picked_from: dict[int, list] = {}
    sched = Recording(cfg, params, max_batch=8, max_len=MAX_LEN, **kw)
    t0 = time.perf_counter()
    uids = []
    for pr in prompts:
        uids.append(sched.submit(pr, max_new_tokens=N_NEW))
        if one_at_a_time:
            sched.run()
    out = sched.run()
    got = [(out.get(u, []), picked_from.get(u, [])) for u in uids]
    n_ok = sum(len(t) == len(lg) == N_NEW for t, lg in got)
    log(f"  [{label}] served {n_ok}/{len(prompts)} requests in "
        f"{time.perf_counter() - t0:.1f} s (compiles included)")
    ck.require(f"[{label}] {N_NEW} tokens for every request",
               n_ok == len(prompts))
    return got


def check_logits(ck: Checks, label, cfg, params, prompts, served,
                 kv_fmt=None):
    """Each request's picked-from logits (prefill, then decode steps)
    against the plain float32 forward teacher-forced on its served tokens.
    The bound is what bf16 rounding costs on the same rows, plus half again
    and 1e-2: the plain forward with weights and activations rounded to
    bf16 (K/V through `kv_fmt` where decode reads an 8-bit cache) but exact
    accumulation. At default precision XLA's compile of that plain bf16
    forward loses up to 0.27 on the card (PERF.md), so it is no floor."""
    plain = jax.jit(functools.partial(_plain_forward, cfg),
                    static_argnums=(3, 4))
    for pr, (toks, got) in zip(prompts, served):
        t = len(pr)
        seq = np.zeros((1, MAX_LEN), np.int32)
        seq[0, :t] = pr
        seq[0, t:t + N_NEW - 1] = toks[:-1]
        seq, rows = jnp.asarray(seq), jnp.arange(t - 1, t - 1 + N_NEW)
        with jax.default_matmul_precision("highest"):
            want = plain(params, seq, rows, jnp.float32, None)[0]
            rounded = {fmt: plain(params, seq, rows, jnp.bfloat16, fmt)[0]
                       for fmt in {None, kv_fmt}}
        got = jnp.asarray(np.stack(got))
        # prefill runs on a full-precision batch-1 cache; decode reads the
        # pool in its own format
        for part, sl, fmt in (
            ("prefill", slice(0, 1), None),
            (f"{N_NEW - 1} decode steps", slice(1, None), kv_fmt),
        ):
            floor = rel_l2(rounded[fmt][sl], want[sl])
            ck.check(f"[{label}] {t}-token prompt, {part}",
                     rel_l2(got[sl], want[sl]), 1.5 * floor + 1e-2)


def phase_server(ck: Checks, cfg):
    from flashattention_kernel_project_tpu import models

    params = models.init_params(cfg, jax.random.key(2))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    # the paged int8 pool with chunked prefill: later chunks attend to the
    # earlier ones, and decode reads the 8-bit pages. `exact`: whether the
    # backend's tokens must equal those of the same scheduler serving each
    # request alone (same batch shapes, so the same compiled programs). The
    # linear backend's one-shot prefill is not deterministic on the card
    # (the same scheduler run twice in one process differed in 2 of 8
    # requests, PERF.md), so there the identity is counted, not required.
    for label, kv_fmt, exact, kw in (
        ("linear bf16", None, False, {}),
        ("paged int8, prefill_chunk 512", "int8", True,
         dict(paged=True, quantized_cache=True, prefill_chunk=512,
              page_size=128)),
    ):
        served = serve(ck, cfg, params, prompts, label, **kw)
        check_logits(ck, label, cfg, params, prompts, served, kv_fmt)
        alone = serve(ck, cfg, params, prompts, f"{label}, one at a time",
                      one_at_a_time=True, **kw)
        same = sum(a[0] == b[0] for a, b in zip(served, alone))
        if exact:
            ck.require(f"[{label}] tokens equal served alone",
                       same == len(prompts), f"{same}/{len(prompts)} requests")
        else:
            log(f"  [{label}] tokens equal served alone: {same}/"
                f"{len(prompts)} requests (counted, not required)")


# ---------------------------------------------------------------------------
# Four cards: TP serving and context-parallel training
# ---------------------------------------------------------------------------

def phase_four_cards(ck: Checks, cfg):
    from flashattention_kernel_project_tpu import models, parallel

    devs = jax.devices()
    ck.require("four devices", len(devs) == 4, f"found {len(devs)}")

    # TP serving, one KV head per card, and the one-card scheduler: each
    # held to the plain f32 forward on its own tokens
    params = models.init_params(cfg, jax.random.key(2))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    mesh = parallel.make_mesh({"model": 4}, devices=devs)
    one = jax.device_put(params, devs[0])
    tp = serve(ck, cfg, params, prompts, "TP x4", mesh=mesh)
    check_logits(ck, "TP x4", cfg, one, prompts, tp)
    single = serve(ck, cfg, one, prompts, "one card")
    check_logits(ck, "one card", cfg, one, prompts, single)
    # sharded and unsharded matmuls round differently, so near-tied
    # argmaxes may flip: counted, not required
    same = sum(a[0] == b[0] for a, b in zip(tp, single))
    log(f"  tokens identical, TP x4 and one card: {same}/{len(prompts)}")

    # context-parallel training at N=16384, ring attention over 4 cards
    n, lr = CP_LEN, 1e-2
    params = models.init_params(cfg, jax.random.key(0))
    tokens = jax.random.randint(jax.random.key(1), (1, n), 0, cfg.vocab_size)
    smesh = parallel.make_mesh({"sp": 4}, devices=devs)
    step, rules = parallel.make_cp_train_step(cfg, smesh, lr=lr)
    sp = parallel.shard_params(params, smesh, rules)
    t0 = time.perf_counter()
    new_cp, loss_cp = step(sp, tokens)
    loss_cp = float(loss_cp)
    log(f"  CP x4 step: loss {loss_cp:.5f} "
        f"({time.perf_counter() - t0:.1f} s with compile)")
    one = jax.device_put(params, devs[0])
    t0 = time.perf_counter()
    new_1, loss_1 = jax.jit(functools.partial(
        models.sgd_train_step, cfg, lr=lr))(one, jax.device_put(tokens,
                                                                 devs[0]))
    loss_1 = float(loss_1)
    log(f"  one-card step: loss {loss_1:.5f} "
        f"({time.perf_counter() - t0:.1f} s with compile)")
    ck.check("CP loss vs one card", abs(loss_cp - loss_1) / abs(loss_1),
             TOL_FWD)

    def grad_norm(new, old):
        return float(jnp.sqrt(sum(
            jnp.sum(jnp.square(jax.device_get(a).astype(jnp.float32)
                               - jax.device_get(b).astype(jnp.float32)))
            for a, b in zip(jax.tree.leaves(new), jax.tree.leaves(old))))) / lr

    g_cp, g_1 = grad_norm(new_cp, params), grad_norm(new_1, params)
    log(f"  gradient norm: CP {g_cp:.5f}  one card {g_1:.5f}")
    ck.check("CP grad norm vs one card", abs(g_cp - g_1) / g_1, TOL_GRAD)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card paths (TP serving, CP "
                         "training) and what they are compared with")
    args = ap.parse_args()

    # phase 1: environment
    log(f"jax {jax.__version__} | devices {jax.devices()}")
    if jax.default_backend() != "gpu":
        print(f"no GPU found (backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from flashattention_kernel_project_tpu import models
    from flashattention_kernel_project_tpu.utils.platform import (
        enable_compile_cache,
    )

    log(f"compile cache: {enable_compile_cache()}")
    card = card_name_and_power()
    log(f"card: {card}")
    cfg = models.TransformerConfig(**FLAGSHIP, dtype=jnp.bfloat16)
    if args.four_cards:
        # full width, depth cut: the engine unrolls its layers, and four
        # programs compile on this path
        cfg = dataclasses.replace(cfg, n_layers=FOUR_CARD_LAYERS)
    ck = Checks()
    phases = ([("four cards", phase_four_cards)] if args.four_cards else [
        ("kernels", lambda ck, cfg: phase_kernels(ck)),
        ("card tests", lambda ck, cfg: phase_card_tests(ck)),
        ("trainer", phase_trainer),
        ("server", phase_server),
    ])
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        fn(ck, cfg)
        log(f"== phase {name}: {time.perf_counter() - t0:.1f} s, "
            f"{len(ck.failed)} failed so far")
        if ck.failed:
            break
    if ck.failed:
        print(f"FAILED: {ck.failed}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
