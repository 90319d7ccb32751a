"""Fused FlashAttention forward vs naive CPU oracle, plus gradient checks.

Mirrors the reference's verification (rel-L2, flashattn_streaming_16x16.cu:
413-421) with asserted <=1e-2 bounds; the causal/tail cases cover exactly
what the reference never handled (multiple-of-tile assumptions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattention_kernel_project_tpu import ops
from flashattention_kernel_project_tpu.utils import oracles
from flashattention_kernel_project_tpu.utils.testing import assert_rel_l2


def _rand_qkv(rng, b, hq, hkv, n, s, d, dtype=np.float32):
    q = rng.standard_normal((b, hq, n, d)).astype(dtype)
    k = rng.standard_normal((b, hkv, s, d)).astype(dtype)
    v = rng.standard_normal((b, hkv, s, d)).astype(dtype)
    return q, k, v


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n,s", [(256, 256), (128, 384)])
@pytest.mark.smoke
def test_flash_forward_mha(rng, causal, n, s):
    q, k, v = _rand_qkv(rng, 2, 2, 2, n, s, 64)
    got = ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        causal=causal,
    )
    exp = oracles.gqa_attention(q, k, v, causal=causal)
    assert_rel_l2(got, exp, tol=1e-2)


@pytest.mark.smoke
def test_flash_forward_gqa(rng):
    q, k, v = _rand_qkv(rng, 1, 8, 2, 256, 256, 64)
    got = ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
    )
    exp = oracles.gqa_attention(q, k, v, causal=True)
    assert_rel_l2(got, exp, tol=1e-2)


def test_flash_forward_ragged_tail(rng):
    """Non-multiple-of-block shapes — the masking the reference lacked."""
    q, k, v = _rand_qkv(rng, 1, 2, 2, 200, 333, 64)
    got = ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
    )
    exp = oracles.gqa_attention(q, k, v, causal=True)
    assert_rel_l2(got, exp, tol=1e-2)


def test_flash_forward_block_q_gt_block_k(rng):
    """Regression: with block_q > block_k, rows of a q-block that lie wholly
    above a kv-block get fully-masked score rows; exp(NEG_INF - NEG_INF)=1
    must not leak into l (the reference's 5.4-class bug)."""
    from flashattention_kernel_project_tpu.ops.flash_attention import _fwd

    q, k, v = _rand_qkv(rng, 1, 2, 2, 256, 256, 64)
    got, _ = _fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.full((1,), 256),
        jnp.zeros((1,)), causal=True, sm_scale=None, interpret=None,
        block_q=256, block_k=64,
    )
    exp = oracles.gqa_attention(q, k, v, causal=True)
    assert_rel_l2(got, exp, tol=1e-2)


def test_flash_forward_q_offset(rng):
    """Chunked prefill: query block positioned mid-sequence."""
    q, k, v = _rand_qkv(rng, 1, 2, 2, 128, 384, 64)
    got = ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        causal=True, q_offset=256,
    )
    exp = oracles.gqa_attention(q, k, v, causal=True, q_offset=256)
    assert_rel_l2(got, exp, tol=1e-2)


def test_flash_forward_bf16(rng):
    q, k, v = _rand_qkv(rng, 1, 2, 2, 256, 256, 64)
    got = ops.flash_attention(
        jnp.asarray(q, dtype=jnp.bfloat16),
        jnp.asarray(k, dtype=jnp.bfloat16),
        jnp.asarray(v, dtype=jnp.bfloat16),
        causal=True,
    )
    exp = oracles.gqa_attention(q, k, v, causal=True)
    assert_rel_l2(np.asarray(got, np.float32), exp, tol=2e-2)


@pytest.mark.smoke
def test_flash_lse(rng):
    q, k, v = _rand_qkv(rng, 1, 2, 2, 128, 256, 64)
    _, lse = ops.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    scores = np.einsum("bhnd,bhsd->bhns", q, k) / np.sqrt(64)
    exp_lse = np.log(np.sum(np.exp(scores - scores.max(-1, keepdims=True)), -1)) + scores.max(-1)
    assert_rel_l2(lse, exp_lse, tol=1e-3)


def test_flash_attention_ragged(rng):
    """Per-batch kv lengths + offsets vs per-sequence oracle calls."""
    b, hq, hkv, n, s, d = 3, 4, 2, 64, 160, 32
    q = rng.standard_normal((b, hq, n, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    kv_lens = np.array([160, 100, 64], np.int32)
    q_offsets = np.array([96, 36, 0], np.int32)  # queries end at kv_lens

    got = ops.flash_attention_ragged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(kv_lens), jnp.asarray(q_offsets),
        causal=True,
    )
    for i in range(b):
        exp = oracles.gqa_attention(
            q[i : i + 1], k[i : i + 1, :, : kv_lens[i]],
            v[i : i + 1, :, : kv_lens[i]],
            causal=True, q_offset=int(q_offsets[i]),
        )
        assert_rel_l2(np.asarray(got)[i : i + 1], exp, tol=1e-2)


def test_flash_attention_ragged_zero_len(rng):
    """kv_len == 0 rows must return zeros, not NaN."""
    q = rng.standard_normal((2, 2, 32, 32), dtype=np.float32)
    k = rng.standard_normal((2, 2, 64, 32), dtype=np.float32)
    v = rng.standard_normal((2, 2, 64, 32), dtype=np.float32)
    got = ops.flash_attention_ragged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray([64, 0], dtype=jnp.int32),
        jnp.asarray([32, 0], dtype=jnp.int32),
        causal=True,
    )
    assert np.isfinite(np.asarray(got)).all()
    assert np.abs(np.asarray(got)[1]).max() == 0.0


@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_vs_float64(rng, causal):
    """Pallas backward vs a float64 numpy oracle (GQA + ragged tails)."""
    from flashattention_kernel_project_tpu.ops.flash_attention import (
        _bwd,
        _fwd,
    )

    b, hq, hkv, n, s, d = 1, 4, 2, 96, 160, 32
    q = rng.standard_normal((b, hq, n, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    g = rng.standard_normal((b, hq, n, d), dtype=np.float32)
    sm = 1.0 / np.sqrt(d)

    group = hq // hkv
    kr = np.repeat(k.astype(np.float64), group, 1)
    vr = np.repeat(v.astype(np.float64), group, 1)
    S = np.einsum("bhnd,bhsd->bhns", q.astype(np.float64), kr) * sm
    if causal:
        mask = np.arange(s)[None, :] <= np.arange(n)[:, None]
        S = np.where(mask[None, None], S, -np.inf)
    P = np.exp(S - S.max(-1, keepdims=True))
    P /= P.sum(-1, keepdims=True)
    g64 = g.astype(np.float64)
    dv64 = np.einsum("bhns,bhnd->bhsd", P, g64)
    dP = np.einsum("bhnd,bhsd->bhns", g64, vr)
    delta = (P * dP).sum(-1, keepdims=True)
    dS = P * (dP - delta) * sm
    dq64 = np.einsum("bhns,bhsd->bhnd", dS, kr)
    dk64 = np.einsum("bhns,bhnd->bhsd", dS, q.astype(np.float64))
    # fold the GQA group back onto KV heads
    dk64 = dk64.reshape(b, hkv, group, s, d).sum(2)
    dv64 = dv64.reshape(b, hkv, group, s, d).sum(2)

    qj, kj, vj, gj = map(jnp.asarray, (q, k, v, g))
    kw = dict(causal=causal, sm_scale=sm, block_q=32, block_k=64,
              interpret=True)
    out, lse = _fwd(qj, kj, vj, jnp.full((b,), s), jnp.zeros((b,)), **kw)
    dq, dk, dv = _bwd(
        (qj, kj, vj, out, lse), gj, q_offset=0, window=None, sinks=0, **kw
    )
    for got, want in ((dq, dq64), (dk, dk64), (dv, dv64)):
        assert_rel_l2(np.asarray(got, np.float64), want, tol=5e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_gradients(rng, causal):
    """Gradients vs autodiff through the naive attention expression."""
    q, k, v = _rand_qkv(rng, 1, 4, 2, 64, 96, 32)
    qj, kj, vj = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)

    def naive(q, k, v):
        g = q.shape[1] // k.shape[1]
        kk = jnp.repeat(k, g, axis=1)
        vv = jnp.repeat(v, g, axis=1)
        s = jnp.einsum("bhnd,bhsd->bhns", q, kk) / np.sqrt(q.shape[-1])
        if causal:
            n, sl = s.shape[-2], s.shape[-1]
            mask = jnp.arange(sl)[None, :] > jnp.arange(n)[:, None]
            s = jnp.where(mask, -1e30, s)
        p = jax.nn.softmax(s, axis=-1)
        return jnp.einsum("bhns,bhsd->bhnd", p, vv)

    def loss_flash(q, k, v):
        o = ops.flash_attention(q, k, v, causal=causal)
        return jnp.sum(o * jnp.cos(o))

    def loss_naive(q, k, v):
        o = naive(q, k, v)
        return jnp.sum(o * jnp.cos(o))

    g_flash = jax.grad(loss_flash, argnums=(0, 1, 2))(qj, kj, vj)
    g_naive = jax.grad(loss_naive, argnums=(0, 1, 2))(qj, kj, vj)
    for gf, gn in zip(g_flash, g_naive):
        assert_rel_l2(gf, gn, tol=1e-3)


# ---------------------------------------------------------------------------
# KV-quantized forward (fused dequant at the K/V load stage — SURVEY Phase 4)
# ---------------------------------------------------------------------------

def _dequant_kv(k_q, k_s, v_q, v_s):
    kd = np.asarray(k_q, np.float32) * np.asarray(k_s, np.float32)
    vd = np.asarray(v_q, np.float32) * np.asarray(v_s, np.float32)
    return kd, vd


@pytest.mark.parametrize("causal", [False, True])
def test_flash_kv_quant_int8(rng, causal):
    """Dense forward vs the oracle on the DEQUANTIZED cache (same-bit-width
    comparison per BASELINE's numerics gate), tail block + GQA included."""
    q, k, v = _rand_qkv(rng, 2, 4, 2, 128, 320, 64)  # 320 % 128 -> tail
    k_q, k_s, v_q, v_s = ops.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    got = ops.flash_attention_kv_quant(
        jnp.asarray(q), k_q, k_s, v_q, v_s,
        causal=causal,
    )
    kd, vd = _dequant_kv(k_q, k_s, v_q, v_s)
    exp = oracles.gqa_attention(q, kd, vd, causal=causal)
    assert_rel_l2(got, exp, tol=1e-2)


def test_flash_kv_quant_fp8(rng):
    """fp8_e4m3 cache shares the kernel (8-bit cast + per-token scales)."""
    q, k, v = _rand_qkv(rng, 1, 4, 4, 64, 256, 32)
    k_q, k_s, v_q, v_s = ops.quantize_kv(
        jnp.asarray(k), jnp.asarray(v), fmt="fp8"
    )
    assert k_q.dtype == jnp.float8_e4m3fn
    got = ops.flash_attention_kv_quant(
        jnp.asarray(q), k_q, k_s, v_q, v_s,
        causal=True,
    )
    kd, vd = _dequant_kv(k_q, k_s, v_q, v_s)
    exp = oracles.gqa_attention(q, kd, vd, causal=True)
    assert_rel_l2(got, exp, tol=1e-2)


def test_flash_kv_quant_matches_bf16_path(rng):
    """The fused-dequant kernel must agree with running the plain kernel on
    the dequantized arrays (kernel-vs-kernel, isolates the quant plumbing)."""
    q, k, v = _rand_qkv(rng, 1, 2, 2, 96, 160, 32)
    k_q, k_s, v_q, v_s = ops.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    got = ops.flash_attention_kv_quant(
        jnp.asarray(q), k_q, k_s, v_q, v_s,
        causal=True,
    )
    kd, vd = _dequant_kv(k_q, k_s, v_q, v_s)
    ref = ops.flash_attention(
        jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd),
        causal=True,
    )
    assert_rel_l2(got, np.asarray(ref), tol=1e-3)


def test_flash_ragged_kv_quant(rng):
    """Ragged fused-dequant kernel: per-batch lengths/offsets against a live
    int8 cache — the engine.extend path — incl. a zero-length row."""
    b, hq, hkv, n, s, d = 3, 4, 2, 64, 160, 32
    q = rng.standard_normal((b, hq, n, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    kv_lens = np.array([160, 100, 0], np.int32)
    q_offsets = np.array([96, 36, 0], np.int32)
    k_q, k_s, v_q, v_s = ops.quantize_kv(jnp.asarray(k), jnp.asarray(v))

    got = np.asarray(ops.flash_attention_ragged_kv_quant(
        jnp.asarray(q), k_q, k_s, v_q, v_s,
        jnp.asarray(kv_lens), jnp.asarray(q_offsets),
        causal=True,
    ))
    assert np.isfinite(got).all()
    assert np.abs(got[2]).max() == 0.0  # dead row stays exact zeros
    kd, vd = _dequant_kv(k_q, k_s, v_q, v_s)
    for i in range(2):
        exp = oracles.gqa_attention(
            q[i : i + 1], kd[i : i + 1, :, : kv_lens[i]],
            vd[i : i + 1, :, : kv_lens[i]],
            causal=True, q_offset=int(q_offsets[i]),
        )
        assert_rel_l2(got[i : i + 1], exp, tol=1e-2)


# ---------------------------------------------------------------------------
# Sliding-window attention (causal band; block-level skip outside the band)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [48, 128, 1000])
def test_flash_forward_window(rng, window):
    """Windowed causal forward vs the banded oracle; window=1000 > seq is
    identical to plain causal; the band crosses several 64-row tiles."""
    q, k, v = _rand_qkv(rng, 1, 4, 2, 256, 256, 32)
    got = ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        causal=True, window=window,
    )
    exp = oracles.gqa_attention(q, k, v, causal=True, window=window)
    assert_rel_l2(got, exp, tol=1e-2)
    if window > 256:
        plain = ops.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            causal=True,
        )
        assert_rel_l2(got, np.asarray(plain), tol=1e-6)


def test_flash_window_gradients(rng):
    """Backward honors the band: grads vs naive banded-softmax autodiff."""
    q, k, v = _rand_qkv(rng, 1, 2, 2, 128, 128, 32)
    qj, kj, vj = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    window = 40

    def naive(q, k, v):
        s = jnp.einsum("bhnd,bhsd->bhns", q, k) / np.sqrt(q.shape[-1])
        row = jnp.arange(128)[:, None]
        col = jnp.arange(128)[None, :]
        mask = jnp.logical_or(col > row, col <= row - window)
        s = jnp.where(mask, -1e30, s)
        p = jax.nn.softmax(s, axis=-1)
        return jnp.einsum("bhns,bhsd->bhnd", p, v)

    def loss_f(q, k, v):
        o = ops.flash_attention(
            q, k, v, causal=True, window=window
        )
        return jnp.sum(o * jnp.cos(o))

    def loss_n(q, k, v):
        o = naive(q, k, v)
        return jnp.sum(o * jnp.cos(o))

    gf = jax.grad(loss_f, argnums=(0, 1, 2))(qj, kj, vj)
    gn = jax.grad(loss_n, argnums=(0, 1, 2))(qj, kj, vj)
    for a, b in zip(gf, gn):
        assert_rel_l2(np.asarray(a), np.asarray(b), tol=1e-3)


def test_flash_ragged_window(rng):
    """Ragged kernel with a window: per-batch lengths/offsets + band."""
    b, hq, hkv, n, s, d = 2, 4, 2, 64, 160, 32
    q = rng.standard_normal((b, hq, n, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    kv_lens = np.array([160, 100], np.int32)
    q_offsets = np.array([96, 36], np.int32)
    window = 50
    got = np.asarray(ops.flash_attention_ragged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(kv_lens), jnp.asarray(q_offsets),
        causal=True, window=window,
    ))
    for i in range(b):
        exp = oracles.gqa_attention(
            q[i : i + 1], k[i : i + 1, :, : kv_lens[i]],
            v[i : i + 1, :, : kv_lens[i]],
            causal=True, q_offset=int(q_offsets[i]), window=window,
        )
        assert_rel_l2(got[i : i + 1], exp, tol=1e-2)


def test_flash_kv_quant_window(rng):
    """Windowed forward against the quantized cache."""
    q, k, v = _rand_qkv(rng, 1, 2, 2, 128, 128, 32)
    k_q, k_s, v_q, v_s = ops.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    got = ops.flash_attention_kv_quant(
        jnp.asarray(q), k_q, k_s, v_q, v_s,
        causal=True, window=40,
    )
    kd, vd = _dequant_kv(k_q, k_s, v_q, v_s)
    exp = oracles.gqa_attention(q, kd, vd, causal=True, window=40)
    assert_rel_l2(got, exp, tol=1e-2)


def test_flash_forward_window_sinks(rng):
    """StreamingLLM attention sinks: first `sinks` keys stay visible below
    the sliding window; blocks between sink and band stay skipped."""
    q, k, v = _rand_qkv(rng, 1, 4, 2, 256, 256, 32)
    got = ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        causal=True, window=48, sinks=16,
    )
    exp = oracles.gqa_attention(q, k, v, causal=True, window=48, sinks=16)
    assert_rel_l2(got, exp, tol=1e-2)


def test_flash_window_sinks_gradients(rng):
    q, k, v = _rand_qkv(rng, 1, 2, 2, 128, 128, 32)
    qj, kj, vj = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    window, sinks = 40, 8

    def naive(q, k, v):
        s = jnp.einsum("bhnd,bhsd->bhns", q, k) / np.sqrt(q.shape[-1])
        row = jnp.arange(128)[:, None]
        col = jnp.arange(128)[None, :]
        dead = jnp.logical_and(col <= row - window, col >= sinks)
        mask = jnp.logical_or(col > row, dead)
        s = jnp.where(mask, -1e30, s)
        p = jax.nn.softmax(s, axis=-1)
        return jnp.einsum("bhns,bhsd->bhnd", p, v)

    def loss_f(q, k, v):
        o = ops.flash_attention(
            q, k, v, causal=True,
            window=window, sinks=sinks,
        )
        return jnp.sum(o * jnp.cos(o))

    def loss_n(q, k, v):
        return jnp.sum(naive(q, k, v) * jnp.cos(naive(q, k, v)))

    gf = jax.grad(loss_f, argnums=(0, 1, 2))(qj, kj, vj)
    gn = jax.grad(loss_n, argnums=(0, 1, 2))(qj, kj, vj)
    for a, b in zip(gf, gn):
        assert_rel_l2(np.asarray(a), np.asarray(b), tol=1e-3)


def test_flash_forward_fuzz_configs(rng):
    """Property sweep: random (shape, GQA ratio, causal, window, sinks,
    tiles) combinations against the oracle — the corner
    interactions no single targeted test covers."""
    from flashattention_kernel_project_tpu.ops.flash_attention import _fwd

    r = np.random.default_rng(123)
    for trial in range(12):
        hkv = int(r.choice([1, 2, 4]))
        g = int(r.choice([1, 2, 4]))
        n = int(r.choice([48, 64, 96, 128]))
        d = int(r.choice([32, 64]))
        causal = bool(r.integers(0, 2))
        window = None
        sinks = 0
        if causal and r.integers(0, 2):
            window = int(r.integers(8, n))
            if r.integers(0, 2):
                sinks = int(r.integers(1, 8))
        bq = int(r.choice([16, 32]))
        bk = int(r.choice([16, 32]))
        q = rng.standard_normal((1, hkv * g, n, d), dtype=np.float32)
        k = rng.standard_normal((1, hkv, n, d), dtype=np.float32)
        v = rng.standard_normal((1, hkv, n, d), dtype=np.float32)
        out, _ = _fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.full((1,), n), jnp.zeros((1,)), causal=causal,
            sm_scale=None, interpret=None, window=window, sinks=sinks,
            block_q=bq, block_k=bk,
        )
        exp = oracles.gqa_attention(
            q, k, v, causal=causal, window=window, sinks=sinks
        )
        cfgs = (hkv, g, n, d, causal, window, sinks, bq, bk)
        assert_rel_l2(np.asarray(out), exp, 2e-5, msg=str(cfgs))


def test_flash_backward_fuzz_configs(rng):
    """Backward property sweep: random (GQA, causal, window, length)
    configs — Pallas dq/dk/dv vs the fp32 autodiff reference; 100 tokens
    span two tiles with a tail."""
    r = np.random.default_rng(321)
    for trial in range(6):
        hkv = int(r.choice([1, 2]))
        g = int(r.choice([1, 2]))
        n = int(r.choice([48, 100]))
        d = 32
        causal = bool(r.integers(0, 2))
        window = int(r.integers(8, n)) if causal and r.integers(0, 2) else None
        q = jnp.asarray(rng.standard_normal((1, hkv * g, n, d), dtype=np.float32))
        k = jnp.asarray(rng.standard_normal((1, hkv, n, d), dtype=np.float32))
        v = jnp.asarray(rng.standard_normal((1, hkv, n, d), dtype=np.float32))

        def loss(q, k, v, causal=causal, window=window):
            o = ops.flash_attention(q, k, v, causal=causal, window=window)
            return jnp.sum(o * jnp.sin(o))

        gq, gk, gv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

        def ref_loss(q, k, v, causal=causal, window=window):
            group = q.shape[1] // k.shape[1]
            kr = jnp.repeat(k, group, axis=1)
            vr = jnp.repeat(v, group, axis=1)
            s = jnp.einsum("bhnd,bhmd->bhnm", q, kr) / np.sqrt(d)
            row = jnp.arange(n)[:, None]
            col = jnp.arange(n)[None, :]
            mask = jnp.ones((n, n), bool)
            if causal:
                mask &= col <= row
            if window is not None:
                mask &= col > row - window
            s = jnp.where(mask[None, None], s, -1e30)
            p = jax.nn.softmax(s, axis=-1)
            o = jnp.einsum("bhnm,bhmd->bhnd", p, vr)
            return jnp.sum(o * jnp.sin(o))

        rq, rk, rv = jax.grad(ref_loss, argnums=(0, 1, 2))(q, k, v)
        cfgs = (hkv, g, n, causal, window)
        assert_rel_l2(np.asarray(gq), np.asarray(rq), 5e-4, msg=f"dq {cfgs}")
        assert_rel_l2(np.asarray(gk), np.asarray(rk), 5e-4, msg=f"dk {cfgs}")
        assert_rel_l2(np.asarray(gv), np.asarray(rv), 5e-4, msg=f"dv {cfgs}")
