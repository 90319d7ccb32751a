"""Split-KV decode vs the attention oracle, fp and int8 KV paths.

The decode shape is the reference's streaming kernel problem (B sequences,
small Q block, K/V streamed over seq — flashattn_streaming_16x16.cu mains);
the split-merge uses the associative (m, l, y) algebra those kernels
introduced."""

import jax.numpy as jnp
import numpy as np
import pytest

from flashattention_kernel_project_tpu import ops
from flashattention_kernel_project_tpu.utils import oracles
from flashattention_kernel_project_tpu.utils.testing import assert_rel_l2


def _decode_oracle(q, k_cache, v_cache, lengths):
    """Per-sequence masked GQA attention for the single query token."""
    b, hq, d = q.shape
    hkv = k_cache.shape[1]
    outs = []
    for i in range(b):
        s = int(lengths[i])
        o = oracles.gqa_attention(
            q[i : i + 1, :, None, :],  # [1, hq, 1, d]
            k_cache[i : i + 1, :, :s],
            v_cache[i : i + 1, :, :s],
        )
        outs.append(o[:, :, 0])
    return np.concatenate(outs, axis=0)


@pytest.mark.parametrize("n_splits", [1, 4])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.smoke
def test_flash_decode(rng, n_splits, hq, hkv):
    b, s_max, d = 3, 160, 64
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s_max, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s_max, d), dtype=np.float32)
    lengths = np.array([160, 97, 1], dtype=np.int32)

    got = ops.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        n_splits=n_splits,
    )
    exp = _decode_oracle(q, k, v, lengths)
    assert_rel_l2(got, exp, tol=1e-2)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_flash_decode_int8(rng, fmt):
    """8-bit cache (int8 or fp8) vs the oracle on the dequantized cache."""
    b, hq, hkv, s_max, d = 2, 8, 2, 128, 64
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s_max, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s_max, d), dtype=np.float32)
    lengths = np.array([128, 57], dtype=np.int32)

    k_q, k_s, v_q, v_s = ops.quantize_kv(
        jnp.asarray(k), jnp.asarray(v), fmt=fmt
    )
    got = ops.flash_decode_int8(
        jnp.asarray(q), k_q, k_s, v_q, v_s, jnp.asarray(lengths), n_splits=4,
    )
    # oracle at matching bit-width: dequantized cache through fp32 attention
    k_dq = np.asarray(ops.dequantize_int8(k_q, k_s))
    v_dq = np.asarray(ops.dequantize_int8(v_q, v_s))
    exp = _decode_oracle(q, k_dq, v_dq, lengths)
    assert_rel_l2(got, exp, tol=1e-2)


def test_flash_decode_matches_flash_attention(rng):
    """Decode of the last position == causal flash_attention's last row."""
    b, hq, hkv, s, d = 2, 4, 2, 96, 32
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    q_full = rng.standard_normal((b, hq, s, d), dtype=np.float32)

    full = ops.flash_attention(
        jnp.asarray(q_full), jnp.asarray(k), jnp.asarray(v), causal=True,
    )
    dec = ops.flash_decode(
        jnp.asarray(q_full[:, :, -1]), jnp.asarray(k), jnp.asarray(v),
        jnp.full((b,), s, dtype=jnp.int32), n_splits=2,
    )
    assert_rel_l2(dec, np.asarray(full)[:, :, -1], tol=1e-3)


def test_flash_decode_fp8(rng):
    """fp8_e4m3 KV cache with fused dequant, vs the fp32 oracle at the
    quantized bit-width's 1e-2 gate (BASELINE numerics target)."""
    b, hq, hkv, s, d = 2, 8, 2, 256, 64
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    lengths = np.array([s, 100], np.int32)

    kq, ks, vq, vs = ops.quantize_kv(jnp.asarray(k), jnp.asarray(v), fmt="fp8")
    assert kq.dtype == jnp.float8_e4m3fn
    got = ops.flash_decode_fp8(
        jnp.asarray(q), kq, ks, vq, vs, jnp.asarray(lengths), n_splits=4
    )
    # "same bit-width" oracle (BASELINE numerics gate): e4m3's 3-bit mantissa
    # carries ~2.5% inherent quantization error, so the fp32 reference must
    # consume the same dequantized K/V the kernel does.
    k_dq = np.asarray(kq.astype(jnp.float32)) * np.asarray(ks)
    v_dq = np.asarray(vq.astype(jnp.float32)) * np.asarray(vs)
    for i in range(b):
        exp = oracles.gqa_attention(
            q[i : i + 1, :, None],
            k_dq[i : i + 1, :, : lengths[i]],
            v_dq[i : i + 1, :, : lengths[i]],
            causal=False,
        )[:, :, 0]
        assert_rel_l2(np.asarray(got)[i : i + 1], exp, tol=1e-2)


def test_flash_decode_window(rng):
    """Sliding-window decode: only the last `window` keys contribute;
    out-of-window splits are skipped."""
    b, hq, hkv, s, d = 2, 8, 2, 512, 64
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    lengths = np.array([512, 300], np.int32)
    window = 128
    got = np.asarray(ops.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths), n_splits=4, window=window,
    ))
    for i in range(b):
        lo = max(0, int(lengths[i]) - window)
        exp = oracles.gqa_attention(
            q[i : i + 1, :, None], k[i : i + 1, :, lo : lengths[i]],
            v[i : i + 1, :, lo : lengths[i]], causal=False,
        )[:, :, 0]
        assert_rel_l2(got[i : i + 1], exp, tol=1e-2)


@pytest.mark.parametrize("sinks", [0, 5])
def test_flash_decode_int8_window(rng, sinks):
    b, hq, hkv, s, d = 2, 8, 2, 384, 32
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    lengths = np.array([384, 200], np.int32)
    window = 100
    k_q, k_s, v_q, v_s = ops.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    got = np.asarray(ops.flash_decode_int8(
        jnp.asarray(q), k_q, k_s, v_q, v_s, jnp.asarray(lengths),
        n_splits=3, window=window, sinks=sinks,
    ))
    kd = np.asarray(k_q, np.float32) * np.asarray(k_s, np.float32)
    vd = np.asarray(v_q, np.float32) * np.asarray(v_s, np.float32)
    for i in range(b):
        lo = max(0, int(lengths[i]) - window)
        keep = np.r_[0:min(sinks, lo), lo:int(lengths[i])]
        exp = oracles.gqa_attention(
            q[i : i + 1, :, None], kd[i : i + 1, :, keep],
            vd[i : i + 1, :, keep], causal=False,
        )[:, :, 0]
        assert_rel_l2(got[i : i + 1], exp, tol=1e-2)


def test_flash_decode_window_sinks(rng):
    """Sink keys + window band in decode; the gap between them is skipped
    but sink splits keep their own DMA."""
    b, hq, hkv, s, d = 2, 8, 2, 512, 32
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    lengths = np.array([512, 300], np.int32)
    window, sinks = 128, 64
    got = np.asarray(ops.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths), n_splits=4, window=window, sinks=sinks,
    ))
    for i in range(b):
        ln = int(lengths[i])
        lo = max(0, ln - window)
        keep = sorted(set(range(min(sinks, ln))) | set(range(lo, ln)))
        exp = oracles.gqa_attention(
            q[i : i + 1, :, None], k[i : i + 1, :, keep],
            v[i : i + 1, :, keep], causal=False,
        )[:, :, 0]
        assert_rel_l2(got[i : i + 1], exp, tol=1e-2)
