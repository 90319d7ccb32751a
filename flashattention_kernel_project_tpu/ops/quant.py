"""Quantizers for 8-bit weights and the 8-bit KV cache.

  * weights: int8 or fp8 (e4m3) with per-output-column scales; the model's
    projections dequantise in XLA (models/engine.py `_proj`).
  * KV cache: per-token scales; the attention kernels dequantise each tile
    after its load, so the cache crosses device memory in 8 bits. Decode is
    bandwidth-bound, so halving the KV bytes is the whole game.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def quantize_int8(x: jax.Array, axis: int = -1) -> tuple[jax.Array, jax.Array]:
    """Symmetric absmax int8 quantization along `axis` (scale per slice).

    Returns (values int8, scales f32 with `axis` kept as size 1).
    """
    absmax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=axis, keepdims=True)
    scale = jnp.maximum(absmax, 1e-8) / 127.0
    q = jnp.clip(jnp.round(x.astype(jnp.float32) / scale), -127, 127)
    return q.astype(jnp.int8), scale


def dequantize_int8(q: jax.Array, scale: jax.Array, dtype=jnp.float32) -> jax.Array:
    return (q.astype(jnp.float32) * scale).astype(dtype)


def quantize_fp8(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """FP8 (e4m3) storage quantization with per-tensor scale headroom."""
    absmax = jnp.max(jnp.abs(x.astype(jnp.float32)))
    scale = jnp.maximum(absmax, 1e-8) / 448.0  # e4m3 max normal
    return (x.astype(jnp.float32) / scale).astype(jnp.float8_e4m3fn), scale


def quantize_fp8_tokenwise(
    x: jax.Array, axis: int = -1
) -> tuple[jax.Array, jax.Array]:
    """FP8 (e4m3) quantization with a scale per slice along `axis` (the
    per-token KV-cache form; scale keeps `axis` as size 1, like
    quantize_int8)."""
    absmax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=axis, keepdims=True)
    scale = jnp.maximum(absmax, 1e-8) / 448.0  # e4m3 max normal
    return (x.astype(jnp.float32) / scale).astype(jnp.float8_e4m3fn), scale


def dequantize_fp8(q: jax.Array, scale: jax.Array, dtype=jnp.float32) -> jax.Array:
    return (q.astype(jnp.float32) * scale).astype(dtype)


def quantize_fp8_weights(w: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Per-output-column FP8 (e4m3) weight quantization:
    w [K, N] -> (w_q fp8 [K, N], scale f32 [1, N])."""
    return quantize_fp8_tokenwise(w, axis=0)


# ---------------------------------------------------------------------------
# KV-cache quantization (per-token scales; consumed by the attention kernels)
# ---------------------------------------------------------------------------

def quantize_kv(
    k: jax.Array, v: jax.Array, *, fmt: str = "int8"
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Per-token symmetric 8-bit quantization of a KV cache.

    k, v: [..., S, D] -> (k_q, k_scale [..., S, 1], v_q, v_scale);
    fmt: "int8" (symmetric absmax/127) or "fp8" (float8_e4m3fn, absmax/448).
    """
    if fmt == "fp8":
        k_q, k_scale = quantize_fp8_tokenwise(k, axis=-1)
        v_q, v_scale = quantize_fp8_tokenwise(v, axis=-1)
        return k_q, k_scale, v_q, v_scale
    k_q, k_scale = quantize_int8(k, axis=-1)
    v_q, v_scale = quantize_int8(v, axis=-1)
    return k_q, k_scale, v_q, v_scale
