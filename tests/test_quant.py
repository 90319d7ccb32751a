"""Quantizer numerics: round trips within one quantization step."""

import jax.numpy as jnp
import numpy as np

from flashattention_kernel_project_tpu import ops
from flashattention_kernel_project_tpu.utils.testing import assert_rel_l2
import pytest


@pytest.mark.smoke
def test_int8_roundtrip(rng):
    x = rng.standard_normal((64, 256), dtype=np.float32)
    q, scale = ops.quantize_int8(jnp.asarray(x))
    back = ops.dequantize_int8(q, scale)
    # absmax/127 quantization step bound
    step = np.abs(x).max(-1, keepdims=True) / 127.0
    assert np.all(np.abs(np.asarray(back) - x) <= step + 1e-6)


def test_fp8_roundtrip(rng):
    x = rng.standard_normal((64, 128), dtype=np.float32)
    q, scale = ops.quantize_fp8(jnp.asarray(x))
    back = ops.dequantize_fp8(q, scale)
    assert_rel_l2(back, x, tol=0.06)  # e4m3 has ~2 decimal digits


def test_quantize_kv_shapes(rng):
    k = rng.standard_normal((2, 4, 64, 32), dtype=np.float32)
    v = rng.standard_normal((2, 4, 64, 32), dtype=np.float32)
    k_q, k_s, v_q, v_s = ops.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    assert k_q.shape == k.shape and k_q.dtype == jnp.int8
    assert k_s.shape == (2, 4, 64, 1)
    back = ops.dequantize_int8(k_q, k_s)
    step = np.abs(k).max(-1, keepdims=True) / 127.0
    assert np.all(np.abs(np.asarray(back) - k) <= step + 1e-6)
