"""The Hopper attention kernels (Pallas through Triton) in interpret mode
against the float64 oracle: a grid of head layouts, masks, head dims,
non-power-of-two lengths, offsets, ragged rows, 8-bit caches, logsumexp
and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattention_kernel_project_tpu import ops
from flashattention_kernel_project_tpu.utils import oracles
from flashattention_kernel_project_tpu.utils.testing import assert_rel_l2


def _qkv(rng, b, hq, hkv, n, s, d):
    return (rng.standard_normal((b, hq, n, d), dtype=np.float32),
            rng.standard_normal((b, hkv, s, d), dtype=np.float32),
            rng.standard_normal((b, hkv, s, d), dtype=np.float32))


@pytest.mark.parametrize("n,s", [(40, 40), (77, 130)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_forward_grid(rng, hq, hkv, causal, d, n, s):
    q, k, v = _qkv(rng, 1, hq, hkv, n, s, d)
    got = ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal)
    assert_rel_l2(got, oracles.gqa_attention(q, k, v, causal=causal), 1e-5)


@pytest.mark.parametrize("q_offset", [0, 17, 64])
def test_forward_q_offset(rng, q_offset):
    q, k, v = _qkv(rng, 2, 4, 2, 33, 97, 32)
    got = ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, q_offset=q_offset)
    want = oracles.gqa_attention(q, k, v, causal=True, q_offset=q_offset)
    assert_rel_l2(got, want, 1e-5)


def _dequant(x_q, x_s):
    return np.asarray(x_q, np.float32) * np.asarray(x_s, np.float32)


@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
@pytest.mark.parametrize("window,sinks", [(None, 0), (20, 0), (20, 3)])
def test_ragged_grid(rng, window, sinks, fmt):
    """Per-row KV lengths and query offsets, optional band and sinks,
    optional 8-bit cache (checked against its dequantized values)."""
    b, hq, hkv, n, s, d = 3, 4, 2, 24, 100, 32
    q, k, v = _qkv(rng, b, hq, hkv, n, s, d)
    lens = np.array([100, 61, 24], np.int32)
    offs = lens - n
    kw = dict(causal=True, window=window, sinks=sinks)
    if fmt is None:
        got = ops.flash_attention_ragged(
            *map(jnp.asarray, (q, k, v, lens, offs)), **kw)
    else:
        kq, ks, vq, vs = ops.quantize_kv(jnp.asarray(k), jnp.asarray(v),
                                         fmt=fmt)
        got = ops.flash_attention_ragged_kv_quant(
            jnp.asarray(q), kq, ks, vq, vs, jnp.asarray(lens),
            jnp.asarray(offs), **kw)
        k, v = _dequant(kq, ks), _dequant(vq, vs)
    for i in range(b):
        want = oracles.gqa_attention(
            q[i:i + 1], k[i:i + 1, :, :lens[i]], v[i:i + 1, :, :lens[i]],
            causal=True, q_offset=int(offs[i]), window=window, sinks=sinks)
        assert_rel_l2(np.asarray(got)[i:i + 1], want, 1e-5)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 16)])
def test_lse_matches_oracle(rng, causal, window):
    q, k, v = _qkv(rng, 1, 4, 2, 48, 48, 32)
    out, lse = ops.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window)
    kr = np.repeat(k.astype(np.float64), 2, 1)
    sc = np.einsum("bhnd,bhsd->bhns", q.astype(np.float64), kr) / np.sqrt(32)
    row, col = np.arange(48)[:, None], np.arange(48)[None, :]
    mask = np.ones((48, 48), bool)
    if causal:
        mask &= col <= row
    if window is not None:
        mask &= col > row - window
    sc = np.where(mask, sc, -np.inf)
    m = sc.max(-1, keepdims=True)
    want = np.log(np.exp(sc - m).sum(-1)) + m[..., 0]
    np.testing.assert_allclose(np.asarray(lse), want, rtol=1e-5, atol=1e-5)
    assert_rel_l2(out, oracles.gqa_attention(q, k, v, causal=causal,
                                             window=window), 1e-5)


def _naive(q, k, v, causal, window, sinks):
    g = q.shape[1] // k.shape[1]
    kk, vv = jnp.repeat(k, g, axis=1), jnp.repeat(v, g, axis=1)
    n, s = q.shape[2], k.shape[2]
    sc = jnp.einsum("bhnd,bhsd->bhns", q, kk) / np.sqrt(q.shape[-1])
    row, col = jnp.arange(n)[:, None], jnp.arange(s)[None, :]
    mask = jnp.ones((n, s), bool)
    if causal:
        mask &= col <= row
    if window is not None:
        mask &= (col > row - window) | (col < sinks)
    p = jax.nn.softmax(jnp.where(mask, sc, -1e30), axis=-1)
    return jnp.einsum("bhns,bhsd->bhnd", p, vv)


@pytest.mark.parametrize("causal,window,sinks", [
    (False, None, 0), (True, None, 0), (True, 12, 0), (True, 12, 3)])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 1)])
def test_gradients_grid(rng, hq, hkv, causal, window, sinks):
    """dq/dk/dv of the two backward kernels vs float32 autodiff through
    the plain expression (two tiles with a tail, GQA sums)."""
    q, k, v = map(jnp.asarray, _qkv(rng, 1, hq, hkv, 100, 100, 32))

    def loss(fn):
        return lambda q, k, v: jnp.sum(jnp.sin(fn(q, k, v)))

    flash = loss(lambda q, k, v: ops.flash_attention(
        q, k, v, causal=causal, window=window, sinks=sinks))
    naive = loss(lambda q, k, v: _naive(q, k, v, causal, window, sinks))
    got = jax.grad(flash, (0, 1, 2))(q, k, v)
    want = jax.grad(naive, (0, 1, 2))(q, k, v)
    for name, a, b in zip("qkv", got, want):
        assert_rel_l2(np.asarray(a), np.asarray(b), 1e-4, msg=f"d{name}")


def test_gradients_bf16(rng):
    q, k, v = (jnp.asarray(x, jnp.bfloat16)
               for x in _qkv(rng, 1, 4, 2, 64, 64, 64))

    def loss(fn):
        return lambda q, k, v: jnp.sum(fn(q, k, v).astype(jnp.float32) ** 2)

    got = jax.grad(loss(lambda q, k, v: ops.flash_attention(
        q, k, v, causal=True)), (0, 1, 2))(q, k, v)
    f32 = [x.astype(jnp.float32) for x in (q, k, v)]
    want = jax.grad(loss(lambda q, k, v: _naive(q, k, v, True, None, 0)),
                    (0, 1, 2))(*f32)
    for a, b in zip(got, want):
        assert_rel_l2(np.asarray(a, np.float32), np.asarray(b), 2e-2)


def test_empty_rows_give_zeros_and_finite_lse(rng):
    q, k, v = _qkv(rng, 2, 2, 2, 16, 32, 32)
    out = ops.flash_attention_ragged(
        *map(jnp.asarray, (q, k, v)), jnp.asarray([32, 0], jnp.int32),
        jnp.asarray([16, 0], jnp.int32))
    assert np.isfinite(np.asarray(out)).all()
    assert np.abs(np.asarray(out)[1]).max() == 0.0
