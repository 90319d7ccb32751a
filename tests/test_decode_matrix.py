"""Split-KV decode over linear and paged caches, the paged extend (gather +
fused forward) and the paged appends (XLA scatters) against the float64
oracle, in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest

from flashattention_kernel_project_tpu import ops
from flashattention_kernel_project_tpu.utils import oracles
from flashattention_kernel_project_tpu.utils.testing import assert_rel_l2

B, HQ, HKV, D = 3, 8, 2, 32


def _cache(rng, s):
    k = rng.standard_normal((B, HKV, s, D), dtype=np.float32)
    v = rng.standard_normal((B, HKV, s, D), dtype=np.float32)
    return k, v


def _quant(k, v, fmt):
    if fmt == "bf16":
        return None, k, v
    kq, ks, vq, vs = ops.quantize_kv(jnp.asarray(k), jnp.asarray(v), fmt=fmt)
    deq = (np.asarray(kq, np.float32) * np.asarray(ks),
           np.asarray(vq, np.float32) * np.asarray(vs))
    return (kq, ks, vq, vs), *deq


def _decode_oracle(q, k, v, lens, window=None, sinks=0):
    out = []
    for i in range(len(lens)):
        lo = 0 if window is None else max(0, int(lens[i]) - window)
        keep = np.r_[0:min(sinks, lo), lo:int(lens[i])]
        out.append(oracles.gqa_attention(
            q[i:i + 1, :, None], k[i:i + 1, :, keep], v[i:i + 1, :, keep])[
                :, :, 0])
    return np.concatenate(out)


@pytest.mark.parametrize("window,sinks", [(None, 0), (30, 0), (30, 4)])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8"])
def test_linear_decode_grid(rng, fmt, window, sinks):
    s = 200
    k, v = _cache(rng, s)
    q = rng.standard_normal((B, HQ, D), dtype=np.float32)
    lens = np.array([200, 77, 1], np.int32)
    packed, kd, vd = _quant(k, v, fmt)
    kw = dict(n_splits=3, window=window, sinks=sinks)
    if packed is None:
        got = ops.flash_decode(*map(jnp.asarray, (q, k, v, lens)), **kw)
    else:
        got = ops.flash_decode_int8(jnp.asarray(q), *packed,
                                    jnp.asarray(lens), **kw)
    assert_rel_l2(got, _decode_oracle(q, kd, vd, lens, window, sinks), 1e-5)


def test_decode_partials_merge_across_shards(rng):
    """return_partials: two halves of a cache, merged, equal the whole."""
    k, v = _cache(rng, 128)
    q = rng.standard_normal((B, HQ, D), dtype=np.float32)
    lens = np.array([128, 90, 40], np.int32)
    parts = []
    for h in range(2):
        loc = np.clip(lens - 64 * h, 0, 64)
        m, l, y = ops.flash_decode(
            jnp.asarray(q), jnp.asarray(k[:, :, 64 * h:64 * (h + 1)]),
            jnp.asarray(v[:, :, 64 * h:64 * (h + 1)]), jnp.asarray(loc),
            return_partials=True)
        parts.append((m, l, y))
    m, l, y = (jnp.stack(x, axis=-3) for x in zip(*parts))
    got = ops.merge_partials(m, l, y).reshape(B, HQ, D)
    assert_rel_l2(got, _decode_oracle(q, k, v, lens), 1e-5)


def _to_pages(x, page, perm):
    """[B, Hkv, S, X] -> pool [1 + B*S/page, Hkv, page, X] with sequence b's
    page p at pool index perm[b * S/page + p]; page 0 is the junk page."""
    b, h, s, w = x.shape
    n = s // page
    pages = x.reshape(b, h, n, page, w).transpose(0, 2, 1, 3, 4)
    pool = np.zeros((b * n + 1, h, page, w), x.dtype)
    pool[perm] = pages.reshape(b * n, h, page, w)
    return pool


@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_paged_decode_shuffled_grid(rng, fmt, page):
    s = 256
    k, v = _cache(rng, s)
    q = rng.standard_normal((B, HQ, D), dtype=np.float32)
    lens = np.array([256, 130, 17], np.int32)
    n = s // page
    perm = rng.permutation(np.arange(1, B * n + 1))
    tbl = jnp.asarray(perm.reshape(B, n), jnp.int32)
    packed, kd, vd = _quant(k, v, fmt)
    if packed is None:
        got = ops.paged_flash_decode(
            jnp.asarray(q), jnp.asarray(_to_pages(k, page, perm)),
            jnp.asarray(_to_pages(v, page, perm)), tbl, jnp.asarray(lens))
    else:
        kq, ks, vq, vs = (jnp.asarray(_to_pages(np.asarray(x), page, perm))
                          for x in packed)
        got = ops.paged_flash_decode_quant(
            jnp.asarray(q), kq.astype(packed[0].dtype), ks,
            vq.astype(packed[2].dtype), vs, tbl, jnp.asarray(lens))
    assert_rel_l2(got, _decode_oracle(q, kd, vd, lens), 1e-5)


@pytest.mark.parametrize("t", [1, 7])
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_paged_extend_grid(rng, fmt, t):
    page, s = 16, 96
    k, v = _cache(rng, s)
    q = rng.standard_normal((B, HQ, t, D), dtype=np.float32)
    new = np.array([96, 50, t], np.int32)
    old = new - t
    perm = rng.permutation(np.arange(1, B * (s // page) + 1))
    tbl = jnp.asarray(perm.reshape(B, -1), jnp.int32)
    packed, kd, vd = _quant(k, v, fmt)
    if packed is None:
        got = ops.paged_flash_extend(
            jnp.asarray(q), jnp.asarray(_to_pages(k, page, perm)),
            jnp.asarray(_to_pages(v, page, perm)), tbl, jnp.asarray(new),
            jnp.asarray(old))
    else:
        kq, ks, vq, vs = (jnp.asarray(_to_pages(np.asarray(x), page, perm))
                          for x in packed)
        got = ops.paged_flash_extend(
            jnp.asarray(q), kq.astype(packed[0].dtype), vq.astype(
                packed[2].dtype), tbl, jnp.asarray(new), jnp.asarray(old),
            k_scale_pages=ks, v_scale_pages=vs)
    for i in range(B):
        want = oracles.gqa_attention(
            q[i:i + 1], kd[i:i + 1, :, :new[i]], vd[i:i + 1, :, :new[i]],
            causal=True, q_offset=int(old[i]))
        assert_rel_l2(np.asarray(got)[i:i + 1], want, 1e-5)


def test_paged_append_chunk_straddles_pages(rng):
    """A chunk crossing page boundaries lands where the tables say; the
    gathered view equals the linear cache with the chunk written in."""
    page, n_pages, maxp = 8, 16, 4
    pool = np.zeros((n_pages, HKV, page, D), np.float32)
    tbl = np.array([[3, 9, 1, 12], [5, 2, 14, 7], [4, 6, 8, 10]], np.int32)
    lens = np.array([5, 0, 13], np.int32)
    kn = rng.standard_normal((B, 10, HKV, D), dtype=np.float32)
    kp, vp = ops.paged_append_chunk(
        jnp.asarray(pool), jnp.asarray(pool), jnp.asarray(kn),
        jnp.asarray(kn), jnp.asarray(tbl), jnp.asarray(lens))
    lin = np.asarray(ops.gather_pages(kp, jnp.asarray(tbl)))
    for i in range(B):
        np.testing.assert_array_equal(
            lin[i, :, lens[i]:lens[i] + 10], kn[i].transpose(1, 0, 2))
    assert np.abs(np.asarray(kp)[0]).max() == 0.0  # junk page untouched


def test_paged_append_overflow_goes_to_junk_page(rng):
    page = 8
    pool = jnp.zeros((4, HKV, page, D), jnp.float32)
    tbl = jnp.asarray([[1, 2], [3, 3], [3, 3]], jnp.int32)
    kn = jnp.asarray(rng.standard_normal((B, HKV, D), dtype=np.float32))
    kp, _ = ops.paged_append(pool, pool, kn, kn, tbl,
                             jnp.asarray([16, 0, 1], jnp.int32))
    # row 0 is past its 2-page capacity: its write lands on page 0 only
    np.testing.assert_array_equal(np.asarray(kp)[0, :, 0], np.asarray(kn)[0])
    assert np.abs(np.asarray(kp)[1:3]).max() == 0.0


def test_paged_append_quant_scales_per_token(rng):
    page = 8
    kp = jnp.zeros((4, HKV, page, D), jnp.int8)
    sp = jnp.zeros((4, HKV, page, 1), jnp.float32)
    tbl = jnp.asarray([[1, 2], [3, 1], [2, 3]], jnp.int32)
    kn = rng.standard_normal((B, 3, HKV, D), dtype=np.float32)
    lens = jnp.asarray([6, 0, 3], jnp.int32)
    kp, sp, _, _ = ops.paged_append_chunk_quant(
        kp, sp, kp, sp, jnp.asarray(kn), jnp.asarray(kn), tbl, lens)
    deq = np.asarray(ops.gather_pages(kp.astype(jnp.float32) * sp, tbl))
    for i in range(B):
        got = deq[i, :, int(lens[i]):int(lens[i]) + 3]
        assert_rel_l2(got, kn[i].transpose(1, 0, 2), 1e-2)
