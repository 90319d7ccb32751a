"""Split-KV flash decode ("flash decoding") over a linear or paged KV cache.

The reference's streaming kernels are exactly this decode shape: a small
fixed Q block with K/V streamed over the sequence in tiles, accumulated with
the unnormalized (m, l, y) streaming merge
(Streaming_FlashAttention_Forward_Kernel/flashattn_streaming_16x16.cu:15-24,
239-262).

Design (Pallas through Triton): one new token per sequence; the GQA group's
q rows for one KV head form one q tile (padded to the 16 rows a tensor-core
product needs). Each program owns one (split, KV head, sequence) and loops
over the KV tiles of its split that the row can see, stopping at the row's
length, so a padded cache costs only its live tokens. Splits emit
unnormalized (m, l, y) partials that one `jnp` reduction merges
(`merge_partials`); the same merge combines partials across devices
(parallel/ring attention and sequence-sharded decode).

An 8-bit cache (int8 or fp8 e4m3, per-token scales) is dequantised after
each tile's load: K's scale multiplies the score columns, V's folds into the
probabilities. A paged cache is the same loop with each tile gathered from
the pages its block table names.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from flashattention_kernel_project_tpu.ops.flash_attention import (
    MASK_VALUE,
    _LN2,
    _LOG2E,
    _dot,
    _pad_axis,
    _pow2,
    _round_up,
)
from flashattention_kernel_project_tpu.utils.platform import resolve_interpret

# tokens per split: enough programs to fill the card at serving batch sizes
# while each program still streams several tiles (chosen on the card with
# the tile rows, warps and stages below; PERF.md)
_SPLIT_TOKENS = 512
_BLOCK_K = 64  # KV tile rows (paged: pages gathered per tile to reach it)
_NUM_WARPS = 4
_NUM_STAGES = 3


def _decode_kernel(
    len_ref, q_ref, k_ref, v_ref, *refs,
    quant, paged, window, sinks, scale, block_k, split_len, pages_per_tile,
):
    if paged:
        tbl_ref, *refs = refs
    if quant:
        ks_ref, vs_ref, m_ref, l_ref, y_ref = refs
    else:
        m_ref, l_ref, y_ref = refs
    split = pl.program_id(0)
    length = len_ref[0]
    q = q_ref[...]
    gp = q.shape[0]

    def load(ref, j, is_scale=False):
        if not paged:
            sl = pl.ds(j * block_k, block_k)
            return ref[sl] if is_scale else ref[sl, :]
        pids = tbl_ref[pl.ds(j * pages_per_tile, pages_per_tile)]
        x = ref[pids]
        return x.reshape((block_k,) + x.shape[2:])

    def body(j, carry):
        acc, m, l = carry
        k = load(k_ref, j)
        if quant:
            k = k.astype(q.dtype)
        s = _dot(q, k, trans_b=True)
        if quant:
            s = s * load(ks_ref, j, True)[None, :]
        s = s * scale
        cols = j * block_k + lax.broadcasted_iota(jnp.int32, (block_k,), 0)
        ok = cols < length
        if window is not None:
            band = cols >= length - window
            if sinks:
                band = band | (cols < sinks)
            ok = ok & band
        s = jnp.where(ok[None, :], s, MASK_VALUE)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        alpha = jnp.exp2(m - m_new)
        p = jnp.exp2(s - m_new[:, None])
        l = l * alpha + jnp.sum(p, axis=1)
        v = load(v_ref, j)
        if quant:
            p = p * load(vs_ref, j, True)[None, :]
            v = v.astype(q.dtype)
        acc = acc * alpha[:, None] + _dot(p.astype(v.dtype), v)
        return acc, m_new, l

    # this split's tiles, cut to the row's visible keys: the sink tiles,
    # then the window band up to the row's length
    t0 = split * (split_len // block_k)
    t1 = t0 + split_len // block_k
    hi = jnp.minimum(lax.div(length + block_k - 1, block_k), t1)
    carry = (
        jnp.zeros((gp, y_ref.shape[-1]), jnp.float32),
        jnp.full((gp,), MASK_VALUE, jnp.float32),
        jnp.zeros((gp,), jnp.float32),
    )
    lo = t0
    if window is not None:
        band_lo = lax.div(jnp.maximum(length - window, 0), block_k)
        if sinks:
            sink_hi = jnp.minimum((sinks + block_k - 1) // block_k, hi)
            carry = lax.fori_loop(t0, sink_hi, body, carry)
            band_lo = jnp.maximum(band_lo, sink_hi)
        lo = jnp.maximum(band_lo, t0)
    acc, m, l = lax.fori_loop(lo, hi, body, carry)
    m_ref[...] = m
    l_ref[...] = l
    y_ref[...] = acc


def _decode_partials(
    q, k, v, lengths, *, k_scale=None, v_scale=None, block_table=None,
    n_splits=None, sm_scale=None, interpret=None, window=None, sinks=0,
):
    """Per-split partials: m, l [B, Hkv, n_splits, G] (m natural-log) and
    y [B, Hkv, n_splits, G, Dv]."""
    interpret = resolve_interpret(interpret)
    b, hq, d = q.shape
    paged = block_table is not None
    quant = k_scale is not None
    if paged:
        n_pages, hkv, page, _ = k.shape
        if page & (page - 1):
            raise ValueError(f"page size {page} must be a power of two")
        max_pages = block_table.shape[1]
        pages_per_tile = max(1, _BLOCK_K // page)
        block_k = page * pages_per_tile
        s_cap = max_pages * page
    else:
        hkv, s_cap = k.shape[1], k.shape[2]
        pages_per_tile = 1
        block_k = min(_BLOCK_K, _pow2(s_cap))
    d_v = v.shape[-1]
    g = hq // hkv
    gp = _pow2(g)
    dp, dvp = _pow2(d), _pow2(d_v)
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    if n_splits is None:
        n_splits = max(1, -(-s_cap // _SPLIT_TOKENS))
    # each split a whole number of tiles
    split_len = -(-s_cap // (n_splits * block_k)) * block_k
    n_splits = -(-s_cap // split_len)
    s_pad = split_len * n_splits

    qg = _pad_axis(_pad_axis(q.reshape(b, hkv, g, d), 2, gp), 3, dp)
    kernel = functools.partial(
        _decode_kernel, quant=quant, paged=paged, window=window, sinks=sinks,
        scale=float(sm_scale) * _LOG2E, block_k=block_k, split_len=split_len,
        pages_per_tile=pages_per_tile,
    )
    row = lambda sp, h, bb: (bb,)  # noqa: E731
    in_specs = [
        pl.BlockSpec((1,), row),
        pl.BlockSpec((None, None, gp, dp), lambda sp, h, bb: (bb, h, 0, 0)),
    ]
    operands = [lengths.astype(jnp.int32).reshape(b), qg]
    if paged:
        k = _pad_axis(k, 3, dp)
        v = _pad_axis(v, 3, dvp)
        pool = lambda sp, h, bb: (0, h, 0, 0)  # noqa: E731
        in_specs += [
            pl.BlockSpec((n_pages, None, page, dp), pool),
            pl.BlockSpec((n_pages, None, page, dvp), pool),
            pl.BlockSpec((None, s_pad // page), lambda sp, h, bb: (bb, 0)),
        ]
        operands += [
            k, v, _pad_axis(block_table.astype(jnp.int32), 1, s_pad // page),
        ]
        if quant:
            spool = lambda sp, h, bb: (0, h, 0)  # noqa: E731
            in_specs += [pl.BlockSpec((n_pages, None, page), spool)] * 2
            operands += [
                x.reshape(n_pages, hkv, page).astype(jnp.float32)
                for x in (k_scale, v_scale)
            ]
    else:
        # pad only to whole tiles (a cache of whole tiles is not copied):
        # no program reads a tile past its row's length
        s_t = _round_up(s_cap, block_k)
        k = _pad_axis(_pad_axis(k, 2, s_t), 3, dp)
        v = _pad_axis(_pad_axis(v, 2, s_t), 3, dvp)
        kv = lambda sp, h, bb: (bb, h, 0, 0)  # noqa: E731
        in_specs += [
            pl.BlockSpec((None, None, s_t, dp), kv),
            pl.BlockSpec((None, None, s_t, dvp), kv),
        ]
        operands += [k, v]
        if quant:
            sc = lambda sp, h, bb: (bb, h, 0)  # noqa: E731
            in_specs += [pl.BlockSpec((None, None, s_t), sc)] * 2
            operands += [
                _pad_axis(x.reshape(b, hkv, s_cap).astype(jnp.float32), 2, s_t)
                for x in (k_scale, v_scale)
            ]
    out_map = lambda sp, h, bb: (bb, h, sp, 0)  # noqa: E731
    m, l, y = pl.pallas_call(
        kernel,
        grid=(n_splits, hkv, b),
        in_specs=in_specs,
        out_specs=[
            pl.BlockSpec((None, None, None, gp), out_map),
            pl.BlockSpec((None, None, None, gp), out_map),
            pl.BlockSpec((None, None, None, gp, dvp),
                         lambda sp, h, bb: (bb, h, sp, 0, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((b, hkv, n_splits, gp), jnp.float32),
            jax.ShapeDtypeStruct((b, hkv, n_splits, gp), jnp.float32),
            jax.ShapeDtypeStruct((b, hkv, n_splits, gp, dvp), jnp.float32),
        ],
        compiler_params=plgpu.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES
        ),
        backend="triton",
        interpret=interpret,
        name="paged_decode" if paged else "flash_decode",
    )(*operands)
    return m[..., :g] * _LN2, l[..., :g], y[..., :g, :d_v]


def fold_partials(m, l, y):
    """Fold partials along axis -3 but keep the state unnormalized.

    m, l: [..., n, G, 1]; y: [..., n, G, D] -> ([..., G, 1], [..., G, 1],
    [..., G, D]). Associative and commutative (the streaming algebra), so
    splits of one device and shards of several combine the same way."""
    m_g = jnp.max(m, axis=-3, keepdims=True)
    alpha = jnp.exp(m - m_g)
    return m_g[..., 0, :, :], jnp.sum(l * alpha, axis=-3), jnp.sum(
        y * alpha, axis=-3
    )


def merge_partials(m, l, y):
    """Combine partials along axis -3 and normalize: [..., G, D]."""
    _, l_g, y_g = fold_partials(m, l, y)
    return y_g / jnp.where(l_g == 0.0, 1.0, l_g)


def _finish(q, m, l, y, return_partials):
    m, l = m[..., None], l[..., None]
    if return_partials:
        return fold_partials(m, l, y)
    b, hq, _ = q.shape
    return merge_partials(m, l, y).reshape(b, hq, -1).astype(q.dtype)


_STATIC = ("n_splits", "sm_scale", "interpret", "return_partials", "window",
           "sinks")


@functools.partial(jax.jit, static_argnames=_STATIC)
def flash_decode(
    q: jax.Array,
    k_cache: jax.Array,
    v_cache: jax.Array,
    lengths: jax.Array,
    *,
    n_splits: int | None = None,
    sm_scale: float | None = None,
    interpret: bool | None = None,
    return_partials: bool = False,
    window: int | None = None,
    sinks: int = 0,
) -> jax.Array:
    """Single-token GQA decode against a (padded) linear KV cache.

    Args:
      q: [B, Hq, D] — one new token per sequence.
      k_cache, v_cache: [B, Hkv, S_max, D].
      lengths: [B] int32 — valid tokens per sequence (the query sits at
        position lengths-1 and attends keys [0, lengths)).
      n_splits: KV splits per sequence (None: one per `_SPLIT_TOKENS`
        cache tokens).
      window: attend only the `window` most recent keys; with `sinks`, the
        first `sinks` keys stay visible too.
      return_partials: return the folded unnormalized state (m, l, y) with
        shapes [B, Hkv, G, 1] / [B, Hkv, G, 1] / [B, Hkv, G, D] — the
        cross-device combiner state for sequence-sharded decode.

    Returns [B, Hq, D] in q.dtype.
    """
    m, l, y = _decode_partials(
        q, k_cache, v_cache, lengths, n_splits=n_splits, sm_scale=sm_scale,
        interpret=interpret, window=window, sinks=sinks,
    )
    return _finish(q, m, l, y, return_partials)


@functools.partial(jax.jit, static_argnames=_STATIC)
def flash_decode_int8(
    q: jax.Array,
    k_q: jax.Array,
    k_scale: jax.Array,
    v_q: jax.Array,
    v_scale: jax.Array,
    lengths: jax.Array,
    *,
    n_splits: int | None = None,
    sm_scale: float | None = None,
    interpret: bool | None = None,
    return_partials: bool = False,
    window: int | None = None,
    sinks: int = 0,
) -> jax.Array:
    """flash_decode against an 8-bit KV cache.

    k_q/v_q: [B, Hkv, S_max, D] int8 or float8_e4m3fn; k_scale/v_scale:
    [B, Hkv, S_max, 1] f32 per-token scales. `flash_decode_fp8` is the
    fp8-named alias.
    """
    m, l, y = _decode_partials(
        q, k_q, v_q, lengths, k_scale=k_scale, v_scale=v_scale,
        n_splits=n_splits, sm_scale=sm_scale, interpret=interpret,
        window=window, sinks=sinks,
    )
    return _finish(q, m, l, y, return_partials)


# fp8_e4m3 KV shares the 8-bit kernel: both are 8 bits per value with
# per-token f32 scales, and the dequant is a cast either way.
flash_decode_fp8 = flash_decode_int8
