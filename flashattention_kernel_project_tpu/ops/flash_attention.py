"""Fused FlashAttention forward and backward for Hopper, Pallas through Triton.

Reference lineage (SURVEY.md sections 2.1/2.4/2.5): QK^T tiled
(qk_tiled_5_1_1.cu:28-101) + online softmax with O-rescale
(flashattn_forward_fused_5_4_2.cu:150-204) + tensor-core PV with f32
accumulation (flashattn_forward_wmma_v5_cp_async.cu:394-443), with K/V
tiles pipelined into shared memory (ibid:221-251).

Design:
  * one program owns a q tile of one (batch, q-head) and loops over the KV
    tiles it can see; the (m, l, acc) carry lives in registers for the whole
    loop, and Triton's `num_stages` pipelines the K/V loads (the reference's
    cp.async double buffer);
  * GQA is index arithmetic: q-head h reads KV head h // group;
  * causal, per-row `q_offset`, per-row KV length, sliding window and
    attention sinks are masks built from positions, and the loop bounds skip
    every KV tile a tile of rows cannot see (sink tiles, then the band);
  * an 8-bit K/V cache (int8 or fp8 e4m3) is dequantised after the load: K's
    per-token scale multiplies the score columns, V's folds into the
    probabilities, so both products stay plain tensor-core dots;
  * softmax runs in the log2 domain (exp2); the emitted logsumexp is
    natural-log, the carry `parallel/ring_attention.py` merges.

The backward is two kernels (FlashAttention-2 recompute from the saved
logsumexp): KV-stationary dk/dv looping over the GQA group's q tiles, and
Q-stationary dq looping over KV tiles. Programs run in no order on the
card, so nothing is summed across programs.

On the GPU, `flash_attention` routes the calls cuDNN's fused attention
covers (16-bit causal or full attention from position 0, optionally with a
sliding window, no sinks, no logsumexp, no 8-bit cache) to that library
kernel through `jax.nn.dot_product_attention`; see `select_impl`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from flashattention_kernel_project_tpu.utils.platform import resolve_interpret

_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
# finite mask value: keeps exp2(m_old - m_new) well-defined for rows whose
# visible keys have not been reached yet
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


def _precision(dtype):
    """f32 operands get full-precision products (no TF32); 16-bit and
    dequantised 8-bit operands take the tensor cores' native path."""
    return (
        lax.Precision.HIGHEST
        if jnp.dtype(dtype) == jnp.float32
        else lax.Precision.DEFAULT
    )


def _dot(a, b, trans_a=False, trans_b=False):
    return pl.dot(a, b, trans_a=trans_a, trans_b=trans_b,
                  precision=_precision(a.dtype))


def _pow2(n: int, lo: int = 16) -> int:
    return max(lo, 1 << max(int(n) - 1, 0).bit_length())


def default_blocks(n: int, s: int, d: int) -> tuple[int, int]:
    """Tile sizes: 64 x 64, chosen on the card at d=128 (PERF.md), cut to
    the padded lengths so tiny calls do not launch mostly-empty tiles."""
    return min(64, _pow2(n)), min(64, _pow2(s))


# 4 warps and 3 pipeline stages: the fastest measured forward at d=128;
# 128-row tiles with 3 stages exceed a block's shared memory
_COMPILER_PARAMS = plgpu.CompilerParams(num_warps=4, num_stages=3)


# ---------------------------------------------------------------------------
# Visibility: masks and the KV-tile range of a tile of rows
# ---------------------------------------------------------------------------

def _visible(rows, cols, kv_len, *, causal, window, sinks):
    """[rows, cols] mask: key position `cols` is visible to query position
    `rows` (positions already include the row's q offset)."""
    mask = cols[None, :] < kv_len
    if causal:
        mask = mask & (cols[None, :] <= rows[:, None])
    if window is not None:
        band = cols[None, :] > rows[:, None] - window
        if sinks:
            band = band | (cols[None, :] < sinks)
        mask = mask & band
    return mask


def _kv_ranges(p_lo, p_hi, kv_len, block_k, *, causal, window, sinks):
    """KV tile ranges visible to row positions [p_lo, p_hi]: a sink range
    [0, sink_hi) and a band range [band_lo, hi), disjoint."""
    end = jnp.minimum(p_hi + 1, kv_len) if causal else kv_len
    end = jnp.maximum(end, 0)
    hi = lax.div(end + block_k - 1, block_k)
    if window is None:
        return 0, 0, 0, hi
    band_lo = lax.div(jnp.maximum(p_lo - window + 1, 0), block_k)
    if not sinks:
        return 0, 0, band_lo, hi
    sink_hi = jnp.minimum((sinks + block_k - 1) // block_k, hi)
    return 0, sink_hi, jnp.maximum(band_lo, sink_hi), hi


# ---------------------------------------------------------------------------
# Forward kernel
# ---------------------------------------------------------------------------

def _fwd_kernel(
    len_ref, off_ref, q_ref, k_ref, v_ref, *refs,
    quant, causal, window, sinks, scale, block_q, block_k,
):
    if quant:
        ks_ref, vs_ref, o_ref, lse_ref = refs
    else:
        o_ref, lse_ref = refs
    i = pl.program_id(0)
    kv_len = len_ref[0]
    rows = i * block_q + lax.broadcasted_iota(jnp.int32, (block_q,), 0)
    rows = rows + off_ref[0]
    q = q_ref[...]
    d_v = o_ref.shape[-1]

    def body(j, carry):
        acc, m, l = carry
        sl = pl.ds(j * block_k, block_k)
        k = k_ref[sl, :]
        if quant:
            k = k.astype(q.dtype)
        s = _dot(q, k, trans_b=True)
        if quant:
            s = s * ks_ref[sl][None, :]
        s = s * scale
        cols = j * block_k + lax.broadcasted_iota(jnp.int32, (block_k,), 0)
        mask = _visible(rows, cols, kv_len, causal=causal, window=window,
                        sinks=sinks)
        s = jnp.where(mask, s, MASK_VALUE)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        alpha = jnp.exp2(m - m_new)
        p = jnp.exp2(s - m_new[:, None])
        l = l * alpha + jnp.sum(p, axis=1)
        v = v_ref[sl, :]
        if quant:
            p = p * vs_ref[sl][None, :]
            v = v.astype(q.dtype)
        acc = acc * alpha[:, None] + _dot(p.astype(v.dtype), v)
        return acc, m_new, l

    p_lo = i * block_q + off_ref[0]
    lo0, hi0, lo1, hi1 = _kv_ranges(
        p_lo, p_lo + block_q - 1, kv_len, block_k, causal=causal, window=window,
        sinks=sinks,
    )
    carry = (
        jnp.zeros((block_q, d_v), jnp.float32),
        jnp.full((block_q,), MASK_VALUE, jnp.float32),
        jnp.zeros((block_q,), jnp.float32),
    )
    if sinks and window is not None:
        carry = lax.fori_loop(lo0, hi0, body, carry)
    acc, m, l = lax.fori_loop(lo1, hi1, body, carry)
    empty = l == 0.0  # rows that see no key: output 0, lse -1e30
    o_ref[...] = (acc / jnp.where(empty, 1.0, l)[:, None]).astype(o_ref.dtype)
    lse_ref[...] = jnp.where(empty, -1e30, (m + jnp.log2(l)) * _LN2)


def _pad_axis(x, axis, to):
    pad = to - x.shape[axis]
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths)


def _round_up(n, m):
    return -(-n // m) * m


def _prep(q, k, v, block_q, block_k):
    """Pad lengths to tile multiples and head dims to powers of two. Tiles
    are `default_blocks` unless a test of the tiling passes its own."""
    b, hq, n, d = q.shape
    s = k.shape[2]
    d_v = v.shape[-1]
    bq0, bk0 = default_blocks(n, s, d)
    block_q = block_q or bq0
    block_k = block_k or bk0
    dp, dvp = _pow2(d), _pow2(d_v)
    q = _pad_axis(_pad_axis(q, 2, _round_up(n, block_q)), 3, dp)
    k = _pad_axis(_pad_axis(k, 2, _round_up(s, block_k)), 3, dp)
    v = _pad_axis(_pad_axis(v, 2, _round_up(s, block_k)), 3, dvp)
    return q, k, v, block_q, block_k


def _fwd(
    q, k, v, kv_lens, q_offsets, *, causal, sm_scale, interpret,
    window=None, sinks=0, k_scale=None, v_scale=None, block_q=None,
    block_k=None,
):
    """Padded-call forward -> (out [B, Hq, N, Dv], lse [B, Hq, N] natural)."""
    if window is not None and not (causal and window >= 1):
        raise ValueError(f"window={window} needs causal=True and window >= 1")
    if sinks and window is None:
        raise ValueError("sinks need a window")
    interpret = resolve_interpret(interpret)
    b, hq, n, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    d_v = v.shape[-1]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    group = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    quant = k_scale is not None
    q, k, v, block_q, block_k = _prep(q, k, v, block_q, block_k)
    np_, sp = q.shape[2], k.shape[2]
    kernel = functools.partial(
        _fwd_kernel, quant=quant, causal=causal, window=window, sinks=sinks,
        scale=float(sm_scale) * _LOG2E, block_q=block_q, block_k=block_k,
    )
    row = lambda i, h, bb: (bb,)  # noqa: E731
    kv = lambda i, h, bb: (bb, h // group, 0, 0)  # noqa: E731
    in_specs = [
        pl.BlockSpec((1,), row),
        pl.BlockSpec((1,), row),
        pl.BlockSpec((None, None, block_q, q.shape[3]),
                     lambda i, h, bb: (bb, h, i, 0)),
        pl.BlockSpec((None, None, sp, k.shape[3]), kv),
        pl.BlockSpec((None, None, sp, v.shape[3]), kv),
    ]
    operands = [
        kv_lens.astype(jnp.int32).reshape(b),
        q_offsets.astype(jnp.int32).reshape(b),
        q, k, v,
    ]
    if quant:
        sc = lambda i, h, bb: (bb, h // group, 0)  # noqa: E731
        in_specs += [pl.BlockSpec((None, None, sp), sc)] * 2
        operands += [
            _pad_axis(x.reshape(b, hkv, s).astype(jnp.float32), 2, sp)
            for x in (k_scale, v_scale)
        ]
    out, lse = pl.pallas_call(
        kernel,
        grid=(np_ // block_q, hq, b),
        in_specs=in_specs,
        out_specs=[
            pl.BlockSpec((None, None, block_q, v.shape[3]),
                         lambda i, h, bb: (bb, h, i, 0)),
            pl.BlockSpec((None, None, block_q), lambda i, h, bb: (bb, h, i)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((b, hq, np_, v.shape[3]), q.dtype),
            jax.ShapeDtypeStruct((b, hq, np_), jnp.float32),
        ],
        compiler_params=_COMPILER_PARAMS,
        backend="triton",
        interpret=interpret,
        name="flash_fwd",
    )(*operands)
    return out[:, :, :n, :d_v], lse[:, :, :n]


# ---------------------------------------------------------------------------
# Backward kernels
# ---------------------------------------------------------------------------

def _bwd_dkdv_kernel(
    len_ref, off_ref, q_ref, do_ref, lse_ref, delta_ref, k_ref, v_ref,
    dk_ref, dv_ref,
    *, causal, window, sinks, scale, sm_scale, block_q, block_k, q_len,
    group,
):
    j = pl.program_id(0)
    kv_len = len_ref[0]
    off = off_ref[0]
    sl = pl.ds(j * block_k, block_k)
    k = k_ref[sl, :]
    v = v_ref[sl, :]
    cols = j * block_k + lax.broadcasted_iota(jnp.int32, (block_k,), 0)
    n_q = q_ref.shape[1] // block_q
    k0 = j * block_k

    # q tiles whose rows can see this KV tile
    if causal:
        lo = lax.div(jnp.maximum(k0 - off, 0), block_q)
    else:
        lo = 0
    hi = n_q
    if window is not None:
        last_row = k0 + block_k - 1 + window - 1 - off
        band_hi = jnp.minimum(lax.div(jnp.maximum(last_row, -1) + block_q,
                                      block_q), n_q)
        hi = jnp.where(k0 < sinks, n_q, band_hi) if sinks else band_hi
    # explicit int32 operands: `jnp.where` of two Python ints lowers to an
    # i1 loop bound in Triton, which its verifier refuses
    hi = lax.select(k0 < kv_len, jnp.int32(hi), jnp.int32(lo))

    def q_body(t, carry, g):
        dk, dv = carry
        qs = pl.ds(t * block_q, block_q)
        q = q_ref[g, qs, :]
        do = do_ref[g, qs, :]
        lse2 = lse_ref[g, qs]
        delta = delta_ref[g, qs]
        rows = t * block_q + lax.broadcasted_iota(jnp.int32, (block_q,), 0)
        mask = _visible(rows + off, cols, kv_len, causal=causal,
                        window=window, sinks=sinks)
        mask = mask & (rows < q_len)[:, None]
        s = _dot(q, k, trans_b=True) * scale
        p = jnp.where(mask, jnp.exp2(s - lse2[:, None]), 0.0)
        dv = dv + _dot(p.astype(do.dtype), do, trans_a=True)
        dp = _dot(do, v, trans_b=True)
        ds = p * (dp - delta[:, None])
        dk = dk + _dot(ds.astype(q.dtype), q, trans_a=True)
        return dk, dv

    carry = (
        jnp.zeros((block_k, k.shape[-1]), jnp.float32),
        jnp.zeros((block_k, v.shape[-1]), jnp.float32),
    )
    for g in range(group):
        carry = lax.fori_loop(lo, hi, functools.partial(q_body, g=g), carry)
    dk, dv = carry
    dk_ref[...] = (dk * sm_scale).astype(dk_ref.dtype)
    dv_ref[...] = dv.astype(dv_ref.dtype)


def _bwd_dq_kernel(
    len_ref, off_ref, q_ref, do_ref, lse_ref, delta_ref, k_ref, v_ref,
    dq_ref,
    *, causal, window, sinks, scale, sm_scale, block_q, block_k, q_len,
):
    i = pl.program_id(0)
    kv_len = len_ref[0]
    rows = i * block_q + lax.broadcasted_iota(jnp.int32, (block_q,), 0)
    row_ok = (rows < q_len)[:, None]
    p_lo = i * block_q + off_ref[0]
    pos = rows + off_ref[0]
    q = q_ref[...]
    do = do_ref[...]
    lse2 = lse_ref[...]
    delta = delta_ref[...]

    def body(j, dq):
        sl = pl.ds(j * block_k, block_k)
        k = k_ref[sl, :]
        v = v_ref[sl, :]
        cols = j * block_k + lax.broadcasted_iota(jnp.int32, (block_k,), 0)
        mask = _visible(pos, cols, kv_len, causal=causal, window=window,
                        sinks=sinks) & row_ok
        s = _dot(q, k, trans_b=True) * scale
        p = jnp.where(mask, jnp.exp2(s - lse2[:, None]), 0.0)
        dp = _dot(do, v, trans_b=True)
        ds = p * (dp - delta[:, None])
        return dq + _dot(ds.astype(k.dtype), k)

    lo0, hi0, lo1, hi1 = _kv_ranges(
        p_lo, p_lo + block_q - 1, kv_len, block_k, causal=causal,
        window=window, sinks=sinks,
    )
    dq = jnp.zeros((block_q, q.shape[-1]), jnp.float32)
    if sinks and window is not None:
        dq = lax.fori_loop(lo0, hi0, body, dq)
    dq = lax.fori_loop(lo1, hi1, body, dq)
    dq_ref[...] = (dq * sm_scale).astype(dq_ref.dtype)


def _bwd(res, g, *, causal, sm_scale, q_offset, interpret, window, sinks,
         block_q=None, block_k=None):
    q, k, v, out, lse = res
    interpret = resolve_interpret(interpret)
    b, hq, n, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    delta = jnp.sum(out.astype(jnp.float32) * g.astype(jnp.float32), axis=-1)
    lse2 = lse * _LOG2E
    qp, kp, vp, block_q, block_k = _prep(q, k, v, block_q, block_k)
    np_, sp, dp = qp.shape[2], kp.shape[2], qp.shape[3]
    gp = _pad_axis(_pad_axis(g.astype(q.dtype), 2, np_), 3, vp.shape[3])
    lse2 = _pad_axis(lse2, 2, np_)
    delta = _pad_axis(delta, 2, np_)
    lens = jnp.full((b,), s, jnp.int32)
    offs = jnp.full((b,), q_offset, jnp.int32)
    common = dict(
        causal=causal, window=window, sinks=sinks,
        scale=float(sm_scale) * _LOG2E, sm_scale=float(sm_scale),
        block_q=block_q, block_k=block_k, q_len=n,
    )
    row = lambda *a: (a[-1],)  # noqa: E731

    # dk/dv: one program per (KV tile, KV head, batch); the GQA group's q
    # heads are one leading axis of the q-side operands
    qg = lambda j, h, bb: (bb, h, 0, 0, 0)  # noqa: E731
    sg = lambda j, h, bb: (bb, h, 0, 0)  # noqa: E731
    kvt = lambda j, h, bb: (bb, h, j, 0)  # noqa: E731
    kvf = lambda j, h, bb: (bb, h, 0, 0)  # noqa: E731
    dk, dv = pl.pallas_call(
        functools.partial(_bwd_dkdv_kernel, group=group, **common),
        grid=(sp // block_k, hkv, b),
        in_specs=[
            pl.BlockSpec((1,), row),
            pl.BlockSpec((1,), row),
            pl.BlockSpec((None, None, group, np_, dp), qg),
            pl.BlockSpec((None, None, group, np_, gp.shape[3]), qg),
            pl.BlockSpec((None, None, group, np_), sg),
            pl.BlockSpec((None, None, group, np_), sg),
            pl.BlockSpec((None, None, sp, dp), kvf),
            pl.BlockSpec((None, None, sp, vp.shape[3]), kvf),
        ],
        out_specs=[
            pl.BlockSpec((None, None, block_k, dp), kvt),
            pl.BlockSpec((None, None, block_k, vp.shape[3]), kvt),
        ],
        out_shape=[
            jax.ShapeDtypeStruct(kp.shape, k.dtype),
            jax.ShapeDtypeStruct(vp.shape, v.dtype),
        ],
        compiler_params=_COMPILER_PARAMS,
        backend="triton",
        interpret=interpret,
        name="flash_bwd_dkdv",
    )(
        lens, offs,
        qp.reshape(b, hkv, group, np_, dp),
        gp.reshape(b, hkv, group, np_, gp.shape[3]),
        lse2.reshape(b, hkv, group, np_),
        delta.reshape(b, hkv, group, np_),
        kp, vp,
    )

    # dq: one program per (q tile, q head, batch), like the forward
    kv = lambda i, h, bb: (bb, h // group, 0, 0)  # noqa: E731
    qt = lambda i, h, bb: (bb, h, i, 0)  # noqa: E731
    st = lambda i, h, bb: (bb, h, i)  # noqa: E731
    dq = pl.pallas_call(
        functools.partial(_bwd_dq_kernel, **common),
        grid=(np_ // block_q, hq, b),
        in_specs=[
            pl.BlockSpec((1,), row),
            pl.BlockSpec((1,), row),
            pl.BlockSpec((None, None, block_q, dp), qt),
            pl.BlockSpec((None, None, block_q, gp.shape[3]), qt),
            pl.BlockSpec((None, None, block_q), st),
            pl.BlockSpec((None, None, block_q), st),
            pl.BlockSpec((None, None, sp, dp), kv),
            pl.BlockSpec((None, None, sp, vp.shape[3]), kv),
        ],
        out_specs=pl.BlockSpec((None, None, block_q, dp), qt),
        out_shape=jax.ShapeDtypeStruct(qp.shape, q.dtype),
        compiler_params=_COMPILER_PARAMS,
        backend="triton",
        interpret=interpret,
        name="flash_bwd_dq",
    )(lens, offs, qp, gp, lse2, delta, kp, vp)
    return dq[:, :, :n, :d], dk[:, :, :s, :d], dv[:, :, :s, :v.shape[-1]]


# ---------------------------------------------------------------------------
# Differentiable entry point and the choice of implementation
# ---------------------------------------------------------------------------

@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5, 6, 7, 8))
def _flash_attention(q, k, v, causal, sm_scale, q_offset, interpret, window,
                     sinks):
    return _flash_attention_fwd(
        q, k, v, causal, sm_scale, q_offset, interpret, window, sinks,
    )[0]


def _flash_attention_fwd(q, k, v, causal, sm_scale, q_offset, interpret,
                         window, sinks):
    b, s = q.shape[0], k.shape[2]
    out, lse = _fwd(
        q, k, v, jnp.full((b,), s, jnp.int32),
        jnp.full((b,), q_offset, jnp.int32),
        causal=causal, sm_scale=sm_scale, interpret=interpret, window=window,
        sinks=sinks,
    )
    return out, (q, k, v, out, lse)


def _flash_attention_bwd(causal, sm_scale, q_offset, interpret, window, sinks,
                         res, g):
    return _bwd(
        res, g, causal=causal, sm_scale=sm_scale, q_offset=q_offset,
        interpret=interpret, window=window, sinks=sinks,
    )


_flash_attention.defvjp(_flash_attention_fwd, _flash_attention_bwd)


def select_impl(
    q_dtype, n: int, s: int, d: int, *, causal: bool, q_offset: int,
    window: int | None, sinks: int, interpret, platform: str,
) -> str:
    """Which implementation `flash_attention` runs by default: "cudnn" or
    "pallas".

    cuDNN's fused attention (a library kernel, through
    `jax.nn.dot_product_attention`) takes the calls it covers on a GPU:
    16-bit inputs, full or causal attention from position 0 over equal
    lengths, an optional sliding window, no sinks, head dim a multiple of 8
    up to 128. Everything else (an offset chunk, sinks, f32 or interpret
    mode) runs the Pallas kernel.
    """
    if platform != "gpu" or interpret:
        return "pallas"
    if jnp.dtype(q_dtype) not in (jnp.dtype(jnp.bfloat16),
                                  jnp.dtype(jnp.float16)):
        return "pallas"
    if q_offset or sinks or d % 8 or d > 128:
        return "pallas"
    if causal and n != s:
        return "pallas"
    return "cudnn"


def _cudnn_attention(q, k, v, *, causal, sm_scale, window):
    """cuDNN fused attention on [B, H, N, D] operands (it takes [B, N, H, D])."""
    t = lambda x: jnp.swapaxes(x, 1, 2)  # noqa: E731
    out = jax.nn.dot_product_attention(
        t(q), t(k), t(v), scale=sm_scale, is_causal=causal,
        local_window_size=None if window is None else (window - 1, 0),
        implementation="cudnn",
    )
    return t(out)


def flash_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    q_offset: int = 0,
    interpret: bool | None = None,
    window: int | None = None,
    sinks: int = 0,
    implementation: str | None = None,
) -> jax.Array:
    """Fused multi-head / grouped-query attention; differentiable.

    Args:
      q: [batch, q_heads, q_len, head_dim]
      k, v: [batch, kv_heads, kv_len, head_dim]; q_heads % kv_heads == 0.
      causal: query i sees key j iff j <= i + q_offset.
      q_offset: static position of query 0 within the KV sequence (chunked
        prefill).
      window: sliding window (needs causal): query i attends keys
        j in (i + q_offset - window, i + q_offset]; forward and backward
        skip the tiles outside the band.
      sinks: with `window`, the first `sinks` keys stay visible to every
        query (StreamingLLM attention sinks).
      interpret: run the Pallas kernel in the interpreter (tests).
      implementation: "pallas" or "cudnn"; None lets `select_impl` choose
        from the call's properties.

    Returns [batch, q_heads, q_len, head_dim_v] in q.dtype.
    """
    b, hq, n, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    impl = implementation or select_impl(
        q.dtype, n, k.shape[2], d, causal=causal, q_offset=q_offset,
        window=window, sinks=sinks, interpret=interpret,
        platform=jax.default_backend(),
    )
    if impl == "cudnn":
        return _cudnn_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                                window=window)
    return _flash_attention(
        q, k, v, causal, sm_scale, q_offset, interpret, window, sinks,
    )


def flash_attention_with_lse(
    q, k, v, *, causal=False, sm_scale=None, q_offset=0, interpret=None,
    window=None, sinks=0,
):
    """Forward that also returns logsumexp [b, hq, n] (natural log) — the
    carry the ring/context-parallel layer merges across devices
    (non-differentiable)."""
    b, s = q.shape[0], k.shape[2]
    return _fwd(
        q, k, v, jnp.full((b,), s, jnp.int32),
        jnp.full((b,), q_offset, jnp.int32),
        causal=causal, sm_scale=sm_scale, interpret=interpret, window=window,
        sinks=sinks,
    )


_STATIC = ("causal", "sm_scale", "q_offset", "interpret", "window", "sinks")


@functools.partial(jax.jit, static_argnames=_STATIC)
def flash_attention_kv_quant(
    q, k_q, k_scale, v_q, v_scale, *, causal=False, sm_scale=None,
    q_offset=0, interpret=None, window=None, sinks=0,
):
    """Forward attention against an 8-bit KV cache.

    k_q/v_q: [B, Hkv, S, D] int8 or float8_e4m3fn; k_scale/v_scale:
    [B, Hkv, S, 1] f32 per-token scales (ops.quant.quantize_kv). Dequant
    happens after each tile's load, so the cache crosses device memory in
    8 bits. Forward-only. Returns [B, Hq, N, Dv].
    """
    return flash_attention_kv_quant_with_lse(
        q, k_q, k_scale, v_q, v_scale, causal=causal, sm_scale=sm_scale,
        q_offset=q_offset, interpret=interpret, window=window, sinks=sinks,
    )[0]


def flash_attention_kv_quant_with_lse(
    q, k_q, k_scale, v_q, v_scale, *, causal=False, sm_scale=None,
    q_offset=0, interpret=None, window=None, sinks=0,
):
    """flash_attention_kv_quant that also returns logsumexp [b, hq, n] —
    the merge carry for ring attention over 8-bit KV shards."""
    b, s = q.shape[0], k_q.shape[2]
    return _fwd(
        q, k_q, v_q, jnp.full((b,), s, jnp.int32),
        jnp.full((b,), q_offset, jnp.int32),
        causal=causal, sm_scale=sm_scale, interpret=interpret, window=window,
        sinks=sinks, k_scale=k_scale, v_scale=v_scale,
    )


_RAGGED_STATIC = ("causal", "sm_scale", "interpret", "window", "sinks")


@functools.partial(jax.jit, static_argnames=_RAGGED_STATIC)
def flash_attention_ragged(
    q, k, v, kv_lens, q_offsets, *, causal=True, sm_scale=None,
    interpret=None, window=None, sinks=0,
):
    """Attention with per-row KV lengths and causal query offsets.

    q: [B, Hq, N, D]; k/v: [B, Hkv, S_max, D] (e.g. a padded KV cache);
    kv_lens: [B] valid keys per row; q_offsets: [B] position of query 0
    (query i attends key j iff j <= i + q_offsets[b] and j < kv_lens[b]).
    Forward-only (serving path). Returns [B, Hq, N, Dv].
    """
    return _fwd(
        q, k, v, kv_lens, q_offsets, causal=causal, sm_scale=sm_scale,
        interpret=interpret, window=window, sinks=sinks,
    )[0]


@functools.partial(jax.jit, static_argnames=_RAGGED_STATIC)
def flash_attention_ragged_kv_quant(
    q, k_q, k_scale, v_q, v_scale, kv_lens, q_offsets, *, causal=True,
    sm_scale=None, interpret=None, window=None, sinks=0,
):
    """flash_attention_ragged against an 8-bit KV cache (layout as in
    flash_attention_kv_quant); the chunked-prefill path of a quantized
    cache."""
    return _fwd(
        q, k_q, v_q, kv_lens, q_offsets, causal=causal, sm_scale=sm_scale,
        interpret=interpret, window=window, sinks=sinks, k_scale=k_scale,
        v_scale=v_scale,
    )[0]


# ---------------------------------------------------------------------------
# Plain reference
# ---------------------------------------------------------------------------

def reference_attention(
    q, k, v, *, causal=False, sm_scale=None, q_offsets=None, kv_lens=None,
    window=None, sinks=0, q_chunk=None,
):
    """Plain `jnp` attention in float32 — what XLA makes of the unfused
    expression, and the on-card reference for the kernels.

    q_offsets / kv_lens: optional [B] per-row offsets and lengths (ragged).
    q_chunk: process query rows in chunks of this many, so the [B, H, N, S]
    score tensor of a long call need not fit at once.
    Returns f32 [B, Hq, N, Dv].
    """
    b, hq, n, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    kf = k.astype(jnp.float32)
    vf = v.astype(jnp.float32)
    offs = (jnp.zeros((b,), jnp.int32) if q_offsets is None
            else jnp.asarray(q_offsets, jnp.int32))
    lens = (jnp.full((b,), s, jnp.int32) if kv_lens is None
            else jnp.asarray(kv_lens, jnp.int32))
    cols = jnp.arange(s)

    def rows_out(qc, r0):
        qf = qc.astype(jnp.float32).reshape(b, hkv, group, -1, d)
        sc = jnp.einsum("bhgnd,bhsd->bhgns", qf, kf) * sm_scale
        pos = (r0 + jnp.arange(qc.shape[2]))[None, :] + offs[:, None]
        mask = cols[None, None, :] < lens[:, None, None]
        if causal:
            mask = mask & (cols[None, None, :] <= pos[:, :, None])
        if window is not None:
            band = cols[None, None, :] > pos[:, :, None] - window
            if sinks:
                band = band | (cols[None, None, :] < sinks)
            mask = mask & band
        mask = mask[:, None, None]
        sc = jnp.where(mask, sc, -jnp.inf)
        m = jnp.max(sc, axis=-1, keepdims=True)
        m = jnp.where(jnp.isfinite(m), m, 0.0)
        p = jnp.where(mask, jnp.exp(sc - m), 0.0)
        l = jnp.sum(p, axis=-1, keepdims=True)
        o = jnp.einsum("bhgns,bhsd->bhgnd", p, vf) / jnp.where(l == 0, 1, l)
        return o.reshape(b, hq, -1, vf.shape[-1])

    if q_chunk is None or q_chunk >= n:
        return rows_out(q, 0)
    outs = [rows_out(q[:, :, r:r + q_chunk], r) for r in range(0, n, q_chunk)]
    return jnp.concatenate(outs, axis=2)
