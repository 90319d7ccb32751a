"""The online/streaming softmax state machine.

Reference (SURVEY.md section 2.2): the softmax ladder ends in the *online*
state machine, which this module exposes as reusable pure functions with two
mathematically equivalent disciplines:

  1. rescale-normalized  (flashattn_forward_fused_5_4_2.cu:150-204):
       alpha = exp(m_old - m_new) * l_old / l_new; O *= alpha before adding
  2. unnormalized streaming merge (flashattn_streaming_16x16.cu:15-24):
       m=max; l = la*ea + lb*eb; y = ya*ea + yb*eb; O = y/l at the end

Discipline 2's merge is ASSOCIATIVE — it is the combiner for split-KV
flash-decode and ring/context-parallel attention (property-tested in
tests/test_softmax.py because Phase 5 load-bears on it).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

NEG_INF = float(-1e30)  # finite -inf stand-in; exp() of it flushes to 0 in bf16/fp32


# ---------------------------------------------------------------------------
# Online-softmax state machine (pure functions, used in lax.scan bodies and
# across-device merges alike)
# ---------------------------------------------------------------------------

class SoftmaxState(NamedTuple):
    """Unnormalized streaming softmax partial over some slice of keys.

    m: running row max            [..., rows]
    l: running sum of exp(s - m)  [..., rows]
    y: running exp-weighted V sum [..., rows, d_v]  (UNNORMALIZED)
    """

    m: jax.Array
    l: jax.Array
    y: jax.Array


def init_state(rows_shape: tuple[int, ...], d_v: int, dtype=jnp.float32) -> SoftmaxState:
    return SoftmaxState(
        m=jnp.full(rows_shape, NEG_INF, dtype),
        l=jnp.zeros(rows_shape, dtype),
        y=jnp.zeros((*rows_shape, d_v), dtype),
    )


def tile_state(scores: jax.Array, values: jax.Array) -> SoftmaxState:
    """State of a single tile: scores [..., rows, cols], values [..., cols, d_v].
    Masked-out entries must already be NEG_INF in `scores`."""
    m = jnp.max(scores, axis=-1)
    e = jnp.exp(scores - m[..., None])
    return SoftmaxState(m=m, l=jnp.sum(e, axis=-1), y=e @ values)


def merge(a: SoftmaxState, b: SoftmaxState) -> SoftmaxState:
    """Associative merge (flashattn_streaming_16x16.cu:15-24 discipline).

    Commutative and associative up to fp rounding, so any partition of the
    key axis — KV tiles in a kernel, split-KV shards, ring-attention hops —
    combines with this one function.
    """
    m = jnp.maximum(a.m, b.m)
    ea = jnp.exp(a.m - m)
    eb = jnp.exp(b.m - m)
    return SoftmaxState(
        m=m,
        l=a.l * ea + b.l * eb,
        y=a.y * ea[..., None] + b.y * eb[..., None],
    )


def finalize(state: SoftmaxState, eps: float = 0.0) -> jax.Array:
    """O = y / l — the single final normalize (streaming discipline)."""
    return state.y / (state.l + eps)[..., None]


# ---------------------------------------------------------------------------
# Online softmax over column blocks as an executable spec (the streaming
# microkernel in isolation — reference section 2.6's (m,l) loop without the
# attention around it). A correctness anchor for the fused kernel.
# ---------------------------------------------------------------------------

def online_softmax_reference(x: jax.Array, block_cols: int = 512) -> jax.Array:
    """Two-discipline online softmax in pure lax.scan form (jnp, not Pallas):
    the executable spec the fused attention kernel is tested against."""
    n = x.shape[-1]
    pad = (-n) % block_cols
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)], constant_values=NEG_INF)
    n_blocks = xp.shape[-1] // block_cols
    tiles = jnp.moveaxis(
        xp.reshape(*xp.shape[:-1], n_blocks, block_cols), -2, 0
    )  # [n_blocks, ..., block_cols]

    def step(carry, tile):
        m, l = carry
        m_tile = jnp.max(tile, axis=-1)
        m_new = jnp.maximum(m, m_tile)
        l_new = l * jnp.exp(m - m_new) + jnp.sum(jnp.exp(tile - m_new[..., None]), axis=-1)
        return (m_new, l_new), None

    m0 = jnp.full(xp.shape[:-1], NEG_INF, jnp.float32)
    l0 = jnp.zeros(xp.shape[:-1], jnp.float32)
    (m, l), _ = jax.lax.scan(step, (m0, l0), tiles.astype(jnp.float32))
    out = jnp.exp(x.astype(jnp.float32) - m[..., None]) / l[..., None]
    return out.astype(x.dtype)
