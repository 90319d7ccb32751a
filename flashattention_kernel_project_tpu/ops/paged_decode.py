"""Paged KV cache: decode, extend and appends over a block-table page pool.

The linear cache (ops/flash_decode.py) wastes memory on padded tails and
fragments under continuous batching; the production fix is vLLM-style
paging: KV lives in fixed-size pages owned by a pool, and each sequence
holds a block table of page ids.

Pool layout: pages [n_pages, Hkv, page_size, D]; an 8-bit pool keeps
per-token scales [n_pages, Hkv, page_size, 1] f32 beside it (the linear
cache's scale layout, page by page). Page 0 is the junk page that padding
table entries point at.

  * decode: the split-KV decode kernel of ops/flash_decode.py, each tile
    gathered from the pages the block table names (pages are never copied);
  * extend (chunked prefill, speculative verify): gather the sequence's
    pages into a contiguous view and run the ragged fused forward — a
    chunk's compute outweighs the gather;
  * appends: XLA scatters into the (donated) pool buffers, updated in place.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from flashattention_kernel_project_tpu.ops.flash_attention import (
    flash_attention_ragged,
    flash_attention_ragged_kv_quant,
)
from flashattention_kernel_project_tpu.ops.flash_decode import (
    _decode_partials,
    _finish,
)
from flashattention_kernel_project_tpu.ops.quant import (
    quantize_fp8_tokenwise,
    quantize_int8,
)


@functools.partial(jax.jit, static_argnames=("sm_scale", "interpret"))
def paged_flash_decode(
    q: jax.Array,
    k_pages: jax.Array,
    v_pages: jax.Array,
    block_table: jax.Array,
    lengths: jax.Array,
    *,
    sm_scale: float | None = None,
    interpret: bool | None = None,
) -> jax.Array:
    """Single-token GQA decode against a paged KV cache.

    Args:
      q: [B, Hq, D] — one new token per sequence.
      k_pages, v_pages: [n_pages, Hkv, page_size, D] — the page pool.
      block_table: [B, max_pages] int32 — page ids per sequence, in order;
        entries past a sequence's pages must still be valid ids (e.g. 0).
      lengths: [B] int32 — valid tokens per sequence.

    Returns [B, Hq, D] in q.dtype.
    """
    m, l, y = _decode_partials(
        q, k_pages, v_pages, lengths, block_table=block_table,
        sm_scale=sm_scale, interpret=interpret,
    )
    return _finish(q, m, l, y, False)


@functools.partial(jax.jit, static_argnames=("sm_scale", "interpret"))
def paged_flash_decode_quant(
    q: jax.Array,
    k_pages: jax.Array,
    k_scale_pages: jax.Array,
    v_pages: jax.Array,
    v_scale_pages: jax.Array,
    block_table: jax.Array,
    lengths: jax.Array,
    *,
    sm_scale: float | None = None,
    interpret: bool | None = None,
) -> jax.Array:
    """paged_flash_decode against an 8-bit page pool.

    k_pages/v_pages: [n_pages, Hkv, page_size, D] int8 or float8_e4m3fn;
    k_scale_pages/v_scale_pages: [n_pages, Hkv, page_size, 1] f32 per-token
    scales (written by paged_append_quant). Returns [B, Hq, D] in q.dtype.
    """
    m, l, y = _decode_partials(
        q, k_pages, v_pages, lengths, k_scale=k_scale_pages,
        v_scale=v_scale_pages, block_table=block_table, sm_scale=sm_scale,
        interpret=interpret,
    )
    return _finish(q, m, l, y, False)


def gather_pages(pages: jax.Array, block_table: jax.Array) -> jax.Array:
    """Contiguous per-sequence view of a pool: [n_pages, Hkv, page, X] and
    [B, max_pages] -> [B, Hkv, max_pages * page, X]."""
    b, max_pages = block_table.shape
    _, hkv, page, x = pages.shape
    g = pages[block_table]  # [B, max_pages, Hkv, page, X]
    return jnp.moveaxis(g, 2, 1).reshape(b, hkv, max_pages * page, x)


@functools.partial(jax.jit, static_argnames=("sm_scale", "interpret"))
def paged_flash_extend(
    q: jax.Array,
    k_pages: jax.Array,
    v_pages: jax.Array,
    block_table: jax.Array,
    new_lengths: jax.Array,
    old_lengths: jax.Array,
    *,
    sm_scale: float | None = None,
    interpret: bool | None = None,
    k_scale_pages: jax.Array | None = None,
    v_scale_pages: jax.Array | None = None,
) -> jax.Array:
    """Causal multi-token GQA extend against a paged KV cache.

    The chunk's own KV must already be appended to the pages
    (new_lengths == old_lengths + T). Token t of the chunk attends keys
    [0, old_lengths + t] — the linear engine's ragged `extend` semantics.

    Args:
      q: [B, Hq, T, D] — T chunk tokens per sequence.
      k_pages, v_pages: [n_pages, Hkv, page_size, D] page pool (8-bit with
        k_scale_pages/v_scale_pages [n_pages, Hkv, page_size, 1]).
      block_table: [B, max_pages] int32.
      new_lengths / old_lengths: [B] int32 lengths after / before the chunk.

    Returns [B, Hq, T, D] in q.dtype.
    """
    k = gather_pages(k_pages, block_table)
    v = gather_pages(v_pages, block_table)
    if k_scale_pages is None:
        return flash_attention_ragged(
            q, k, v, new_lengths, old_lengths, causal=True,
            sm_scale=sm_scale, interpret=interpret,
        )
    return flash_attention_ragged_kv_quant(
        q, k, gather_pages(k_scale_pages, block_table), v,
        gather_pages(v_scale_pages, block_table), new_lengths, old_lengths,
        causal=True, sm_scale=sm_scale, interpret=interpret,
    )


# ---------------------------------------------------------------------------
# Appends: XLA scatters into the pool
# ---------------------------------------------------------------------------

def _slots(block_table, lengths, t, page_size):
    """(page id, offset) of tokens lengths + [0, t) per row, [B * t] each.
    A token past its table's capacity goes to the junk page 0: the
    scheduler never lets a sequence outgrow its allocation, and this keeps
    a violation from overwriting the sequence's own last page."""
    max_pages = block_table.shape[1]
    pos = lengths[:, None] + jnp.arange(t, dtype=lengths.dtype)[None, :]
    slot = pos // page_size
    page_ids = jnp.take_along_axis(
        block_table, jnp.clip(slot, 0, max_pages - 1), axis=1
    )
    page_ids = jnp.where(slot >= max_pages, 0, page_ids)
    return page_ids.reshape(-1), (pos % page_size).reshape(-1)


def _quantizer(dtype):
    return quantize_int8 if dtype == jnp.int8 else quantize_fp8_tokenwise


def paged_append_chunk(
    k_pages: jax.Array,
    v_pages: jax.Array,
    k_new: jax.Array,   # [B, T, Hkv, D]
    v_new: jax.Array,
    block_table: jax.Array,  # [B, max_pages]
    lengths: jax.Array,      # [B] length BEFORE the append
) -> tuple[jax.Array, jax.Array]:
    """Append T tokens per sequence in one scatter per pool; tokens may
    straddle page boundaries."""
    b, t, hkv, d = k_new.shape
    pid, off = _slots(block_table, lengths, t, k_pages.shape[2])

    def write(pages, new):
        # no unique_indices: overflow rows can collide on the junk page 0
        vals = new.reshape(b * t, hkv, new.shape[3]).astype(pages.dtype)
        return pages.at[pid, :, off, :].set(vals)

    return write(k_pages, k_new), write(v_pages, v_new)


def paged_append(
    k_pages: jax.Array,
    v_pages: jax.Array,
    k_new: jax.Array,   # [B, Hkv, D]
    v_new: jax.Array,
    block_table: jax.Array,  # [B, max_pages]
    lengths: jax.Array,      # [B] length BEFORE the append
) -> tuple[jax.Array, jax.Array]:
    """Append one token per sequence into its current page (allocated by
    the PagePool)."""
    return paged_append_chunk(
        k_pages, v_pages, k_new[:, None], v_new[:, None], block_table,
        lengths,
    )


def paged_append_chunk_quant(
    k_pages: jax.Array,
    k_scale_pages: jax.Array,
    v_pages: jax.Array,
    v_scale_pages: jax.Array,
    k_new: jax.Array,   # [B, T, Hkv, D] full precision — quantized here
    v_new: jax.Array,
    block_table: jax.Array,  # [B, max_pages]
    lengths: jax.Array,      # [B] length BEFORE the append
):
    """paged_append_chunk into an 8-bit pool: per-token symmetric
    quantization, one scatter per value pool and one per scale pool.
    Returns (k_pages, k_scale_pages, v_pages, v_scale_pages)."""
    b, t, hkv, d = k_new.shape
    pid, off = _slots(block_table, lengths, t, k_pages.shape[2])
    quantizer = _quantizer(k_pages.dtype)

    def write(pages, spages, new):
        qv, scale = quantizer(new, axis=-1)  # [B, T, Hkv, D], [B, T, Hkv, 1]
        vals = qv.reshape(b * t, hkv, new.shape[3]).astype(pages.dtype)
        sc = scale.reshape(b * t, hkv, 1).astype(jnp.float32)
        return (pages.at[pid, :, off, :].set(vals),
                spages.at[pid, :, off, :].set(sc))

    k_pages, k_scale_pages = write(k_pages, k_scale_pages, k_new)
    v_pages, v_scale_pages = write(v_pages, v_scale_pages, v_new)
    return k_pages, k_scale_pages, v_pages, v_scale_pages


def paged_append_quant(
    k_pages: jax.Array,
    k_scale_pages: jax.Array,
    v_pages: jax.Array,
    v_scale_pages: jax.Array,
    k_new: jax.Array,   # [B, Hkv, D] full precision — quantized here
    v_new: jax.Array,
    block_table: jax.Array,
    lengths: jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """paged_append into an 8-bit pool (one token per sequence)."""
    return paged_append_chunk_quant(
        k_pages, k_scale_pages, v_pages, v_scale_pages, k_new[:, None],
        v_new[:, None], block_table, lengths,
    )


class PagePool:
    """Host-side page allocator for the paged KV cache (free-list).

    The device arrays are externally owned; the pool only hands out page
    ids. Page 0 is reserved as the junk page that padding table entries
    point at (the kernels never read it for live tokens)."""

    def __init__(self, n_pages: int):
        assert n_pages >= 2
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, 0, -1))  # page 0 reserved

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: want {n}, have {len(self._free)}"
            )
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: list[int]) -> None:
        for p in pages:
            if p != 0:
                self._free.append(p)

    def table_for(self, pages: list[int], max_pages: int) -> np.ndarray:
        t = np.zeros(max_pages, np.int32)
        t[: len(pages)] = pages
        return t
