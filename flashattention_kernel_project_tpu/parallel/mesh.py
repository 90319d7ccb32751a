"""Device mesh + tensor-parallel (head-sharded) attention wrappers.

The reference is single-GPU; its only "parallelism" is batchxhead grid
dimensions (SURVEY.md section 2.9). This layer is the designed-fresh
multi-chip story: a named Mesh, shard_map-wrapped kernels, and XLA
collectives over the interconnect. Head sharding follows the idiomatic
P(None, "model", ...) pattern (KV heads on the model axis), so the Pallas
kernels below run unchanged per shard — the mesh is purely a layout concern.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from flashattention_kernel_project_tpu.ops.flash_attention import flash_attention
from flashattention_kernel_project_tpu.ops.flash_decode import flash_decode


def make_mesh(
    axis_sizes: dict[str, int] | None = None,
    *,
    devices: Sequence[jax.Device] | None = None,
) -> Mesh:
    """Build a Mesh. Default: all devices on a single "model" axis.

    axis_sizes like {"data": 2, "model": 4}; a single -1 entry absorbs the
    remaining devices.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = {"model": n}
    names = tuple(axis_sizes)
    sizes = list(axis_sizes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    assert int(np.prod(sizes)) == n, (sizes, n)
    dev_array = np.asarray(devices).reshape(sizes)
    return Mesh(dev_array, names)


def head_sharded_attention(
    mesh: Mesh,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    data_axis: str | None = "data",
    model_axis: str = "model",
    **kernel_kwargs,
):
    """shard_map-wrapped fused attention: KV heads on the model axis, batch
    on the data axis. Zero collectives in the forward — attention is
    embarrassingly parallel over heads; the surrounding projections own the
    all-reduces.

    Returns fn(q[B,Hq,N,D], k[B,Hkv,S,D], v) -> [B,Hq,N,Dv].
    """
    b_axis = data_axis if data_axis in mesh.axis_names else None
    spec = P(b_axis, model_axis, None, None)

    def _attn(q, k, v):
        return flash_attention(
            q, k, v, causal=causal, sm_scale=sm_scale, **kernel_kwargs
        )

    return jax.jit(
        shard_map(
            _attn, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
            check_vma=False,
        )
    )


def head_sharded_decode(
    mesh: Mesh,
    *,
    n_splits: int = 8,
    sm_scale: float | None = None,
    data_axis: str | None = "data",
    model_axis: str = "model",
    **kernel_kwargs,
):
    """shard_map-wrapped split-KV decode: the KV cache is tensor-sharded over
    KV heads (P(batch, "model", None, None)) so each chip streams only its
    slice of the cache — the multi-chip version of the reference's
    grid-over-heads batching.

    Returns fn(q[B,Hq,D], k_cache, v_cache, lengths[B]) -> [B,Hq,D].
    """
    b_axis = data_axis if data_axis in mesh.axis_names else None
    q_spec = P(b_axis, model_axis, None)
    kv_spec = P(b_axis, model_axis, None, None)
    len_spec = P(b_axis)

    def _decode(q, k_cache, v_cache, lengths):
        return flash_decode(
            q, k_cache, v_cache, lengths,
            n_splits=n_splits, sm_scale=sm_scale, **kernel_kwargs,
        )

    return jax.jit(
        shard_map(
            _decode,
            mesh=mesh,
            in_specs=(q_spec, kv_spec, kv_spec, len_spec),
            out_specs=q_spec,
            check_vma=False,
        )
    )


def shard_params(params, mesh: Mesh, rules) -> object:
    """Apply a pytree of PartitionSpecs to a matching pytree of arrays."""
    return jax.tree.map(
        lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec)),
        params,
        rules,
    )


def head_sharded_decode_quant(
    mesh: Mesh,
    *,
    n_splits: int = 8,
    sm_scale: float | None = None,
    data_axis: str | None = "data",
    model_axis: str = "model",
    **kernel_kwargs,
):
    """head_sharded_decode against an 8-bit KV cache: each chip streams its
    int8/fp8 head slice (values + per-token scales) through the
    fused-dequant split-KV kernel — half the per-chip HBM traffic of the
    bf16 TP decode, completing the BASELINE north star's "quantized KV
    tensor-sharded over the mesh" decode path.

    Returns fn(q[B,Hq,D], k_q[B,Hkv,S,D] 8-bit, k_scale[B,Hkv,S,1],
    v_q, v_scale, lengths[B]) -> [B,Hq,D].
    """
    from flashattention_kernel_project_tpu.ops.flash_decode import (
        flash_decode_int8,
    )

    b_axis = data_axis if data_axis in mesh.axis_names else None
    q_spec = P(b_axis, model_axis, None)
    kv_spec = P(b_axis, model_axis, None, None)
    len_spec = P(b_axis)

    def _decode(q, k_q, k_s, v_q, v_s, lengths):
        return flash_decode_int8(
            q, k_q, k_s, v_q, v_s, lengths,
            n_splits=n_splits, sm_scale=sm_scale, **kernel_kwargs,
        )

    return jax.jit(
        shard_map(
            _decode,
            mesh=mesh,
            in_specs=(q_spec, kv_spec, kv_spec, kv_spec, kv_spec, len_spec),
            out_specs=q_spec,
            check_vma=False,
        )
    )


def seq_sharded_decode(
    mesh: Mesh,
    *,
    n_splits: int | None = None,
    sm_scale: float | None = None,
    data_axis: str | None = "data",
    seq_axis: str = "sp",
    **kernel_kwargs,
):
    """Sequence-sharded split-KV decode: the KV cache is sharded along its
    LENGTH over `seq_axis` (P(batch, None, seq_axis, None)) — for contexts
    longer than one chip's HBM, orthogonal to head_sharded_decode's TP axis.
    Each chip runs the split-KV kernel over its slice with the slice-local
    length and emits the UNNORMALIZED (m, l, y) streaming state
    (flash_decode(return_partials=True)); one all_gather + the associative
    merge (the reference's streaming algebra,
    flashattn_streaming_16x16.cu:15-24, applied across chips) produces the
    output everywhere. The gathered state is [B, Hq, D]-sized — decode
    partials, not cache — so the collective is tiny.

    Returns fn(q[B,Hq,D], k_cache[B,Hkv,S,D], v_cache, lengths[B]) ->
    [B,Hq,D] with S the GLOBAL cache length (divisible by the shard count).
    """
    from flashattention_kernel_project_tpu.ops.flash_decode import (
        flash_decode,
        merge_partials,
    )

    b_axis = data_axis if (data_axis and data_axis in mesh.axis_names) else None
    q_spec = P(b_axis, None, None)
    kv_spec = P(b_axis, None, seq_axis, None)
    len_spec = P(b_axis)

    def _decode(q, k_shard, v_shard, lengths):
        idx = jax.lax.axis_index(seq_axis)
        s_loc = k_shard.shape[2]
        local_len = jnp.clip(lengths - idx * s_loc, 0, s_loc)
        m, l, y = flash_decode(
            q, k_shard, v_shard, local_len,
            n_splits=n_splits, sm_scale=sm_scale, return_partials=True,
            **kernel_kwargs,
        )
        mm = jnp.moveaxis(jax.lax.all_gather(m, seq_axis), 0, -3)
        ll = jnp.moveaxis(jax.lax.all_gather(l, seq_axis), 0, -3)
        yy = jnp.moveaxis(jax.lax.all_gather(y, seq_axis), 0, -3)
        out = merge_partials(mm, ll, yy)  # [B, Hkv, G, D]
        bb, hkv, g, d = out.shape
        return out.reshape(bb, hkv * g, d).astype(q.dtype)

    return jax.jit(
        shard_map(
            _decode,
            mesh=mesh,
            in_specs=(q_spec, kv_spec, kv_spec, len_spec),
            out_specs=q_spec,
            check_vma=False,
        )
    )
