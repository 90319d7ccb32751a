"""Ulysses (DeepSpeed-style) sequence parallelism via all-to-all.

The second sequence-parallel strategy next to ring attention: instead of
rotating KV shards, re-shard — an all-to-all converts sequence-sharded
activations [B, H, N/P, D] into head-sharded [B, H/P, N, D], each device runs
the fused kernel on FULL sequences for its head subset, and a second
all-to-all converts back. Two collectives total (vs P-1 ppermute hops for
ring), at the cost of requiring heads % ring_size == 0.

Absent in the reference (heads were only a grid dimension, SURVEY.md
section 2.9); implemented fresh with shard_map + lax.all_to_all over the
interconnect.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from flashattention_kernel_project_tpu.ops.flash_attention import flash_attention


def ulysses_attention(
    mesh: Mesh,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    seq_axis: str = "sp",
    data_axis: str | None = "data",
    **kernel_kwargs,
):
    """fn(q[B,H,N,D], k[B,H,S,D], v) with N/S sequence-sharded over seq_axis.

    Requires q/k/v head count divisible by the seq_axis size. GQA works when
    kv_heads % P == 0; otherwise shard query heads and replicate KV
    externally before calling.
    """
    b_axis = data_axis if (data_axis and data_axis in mesh.axis_names) else None
    spec = P(b_axis, None, seq_axis, None)

    def _attend(q, k, v):
        # [B, H, N_local, D] --all_to_all--> [B, H_local, N_global, D]
        def seq_to_heads(x):
            return jax.lax.all_to_all(
                x, seq_axis, split_axis=1, concat_axis=2, tiled=True
            )

        def heads_to_seq(x):
            return jax.lax.all_to_all(
                x, seq_axis, split_axis=2, concat_axis=1, tiled=True
            )

        qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
        o = flash_attention(
            qh, kh, vh, causal=causal, sm_scale=sm_scale, **kernel_kwargs
        )
        return heads_to_seq(o)

    return jax.jit(
        shard_map(
            _attend, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
            check_vma=False,
        )
    )
