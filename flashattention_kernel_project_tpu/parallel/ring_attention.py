"""Ring / context-parallel attention over a sequence-sharded KV axis.

The mathematical core is the reference's associative streaming merge
(flashattn_streaming_16x16.cu:15-24): any partition of the key axis can be
attended independently and combined. The reference only ever partitioned
*within* one chip (16-wide tiles); here the partition is ACROSS chips — each
device holds one KV shard, shards rotate around the ring via ppermute, and
partials merge in normalized (o, lse) form:

  lse = logaddexp(lse_a, lse_b)
  o   = o_a * exp(lse_a - lse) + o_b * exp(lse_b - lse)

The rotation is issued *before* the local attention compute so XLA can
overlap the interconnect transfer with the Pallas kernel — the inter-chip
version of
the reference's load(t)/compute(t-1) software pipeline
(flashattn_forward_wmma_v5_cp_async.cu:221-251).

Causal scheduling: at step t, device i attends KV shard j = (i - t) mod P.
t = 0 is the diagonal (local causal attention, static for every device);
t >= 1 contributes only where j < i, i.e. i >= t, predicated with lax.cond.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from flashattention_kernel_project_tpu.ops.flash_attention import (
    flash_attention_with_lse,
)
from flashattention_kernel_project_tpu.ops.softmax import NEG_INF


def merge_normalized(o_a, lse_a, o_b, lse_b):
    """Merge two normalized attention partials (numerically safe for
    NEG_INF-lse empty partials)."""
    lse = jnp.logaddexp(lse_a, lse_b)
    wa = jnp.exp(lse_a - lse)[..., None]
    wb = jnp.exp(lse_b - lse)[..., None]
    return o_a * wa + o_b * wb, lse


def _make_ring(mesh, attend, n_kv, *, causal, seq_axis, data_axis,
               window=None):
    """Shared ring driver: `attend(q, kv_tuple, local_causal, q_offset,
    window)` runs the local fused kernel and returns (o_f32, lse);
    `kv_tuple` is any pytree of n_kv sequence-sharded arrays that rotates
    around the ppermute ring as one unit (bf16 K/V, or 8-bit values +
    per-token scales).

    window: sliding-window attention (requires causal). A shard t hops
    back carries keys at distance >= (t-1)*S_loc + 1 from every local
    query, so the ring TRUNCATES at t_max = (window-2)//S_loc + 1 —
    out-of-window shards are neither rotated nor attended (at 32K over 8
    chips with a 4K window that is 1 hop instead of 7). In-window
    off-diagonal shards run causal with q_offset = t*S_loc, which makes
    the kernel's own band mask the global-position window."""
    assert window is None or causal, "sliding window implies causality"
    n_ring = mesh.shape[seq_axis]
    b_axis = data_axis if (data_axis and data_axis in mesh.axis_names) else None
    spec = P(b_axis, None, seq_axis, None)

    def _ring(q, *kv):
        idx = jax.lax.axis_index(seq_axis)
        perm = [(d, (d + 1) % n_ring) for d in range(n_ring)]

        # Step 0: the diagonal shard — local causal (or plain) attention.
        o, lse = attend(q, kv, local_causal=causal, q_offset=0,
                        window=window)

        s_loc = kv[0].shape[2]
        depth = n_ring
        if window is not None:
            depth = min(n_ring, (max(window - 2, 0)) // s_loc + 2)

        dv = kv[-2].shape[-1] if n_kv == 4 else kv[-1].shape[-1]
        for t in range(1, depth):
            # rotate first so the interconnect hop overlaps the local compute
            # below
            kv_next = jax.lax.ppermute(kv, seq_axis, perm)

            if causal:
                # shard j = idx - t (mod n_ring) is strictly below the
                # diagonal only when idx >= t; wrapped shards are future
                # tokens and contribute nothing.
                def _attend(q=q, kv_next=kv_next, t=t):
                    return attend(
                        q, kv_next, local_causal=False,
                        q_offset=t * s_loc, window=window,
                    )

                def _skip(q=q):
                    return (
                        jnp.zeros(q.shape[:-1] + (dv,), jnp.float32),
                        jnp.full(q.shape[:-1], NEG_INF, jnp.float32),
                    )

                o_t, lse_t = jax.lax.cond(idx >= t, _attend, _skip)
            else:
                o_t, lse_t = attend(
                    q, kv_next, local_causal=False, q_offset=0, window=None
                )

            o, lse = merge_normalized(o, lse, o_t, lse_t)
            kv = kv_next

        return o.astype(q.dtype)

    return jax.jit(
        shard_map(
            _ring, mesh=mesh, in_specs=(spec,) * (1 + n_kv), out_specs=spec,
            check_vma=False,
        )
    )


def ring_attention(
    mesh: Mesh,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    seq_axis: str = "sp",
    data_axis: str | None = "data",
    window: int | None = None,
    **kernel_kwargs,
):
    """Context-parallel attention: q, k, v sequence-sharded over `seq_axis`.

    Returns fn(q[B,H,N,D], k[B,H,S,D], v) -> [B,H,N,Dv] where N and S are
    GLOBAL lengths (shard_map slices them). Requires N and S divisible by the
    ring size. Causal assumes q and kv use the same sequence partition.

    window: sliding-window attention over GLOBAL positions (causal only).
    Out-of-window shards are skipped AND never rotated — the ring truncates
    to ceil-ish(window / shard_len) hops (see _make_ring).
    """

    def attend(q, kv, *, local_causal, q_offset=0, window=None):
        k, v = kv
        o, lse = flash_attention_with_lse(
            q, k, v, causal=local_causal or window is not None,
            q_offset=q_offset, window=window, sm_scale=sm_scale,
            **kernel_kwargs,
        )
        return o.astype(jnp.float32), lse

    return _make_ring(
        mesh, attend, 2, causal=causal, seq_axis=seq_axis,
        data_axis=data_axis, window=window,
    )


def ring_attention_kv_quant(
    mesh: Mesh,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    seq_axis: str = "sp",
    data_axis: str | None = "data",
    window: int | None = None,
    **kernel_kwargs,
):
    """Ring attention over an 8-bit (int8/fp8) sequence-sharded KV cache.

    BASELINE config 5's shape: long-context INT8 KV sharded over the mesh.
    Identical ring schedule to ring_attention, but each device holds and
    ROTATES the quantized shard (values + per-token scales) — half the
    interconnect
    bytes per hop vs bf16 — and attends through the fused-dequant kernel
    (ops.flash_attention_kv_quant_with_lse), so the shard is never
    materialized in full precision anywhere.

    Returns fn(q[B,Hq,N,D], k_q[B,Hkv,S,D] 8-bit, k_scale[B,Hkv,S,1],
    v_q, v_scale) -> [B,Hq,N,Dv] (global lengths; shard_map slices).
    """
    from flashattention_kernel_project_tpu.ops.flash_attention import (
        flash_attention_kv_quant_with_lse,
    )

    def attend(q, kv, *, local_causal, q_offset=0, window=None):
        kq, ks, vq, vs = kv
        o, lse = flash_attention_kv_quant_with_lse(
            q, kq, ks, vq, vs,
            causal=local_causal or window is not None,
            q_offset=q_offset, window=window, sm_scale=sm_scale,
            **kernel_kwargs,
        )
        return o.astype(jnp.float32), lse

    return _make_ring(
        mesh, attend, 4, causal=causal, seq_axis=seq_axis,
        data_axis=data_axis, window=window,
    )


# ---------------------------------------------------------------------------
# Differentiable ring attention (context-parallel TRAINING).
#
# Backward follows the same ring schedule as forward. The FlashAttention-2
# recompute needs only the GLOBAL (o, lse) per query row — both live on the
# query's home device after the forward merge — so each KV shard's gradient
# contribution can be computed wherever the shard happens to be: the (dk, dv)
# accumulators ride the ring WITH the shard and arrive home after a full
# loop. dq accumulates in place on the query's device. The KV rotation is
# issued before the local backward kernels so the interconnect hop overlaps
# compute,
# exactly like the forward.
# ---------------------------------------------------------------------------

def ring_attention_trainable_inner(
    n_ring: int,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    seq_axis: str = "sp",
    **kernel_kwargs,
):
    """The differentiable ring WITHOUT the shard_map wrapper: a custom-vjp
    function of (q, k, v) local shards, callable from inside any enclosing
    shard_map that carries `seq_axis` (e.g. the context-parallel train step,
    which calls it once per layer). `n_ring` is the size of that axis."""
    from flashattention_kernel_project_tpu.ops.flash_attention import _bwd

    interpret = kernel_kwargs.get("interpret", None)

    def _fwd_local(q, kv, *, local_causal):
        k, v = kv
        o, lse = flash_attention_with_lse(
            q, k, v, causal=local_causal, sm_scale=sm_scale, **kernel_kwargs,
        )
        return o.astype(jnp.float32), lse

    @jax.custom_vjp
    def _ring(q, k, v):
        o, _ = _ring_fwd(q, k, v)
        return o

    def _ring_fwd(q, k, v):
        idx = jax.lax.axis_index(seq_axis)
        perm = [(d, (d + 1) % n_ring) for d in range(n_ring)]
        o, lse = _fwd_local(q, (k, v), local_causal=causal)
        kv = (k, v)
        for t in range(1, n_ring):
            kv_next = jax.lax.ppermute(kv, seq_axis, perm)

            if causal:
                def _attend(q=q, kv_next=kv_next):
                    return _fwd_local(q, kv_next, local_causal=False)

                def _skip(q=q, kv_next=kv_next):
                    return (
                        jnp.zeros(
                            q.shape[:-1] + (kv_next[1].shape[-1],), jnp.float32
                        ),
                        jnp.full(q.shape[:-1], NEG_INF, jnp.float32),
                    )

                o_t, lse_t = jax.lax.cond(idx >= t, _attend, _skip)
            else:
                o_t, lse_t = _fwd_local(q, kv_next, local_causal=False)

            o, lse = merge_normalized(o, lse, o_t, lse_t)
            kv = kv_next
        o = o.astype(q.dtype)
        return o, (q, k, v, o, lse)

    def _bwd_step(q, k_t, v_t, o, lse, do, *, local_causal):
        sc = sm_scale if sm_scale is not None else 1.0 / (q.shape[-1] ** 0.5)
        return _bwd(
            (q, k_t, v_t, o, lse), do, causal=local_causal, sm_scale=sc,
            q_offset=0, interpret=interpret, window=None, sinks=0,
        )

    def _ring_bwd(res, do):
        q, k, v, o, lse = res
        idx = jax.lax.axis_index(seq_axis)
        perm = [(d, (d + 1) % n_ring) for d in range(n_ring)]

        # t = 0: the diagonal shard, local causal
        dq, dk0, dv0 = _bwd_step(q, k, v, o, lse, do, local_causal=causal)
        dq = dq.astype(jnp.float32)
        kv = (k, v)
        dkv = (dk0.astype(jnp.float32), dv0.astype(jnp.float32))
        for t in range(1, n_ring):
            # rotate the shard first (overlaps the interconnect hop with the
            # kernels
            # below); its accumulator follows after this step's contribution
            kv_next = jax.lax.ppermute(kv, seq_axis, perm)
            dkv = jax.lax.ppermute(dkv, seq_axis, perm)
            k_t, v_t = kv_next

            if causal:
                def _grad(q=q, k_t=k_t, v_t=v_t):
                    return _bwd_step(
                        q, k_t, v_t, o, lse, do, local_causal=False
                    )

                def _zero(q=q, k_t=k_t, v_t=v_t):
                    return (
                        jnp.zeros_like(q), jnp.zeros_like(k_t),
                        jnp.zeros_like(v_t),
                    )

                dq_t, dk_t, dv_t = jax.lax.cond(idx >= t, _grad, _zero)
            else:
                dq_t, dk_t, dv_t = _bwd_step(
                    q, k_t, v_t, o, lse, do, local_causal=False
                )

            dq = dq + dq_t.astype(jnp.float32)
            dkv = (
                dkv[0] + dk_t.astype(jnp.float32),
                dkv[1] + dv_t.astype(jnp.float32),
            )
            kv = kv_next

        # the shard on board is idx + 1 (mod P); one more hop brings each
        # accumulator back to its home device
        dkv = jax.lax.ppermute(dkv, seq_axis, perm)
        return dq.astype(q.dtype), dkv[0].astype(k.dtype), dkv[1].astype(v.dtype)

    _ring.defvjp(_ring_fwd, _ring_bwd)
    return _ring


def ring_attention_trainable(
    mesh: Mesh,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    seq_axis: str = "sp",
    data_axis: str | None = "data",
    **kernel_kwargs,
):
    """Differentiable context-parallel attention over `seq_axis`.

    Returns fn(q[B,H,N,D], k[B,H,S,D], v) -> [B,H,N,Dv] (global lengths)
    that supports jax.grad w.r.t. q, k, v — the missing piece for training
    at sequence lengths one chip cannot hold. Gradient math: FA2 recompute
    (ops.flash_attention._bwd) per ring step with the saved global
    logsumexp; causal scheduling mirrors the forward (wrapped shards are
    skipped, so their kernels never run in either direction); the (dk, dv)
    accumulators ride the rotating shard home.
    """
    n_ring = mesh.shape[seq_axis]
    b_axis = data_axis if (data_axis and data_axis in mesh.axis_names) else None
    spec = P(b_axis, None, seq_axis, None)
    _ring = ring_attention_trainable_inner(
        n_ring, causal=causal, sm_scale=sm_scale, seq_axis=seq_axis,
        **kernel_kwargs,
    )
    return jax.jit(
        shard_map(
            _ring, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
            check_vma=False,
        )
    )
