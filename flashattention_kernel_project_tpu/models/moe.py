"""Mixture-of-Experts FFN + expert parallelism (EP) over the mesh.

The reference has no MoE (SURVEY.md section 2.9 lists EP as absent); this
fills the checklist row with GShard-style DENSE dispatch —
routing becomes two one-hot einsums that run as matrix products with fully
static
shapes (no gather/scatter, no dynamic shapes under jit), and expert
parallelism is the expert dimension of those einsums sharded over a mesh
axis with one psum to combine. The token->expert "channel" here plays the
role the reference's producer/consumer shared-memory channels play in a kernel
(flashattn_streaming_16x16_mw_v5_warp_specialize.cu:160-185): data routed
between compute roles, except the roles are chips and the sync is an XLA
collective.

Capacity discipline: each expert processes at most
`capacity = ceil(top_k * T / E * capacity_factor)` tokens; overflow tokens
are dropped from that expert (their combine weight is 0), standard
GShard/Switch behavior that keeps every shape static for XLA.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int = 256
    d_ff: int = 512          # per-expert hidden width
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25

    def capacity(self, num_tokens: int) -> int:
        cap = math.ceil(self.top_k * num_tokens / self.num_experts
                        * self.capacity_factor)
        # at least one slot, and a lane-friendly multiple of 8 when possible
        return max(8, -(-cap // 8) * 8) if num_tokens >= 8 else max(1, cap)


def init_moe_params(key: jax.Array, cfg: MoEConfig) -> dict:
    kg, k1, k2 = jax.random.split(key, 3)
    scale_in = 1.0 / math.sqrt(cfg.d_model)
    scale_ff = 1.0 / math.sqrt(cfg.d_ff)
    return {
        "w_gate": jax.random.normal(kg, (cfg.d_model, cfg.num_experts),
                                    jnp.float32) * scale_in,
        "w1": jax.random.normal(k1, (cfg.num_experts, cfg.d_model, cfg.d_ff),
                                jnp.float32) * scale_in,
        "w2": jax.random.normal(k2, (cfg.num_experts, cfg.d_ff, cfg.d_model),
                                jnp.float32) * scale_ff,
    }


def moe_param_shardings(cfg: MoEConfig, expert_axis: str = "expert") -> dict:
    """PartitionSpecs for EP: experts sharded, router replicated."""
    del cfg
    return {
        "w_gate": P(),
        "w1": P(expert_axis, None, None),
        "w2": P(expert_axis, None, None),
    }


def _top_k_dispatch(probs: jax.Array, top_k: int, capacity: int):
    """Static-shape top-k routing with per-expert capacity.

    probs: [T, E] router softmax. Returns (dispatch, combine, aux_loss):
    dispatch/combine are [T, E, C] one-hot(-weighted) tensors — the two
    einsum operands that replace gather/scatter.
    """
    t, e = probs.shape
    chosen_gates = []
    chosen_masks = []
    p = probs
    for _ in range(top_k):
        idx = jnp.argmax(p, axis=-1)
        oh = jax.nn.one_hot(idx, e, dtype=probs.dtype)
        chosen_gates.append(jnp.sum(probs * oh, axis=-1))
        chosen_masks.append(oh)
        p = p * (1.0 - oh)
    gates = jnp.stack(chosen_gates, axis=-1)                       # [T, k]
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)

    # load-balancing aux loss (Switch Transformer eq. 4) on the FIRST choice
    frac_tokens = jnp.mean(chosen_masks[0], axis=0)                # [E]
    frac_probs = jnp.mean(probs, axis=0)                           # [E]
    aux_loss = e * jnp.sum(frac_tokens * frac_probs)

    counts = jnp.zeros((e,), jnp.int32)   # per-expert fill across choices
    dispatch = jnp.zeros((t, e, capacity), probs.dtype)
    combine = jnp.zeros((t, e, capacity), probs.dtype)
    for k, oh in enumerate(chosen_masks):
        ohi = oh.astype(jnp.int32)
        # position of each token within its chosen expert's buffer
        pos = jnp.cumsum(ohi, axis=0) - ohi + counts[None, :]      # [T, E]
        counts = counts + jnp.sum(ohi, axis=0)
        keep = (pos < capacity).astype(probs.dtype) * oh           # [T, E]
        pos_scalar = jnp.sum(pos * ohi, axis=-1)                   # [T]
        pos_oh = jax.nn.one_hot(pos_scalar, capacity, dtype=probs.dtype)
        d = keep[:, :, None] * pos_oh[:, None, :]                  # [T, E, C]
        dispatch = dispatch + d
        combine = combine + gates[:, k][:, None, None] * d
    return dispatch, combine, aux_loss


def _top_k_choices(probs: jax.Array, top_k: int):
    """Iterative-argmax top-k (the dense path's exact selection order).
    Returns (gates [T, k] renormalized, masks list of [T, E] one-hots,
    aux_loss)."""
    t, e = probs.shape
    chosen_gates = []
    chosen_masks = []
    p = probs
    for _ in range(top_k):
        idx = jnp.argmax(p, axis=-1)
        oh = jax.nn.one_hot(idx, e, dtype=probs.dtype)
        chosen_gates.append(jnp.sum(probs * oh, axis=-1))
        chosen_masks.append(oh)
        p = p * (1.0 - oh)
    gates = jnp.stack(chosen_gates, axis=-1)                       # [T, k]
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    frac_tokens = jnp.mean(chosen_masks[0], axis=0)                # [E]
    frac_probs = jnp.mean(probs, axis=0)                           # [E]
    aux_loss = e * jnp.sum(frac_tokens * frac_probs)
    return gates, chosen_masks, aux_loss


def _top_k_dispatch_sort(probs: jax.Array, top_k: int, capacity: int):
    """Sort-based RAGGED dispatch: same routing and
    drop semantics as _top_k_dispatch, but O(T*k) index tensors instead of
    the dense [T, E, C] one-hots — the dense pair is 2 * T*E*C f32
    (2 x 671 MB at b4/seq2048/E8, the r3 bench OOM); this is ~100 KB.

    Returns (slot_token [E*C+1] int32 — the token filling each expert
    slot, T = dummy; slot_tk [T, k] int32 — each choice's slot, E*C =
    dummy/dropped; gates [T, k]; aux_loss). Data movement becomes two
    GATHERS (dispatch: x[slot_token], combine: out[slot_tk]) — static
    shapes, no scatter of activations.

    Drop-order parity with the dense path: entries are flattened K-MAJOR
    ([k, T]) and sorted STABLY by expert, so all first choices fill an
    expert's buffer before any second choice, in token order — exactly
    the dense path's `counts` accumulation across choices."""
    t, e = probs.shape
    gates, masks, aux_loss = _top_k_choices(probs, top_k)
    expert_idx = jnp.stack(
        [jnp.argmax(m, axis=-1) for m in masks], axis=0
    )                                                            # [k, T]
    flat_e = expert_idx.reshape(-1)                              # k-major
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = jnp.searchsorted(sorted_e, jnp.arange(e), side="left")
    pos = jnp.arange(top_k * t) - start[sorted_e]
    keep = pos < capacity
    dummy = e * capacity
    slot_sorted = jnp.where(keep, sorted_e * capacity + pos, dummy)
    flat_t = jnp.tile(jnp.arange(t), top_k)
    sorted_t = flat_t[order]
    slot_token = jnp.full((dummy + 1,), t, jnp.int32)
    slot_token = slot_token.at[slot_sorted].set(sorted_t.astype(jnp.int32))
    # ensure the dummy slot stays dummy even if every entry kept
    slot_token = slot_token.at[dummy].set(t)
    inv = jnp.argsort(order)
    slot_tk = slot_sorted[inv].reshape(top_k, t).T               # [T, k]
    return slot_token, slot_tk, gates, aux_loss


# dense dispatch/combine one-hots cost 2 * T*E*C f32 bytes; beyond this
# budget the sort-based ragged dispatch takes over ("auto" mode)
_DENSE_DISPATCH_BYTES = 64 << 20


def _expert_ffn(w1: jax.Array, w2: jax.Array, expert_in: jax.Array):
    """[E, C, D] -> [E, C, D] through each expert's gelu MLP (batched matmuls)."""
    h = jax.nn.gelu(jnp.einsum("ecd,edf->ecf", expert_in, w1,
                               preferred_element_type=jnp.float32))
    return jnp.einsum("ecf,efd->ecd", h, w2,
                      preferred_element_type=jnp.float32)


def _use_sort_dispatch(dispatch: str, t: int, e: int, c: int) -> bool:
    if dispatch == "auto":
        return 2 * t * e * c * 4 > _DENSE_DISPATCH_BYTES
    assert dispatch in ("dense", "sort"), dispatch
    return dispatch == "sort"


@functools.partial(jax.jit, static_argnames=("cfg", "return_aux", "dispatch"))
def moe_ffn(params: dict, x: jax.Array, cfg: MoEConfig,
            *, return_aux: bool = False, dispatch: str = "auto"):
    """Single-device MoE FFN. x: [..., T, D] (leading dims folded into T).

    dispatch: "dense" (GShard one-hot einsums), "sort" (ragged sort-based
    gathers — same routing/drops, O(T*k) index memory), or "auto" (sort
    when the dense one-hots would exceed the 64 MB budget)."""
    orig_shape = x.shape
    x2 = x.reshape(-1, cfg.d_model).astype(jnp.float32)
    t = x2.shape[0]
    cap = cfg.capacity(t)
    probs = jax.nn.softmax(x2 @ params["w_gate"], axis=-1)
    if _use_sort_dispatch(dispatch, t, cfg.num_experts, cap):
        slot_token, slot_tk, gates, aux = _top_k_dispatch_sort(
            probs, cfg.top_k, cap)
        x2p = jnp.concatenate([x2, jnp.zeros((1, cfg.d_model), x2.dtype)])
        expert_in = x2p[slot_token[:-1]].reshape(
            cfg.num_experts, cap, cfg.d_model)
        expert_out = _expert_ffn(params["w1"], params["w2"], expert_in)
        eo = jnp.concatenate([
            expert_out.reshape(-1, cfg.d_model),
            jnp.zeros((1, cfg.d_model), expert_out.dtype),
        ])
        out = sum(
            gates[:, j, None] * eo[slot_tk[:, j]]
            for j in range(cfg.top_k)
        )
    else:
        dsp, combine, aux = _top_k_dispatch(probs, cfg.top_k, cap)
        expert_in = jnp.einsum("tec,td->ecd", dsp, x2,
                               preferred_element_type=jnp.float32)
        expert_out = _expert_ffn(params["w1"], params["w2"], expert_in)
        out = jnp.einsum("tec,ecd->td", combine, expert_out,
                         preferred_element_type=jnp.float32)
    out = out.reshape(orig_shape).astype(x.dtype)
    return (out, aux) if return_aux else out


def make_ep_moe(mesh: Mesh, cfg: MoEConfig, *,
                expert_axis: str = "expert",
                data_axis: str | None = None,
                return_aux: bool = False,
                dispatch: str = "auto"):
    """Expert-parallel MoE FFN over the mesh.

    Experts live sharded on `expert_axis` (see moe_param_shardings); the
    router + dispatch/combine tensors are computed replicated per chip (the
    router is tiny), each chip runs only ITS experts' FFNs, and one psum
    over the expert axis assembles the output — tokens never leave their
    chip, expert activations do, which is the cheap direction when
    d_model << top_k * d_ff. With `data_axis`, tokens are additionally
    sharded (each data shard routes independently with its own capacity).
    Numerics match moe_ffn exactly: same dispatch, same drops.
    """
    n_exp_shards = mesh.shape[expert_axis]
    assert cfg.num_experts % n_exp_shards == 0, (cfg.num_experts, n_exp_shards)
    e_local = cfg.num_experts // n_exp_shards

    def fn(params, x):
        orig_shape = x.shape
        x2 = x.reshape(-1, cfg.d_model).astype(jnp.float32)
        t = x2.shape[0]
        cap = cfg.capacity(t)
        probs = jax.nn.softmax(x2 @ params["w_gate"], axis=-1)
        shard = jax.lax.axis_index(expert_axis)
        if _use_sort_dispatch(dispatch, t, cfg.num_experts, cap):
            # ragged dispatch, EP form: indices computed replicated (they
            # are O(T*k)); each chip gathers only ITS experts' slots and
            # combines with out-of-range slots routed to the dummy zero
            # row — the psum assembles exactly the dense path's output
            slot_token, slot_tk, gates, aux = _top_k_dispatch_sort(
                probs, cfg.top_k, cap)
            lo = shard * e_local * cap
            tok_l = jax.lax.dynamic_slice_in_dim(
                slot_token, lo, e_local * cap, axis=0)
            x2p = jnp.concatenate(
                [x2, jnp.zeros((1, cfg.d_model), x2.dtype)])
            expert_in = x2p[tok_l].reshape(e_local, cap, cfg.d_model)
            expert_out = _expert_ffn(params["w1"], params["w2"], expert_in)
            eo = jnp.concatenate([
                expert_out.reshape(-1, cfg.d_model),
                jnp.zeros((1, cfg.d_model), expert_out.dtype),
            ])
            idx_l = slot_tk - lo
            valid = jnp.logical_and(idx_l >= 0, idx_l < e_local * cap)
            idx_l = jnp.where(valid, idx_l, e_local * cap)
            partial = sum(
                gates[:, j, None] * eo[idx_l[:, j]]
                for j in range(cfg.top_k)
            )
        else:
            dsp, combine, aux = _top_k_dispatch(probs, cfg.top_k, cap)
            disp_l = jax.lax.dynamic_slice_in_dim(
                dsp, shard * e_local, e_local, axis=1)
            comb_l = jax.lax.dynamic_slice_in_dim(
                combine, shard * e_local, e_local, axis=1)
            expert_in = jnp.einsum("tec,td->ecd", disp_l, x2,
                                   preferred_element_type=jnp.float32)
            expert_out = _expert_ffn(params["w1"], params["w2"], expert_in)
            partial = jnp.einsum("tec,ecd->td", comb_l, expert_out,
                                 preferred_element_type=jnp.float32)
        out = jax.lax.psum(partial, expert_axis)
        out = out.reshape(orig_shape).astype(x.dtype)
        if return_aux and data_axis:
            # each data shard routes its own tokens -> per-shard aux; the
            # out_spec declares aux replicated, so make it actually so
            aux = jax.lax.pmean(aux, data_axis)
        return (out, aux) if return_aux else out

    pspecs = moe_param_shardings(cfg, expert_axis)
    x_spec = P(data_axis) if data_axis else P()
    out_spec = (x_spec, P()) if return_aux else x_spec
    mapped = shard_map(
        fn, mesh=mesh,
        in_specs=({k: pspecs[k] for k in ("w_gate", "w1", "w2")}, x_spec),
        out_specs=out_spec,
        check_vma=False,
    )
    return jax.jit(mapped)
