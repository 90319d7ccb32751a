"""DP x TP training step under shard_map (megatron-style, explicit collectives).

The reference has no training and no multi-device anything; this implements
the missing layer idiomatically: parameters tensor-sharded over "model"
(column-parallel qkv/gate/up, row-parallel o/down), batch sharded over
"data". Inside shard_map each device runs the Pallas flash-attention kernel
on its local heads; the only collectives are the two psums after the
row-parallel projections (attention out, MLP down) and the gradient pmean
over the data axis — all riding the interconnect.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from flashattention_kernel_project_tpu.models import transformer as tfm
from flashattention_kernel_project_tpu.ops.flash_attention import flash_attention


def _tp_forward(cfg, params, tokens, *, model_axis, interpret=None,
                remat=False):
    """Local-shard forward. Head counts come from the *local* array shapes
    (wq arrives column-sliced under shard_map). remat=True checkpoints each
    layer: activations are recomputed in the backward instead of stored —
    O(1) layers' worth of residuals instead of O(n_layers), the standard
    memory/FLOPs trade for long sequences."""
    b, n = tokens.shape
    x = params["embed"][tokens]
    positions = jnp.arange(n)[None, :]
    sin, cos = tfm.rope_tables(cfg, positions)

    def layer_fn(x, layer):
        hq_local = layer["wq"].shape[-1] // cfg.d_head
        hkv_local = layer["wk"].shape[-1] // cfg.d_head

        h = tfm.rms_norm(x, layer["rms_attn"])
        q = (h @ layer["wq"]).reshape(b, n, hq_local, cfg.d_head)
        k = (h @ layer["wk"]).reshape(b, n, hkv_local, cfg.d_head)
        v = (h @ layer["wv"]).reshape(b, n, hkv_local, cfg.d_head)
        q = tfm.apply_rope(q, sin, cos)
        k = tfm.apply_rope(k, sin, cos)
        o = flash_attention(
            q.transpose(0, 2, 1, 3),
            k.transpose(0, 2, 1, 3),
            v.transpose(0, 2, 1, 3),
            causal=True,
            interpret=interpret,
        )
        o = o.transpose(0, 2, 1, 3).reshape(b, n, hq_local * cfg.d_head)
        # row-parallel wo: partial sums -> psum over the model axis
        x = x + jax.lax.psum(o @ layer["wo"], model_axis)

        if "moe_w1" in layer:
            # expert parallelism under TP: moe_w1/w2 arrive expert-sliced on
            # the model axis; router + dispatch are replicated (the router is
            # tiny), each shard runs its local experts, one psum combines —
            # same algebra as models.moe.make_ep_moe
            from flashattention_kernel_project_tpu.models import moe as _moe

            h2 = tfm.rms_norm(x, layer["rms_mlp"])
            h2f = h2.reshape(-1, cfg.d_model).astype(jnp.float32)
            t = h2f.shape[0]
            probs = jax.nn.softmax(h2f @ layer["moe_router"], axis=-1)
            cap = _moe.MoEConfig(
                num_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
                capacity_factor=cfg.moe_capacity_factor).capacity(t)
            dispatch, combine, aux = _moe._top_k_dispatch(
                probs, cfg.moe_top_k, cap)
            e_local = layer["moe_w1"].shape[0]
            off = jax.lax.axis_index(model_axis) * e_local
            disp_l = jax.lax.dynamic_slice_in_dim(dispatch, off, e_local, 1)
            comb_l = jax.lax.dynamic_slice_in_dim(combine, off, e_local, 1)
            expert_in = jnp.einsum("tec,td->ecd", disp_l, h2f,
                                   preferred_element_type=jnp.float32)
            expert_out = _moe._expert_ffn(
                layer["moe_w1"].astype(jnp.float32),
                layer["moe_w2"].astype(jnp.float32), expert_in)
            part = jnp.einsum("tec,ecd->td", comb_l, expert_out,
                              preferred_element_type=jnp.float32)
            out = jax.lax.psum(part, model_axis).reshape(h2.shape)
            return x + out.astype(x.dtype), aux

        h2 = tfm.rms_norm(x, layer["rms_mlp"])
        gated = jax.nn.silu(h2 @ layer["w_gate"]) * (h2 @ layer["w_up"])
        out = x + jax.lax.psum(gated @ layer["w_down"], model_axis)
        return out, jnp.float32(0.0)

    if remat:
        layer_fn = jax.checkpoint(layer_fn)
    n_layers = params["layers"]["wq"].shape[0]
    aux_total = jnp.float32(0.0)
    for i in range(n_layers):
        layer = jax.tree.map(lambda p: p[i], params["layers"])
        x, aux = layer_fn(x, layer)
        aux_total = aux_total + aux

    x = tfm.rms_norm(x, params["rms_final"])
    logits = jnp.matmul(x, params["embed"].T,
                        preferred_element_type=jnp.float32)
    return logits, aux_total / n_layers


def _tp_loss(cfg, params, tokens, *, model_axis, interpret=None,
             remat=False):
    logits, aux = _tp_forward(
        cfg, params, tokens, model_axis=model_axis, interpret=interpret,
        remat=remat,
    )
    targets = tokens[:, 1:]
    logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    return jnp.mean(nll) + cfg.moe_aux_weight * aux


def make_train_step(
    cfg: tfm.TransformerConfig,
    mesh: Mesh,
    *,
    lr: float = 1e-3,
    data_axis: str = "data",
    model_axis: str = "model",
    interpret: bool | None = None,
    remat: bool = False,
):
    """Build the jitted DP x TP train step. remat=True checkpoints each
    layer (recompute-in-backward; O(1) residual memory).

    Returns (step_fn(params, tokens) -> (new_params, loss), param_specs).
    `params` must be laid out per param_specs (parallel.mesh.shard_params).
    """
    rules = tfm.param_shardings(cfg, data_axis=data_axis, model_axis=model_axis)

    def _is_tp(spec: P) -> bool:
        return model_axis in [ax for ax in spec if ax is not None]

    tp = mesh.shape[model_axis]

    def step(params, tokens):
        loss, grads = jax.value_and_grad(
            functools.partial(
                _tp_loss, cfg, model_axis=model_axis, interpret=interpret,
                remat=remat,
            )
        )(params, tokens)
        # DP: average grads + loss over the data axis.
        grads = jax.tree.map(lambda g: jax.lax.pmean(g, data_axis), grads)
        loss = jax.lax.pmean(loss, data_axis)
        # psum's TRANSPOSE is psum (check_vma=False): every cotangent that
        # crossed a forward psum arrives scaled by |model|, so each chip's
        # raw grad is tp * (its own contribution). Replicated leaves
        # (embed, norms): pmean over model folds the factor away WHILE
        # summing the per-chip contributions (the same algebra as the CP
        # step below). TP-sharded leaves: the chip's contribution IS the
        # whole gradient of its exclusive shard — divide the factor out.
        grads = jax.tree.map(
            lambda g, spec: (
                g / tp if _is_tp(spec) else jax.lax.pmean(g, model_axis)
            ),
            grads,
            rules,
        )
        new_params = jax.tree.map(
            lambda p, g: (
                p.astype(jnp.float32) - lr * g.astype(jnp.float32)
            ).astype(p.dtype),
            params,
            grads,
        )
        return new_params, loss

    step_sm = shard_map(
        step,
        mesh=mesh,
        in_specs=(rules, P(data_axis, None)),
        out_specs=(rules, P()),
        check_vma=False,
    )
    return jax.jit(step_sm), rules


# ---------------------------------------------------------------------------
# Context-parallel (sequence-sharded) training: the long-context train step.
# Parameters replicated; each device holds a contiguous slice of the
# sequence and attends globally through the differentiable ring
# (ring_attention_trainable_inner, called once per layer inside this
# shard_map). Gradients are psum'd over the ring — the loss normalization
# is already global, so the sum IS the global gradient.
# ---------------------------------------------------------------------------

def _cp_forward(cfg, params, tokens, *, ring, n_ring, seq_axis, interpret=None):
    """Local-slice forward. `tokens` arrives REPLICATED [b, n_global]; each
    device slices its n_global/n_ring positions (RoPE uses global positions)."""
    b, n = tokens.shape
    n_loc = n // n_ring
    idx = jax.lax.axis_index(seq_axis)
    tok = jax.lax.dynamic_slice_in_dim(tokens, idx * n_loc, n_loc, 1)
    x = params["embed"][tok]
    positions = idx * n_loc + jnp.arange(n_loc)[None, :]
    sin, cos = tfm.rope_tables(cfg, positions)

    n_layers = params["layers"]["wq"].shape[0]
    aux_total = jnp.float32(0.0)
    for i in range(n_layers):
        layer = jax.tree.map(lambda p: p[i], params["layers"])
        h = tfm.rms_norm(x, layer["rms_attn"])
        q = (h @ layer["wq"]).reshape(b, n_loc, cfg.n_heads, cfg.d_head)
        k = (h @ layer["wk"]).reshape(b, n_loc, cfg.n_kv_heads, cfg.d_head)
        v = (h @ layer["wv"]).reshape(b, n_loc, cfg.n_kv_heads, cfg.d_head)
        q = tfm.apply_rope(q, sin, cos)
        k = tfm.apply_rope(k, sin, cos)
        o = ring(
            q.transpose(0, 2, 1, 3),
            k.transpose(0, 2, 1, 3),
            v.transpose(0, 2, 1, 3),
        )
        x = x + o.transpose(0, 2, 1, 3).reshape(b, n_loc, cfg.q_dim) @ layer["wo"]
        if "moe_w1" in layer:
            x, aux = tfm._moe_mlp_block(layer, x, cfg)
            aux_total = aux_total + aux
        else:
            x = tfm._mlp_block(layer, x, cfg)

    x = tfm.rms_norm(x, params["rms_final"])
    logits = jnp.matmul(x, params["embed"].T,
                        preferred_element_type=jnp.float32)
    return logits, tok, aux_total / n_layers


def _cp_loss(cfg, params, tokens, *, ring, n_ring, seq_axis, interpret=None):
    """Global next-token NLL from sequence-sharded logits: per-shard
    (sum, count) combined with psum (shard token counts differ — the last
    global position has no label — so a pmean of means would be biased)."""
    logits, _, aux = _cp_forward(
        cfg, params, tokens, ring=ring, n_ring=n_ring, seq_axis=seq_axis,
        interpret=interpret,
    )
    b, n = tokens.shape
    n_loc = n // n_ring
    idx = jax.lax.axis_index(seq_axis)
    padded = jnp.pad(tokens, ((0, 0), (0, 1)))
    labels = jax.lax.dynamic_slice_in_dim(padded, idx * n_loc + 1, n_loc, 1)
    pos = idx * n_loc + jnp.arange(n_loc)
    valid = (pos + 1 < n)[None, :].astype(jnp.float32)

    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, labels[..., None], axis=-1)[..., 0]
    loss_sum = jax.lax.psum(jnp.sum(nll * valid), seq_axis)
    count = jax.lax.psum(b * jnp.sum(valid), seq_axis)
    # each seq shard routes different tokens -> different aux; shards carry
    # equal token counts so the global balance loss is their mean
    aux = jax.lax.pmean(aux, seq_axis)
    return loss_sum / count + cfg.moe_aux_weight * aux


def make_cp_train_step(
    cfg: tfm.TransformerConfig,
    mesh: Mesh,
    *,
    lr: float = 1e-3,
    seq_axis: str = "sp",
    interpret: bool | None = None,
):
    """Build the jitted context-parallel train step (sequence over
    `seq_axis`, params replicated, ring attention per layer).

    Returns (step_fn(params, tokens[b, n_global]) -> (new_params, loss),
    param_specs) — param_specs are all-replicated P()s for shard_params.
    n_global must be divisible by the ring size.
    """
    from flashattention_kernel_project_tpu.parallel.ring_attention import (
        ring_attention_trainable_inner,
    )

    n_ring = mesh.shape[seq_axis]
    ring = ring_attention_trainable_inner(
        n_ring, causal=True, seq_axis=seq_axis, interpret=interpret,
    )

    def step(params, tokens):
        loss, grads = jax.value_and_grad(
            functools.partial(
                _cp_loss, cfg, ring=ring, n_ring=n_ring, seq_axis=seq_axis,
                interpret=interpret,
            )
        )(params, tokens)
        # psum's TRANSPOSE is psum: back-propagating through _cp_loss's
        # loss/count psums hands every device a cotangent multiplied by the
        # ring size, so each local grad is n_ring * (its own contribution);
        # pmean folds the factor away while summing the contributions
        # (verified against the single-device grads in
        # tests/test_train_parallel.py)
        grads = jax.tree.map(lambda g: jax.lax.pmean(g, seq_axis), grads)
        new_params = jax.tree.map(
            lambda p, g: (
                p.astype(jnp.float32) - lr * g.astype(jnp.float32)
            ).astype(p.dtype),
            params,
            grads,
        )
        return new_params, loss

    rules = jax.tree.map(
        lambda _: P(), tfm.param_shardings(cfg),
        is_leaf=lambda x: isinstance(x, P),
    )
    step_sm = shard_map(
        step,
        mesh=mesh,
        in_specs=(rules, P(None, None)),
        out_specs=(rules, P()),
        check_vma=False,
    )
    return jax.jit(step_sm), rules


# ---------------------------------------------------------------------------
# Optax-backed DP x TP train step: real optimizers (AdamW, schedules) over
# the same megatron layout. Optimizer state mirrors the param sharding
# (Adam's mu/nu are param-shaped -> param specs; step counters replicate).
# ---------------------------------------------------------------------------

def _optimizer_state_specs(optimizer, params, rules):
    """PartitionSpecs for an optax state: any sub-tree structured exactly
    like `params` (mu, nu, trace, ...) gets the param specs; everything
    else (counters, scalars) replicates."""
    pdef = jax.tree.structure(params)
    shapes = jax.eval_shape(optimizer.init, params)

    def is_node(n):
        if isinstance(n, jax.ShapeDtypeStruct):
            return True
        try:
            return jax.tree.structure(n) == pdef
        except Exception:
            return False

    return jax.tree.map(
        lambda n: rules if not isinstance(n, jax.ShapeDtypeStruct) else P(),
        shapes,
        is_leaf=is_node,
    )


def make_optax_train_step(
    cfg: tfm.TransformerConfig,
    mesh: Mesh,
    optimizer,
    params,
    *,
    clip_norm: float | None = None,
    data_axis: str = "data",
    model_axis: str = "model",
    interpret: bool | None = None,
    remat: bool = False,
):
    """DP x TP train step driven by an optax optimizer (e.g.
    optax.adamw(3e-4)). `params` is the (global, unsharded or abstract)
    param tree — needed to shape the optimizer state. The optimizer must
    be ELEMENTWISE over leaves (adam/sgd/schedules are): each device
    updates its weight shard with its own state shard. Global-norm
    clipping is NOT safe inside such an optimizer under TP (a local norm
    differs per shard and would desync the replicated leaves) — pass
    clip_norm here instead: the true global norm is assembled with a psum
    over the model axis (TP-sharded leaves) before scaling.

    Returns (init_fn(sharded_params) -> opt_state,
             step_fn(params, opt_state, tokens) -> (params, opt_state, loss),
             param_specs, opt_state_specs).
    """
    rules = tfm.param_shardings(cfg, data_axis=data_axis, model_axis=model_axis)

    def _is_tp(spec: P) -> bool:
        return model_axis in [ax for ax in spec if ax is not None]

    def _global_sq_norm(grads):
        # TP-sharded leaves: every chip owns a disjoint slice -> psum the
        # local square sums. Replicated leaves: identical on all chips
        # (post-pmean) -> count once.
        tp_sq = sum(
            jnp.sum(jnp.square(g.astype(jnp.float32)))
            for g, spec in zip(jax.tree.leaves(grads), jax.tree.leaves(rules))
            if _is_tp(spec)
        )
        rep_sq = sum(
            jnp.sum(jnp.square(g.astype(jnp.float32)))
            for g, spec in zip(jax.tree.leaves(grads), jax.tree.leaves(rules))
            if not _is_tp(spec)
        )
        return jax.lax.psum(tp_sq, model_axis) + rep_sq

    tp = mesh.shape[model_axis]

    def step(params, opt_state, tokens):
        loss, grads = jax.value_and_grad(
            functools.partial(
                _tp_loss, cfg, model_axis=model_axis, interpret=interpret,
                remat=remat,
            )
        )(params, tokens)
        grads = jax.tree.map(lambda g: jax.lax.pmean(g, data_axis), grads)
        loss = jax.lax.pmean(loss, data_axis)
        # see make_train_step: raw per-chip grads carry a tp factor from the
        # psum transpose — /tp for exclusively-owned shards, pmean for
        # replicated leaves
        grads = jax.tree.map(
            lambda g, spec: (
                g / tp if _is_tp(spec) else jax.lax.pmean(g, model_axis)
            ),
            grads,
            rules,
        )
        if clip_norm is not None:
            gnorm = jnp.sqrt(_global_sq_norm(grads))
            scale = jnp.minimum(1.0, clip_norm / jnp.maximum(gnorm, 1e-12))
            grads = jax.tree.map(lambda g: (g * scale).astype(g.dtype), grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree.map(
            lambda p, u: (p.astype(jnp.float32) + u.astype(jnp.float32))
            .astype(p.dtype),
            params,
            updates,
        )
        return params, opt_state, loss

    sspecs = _optimizer_state_specs(optimizer, params, rules)
    init_fn = jax.jit(shard_map(
        optimizer.init, mesh=mesh, in_specs=(rules,), out_specs=sspecs,
        check_vma=False,
    ))
    step_fn = jax.jit(shard_map(
        step, mesh=mesh,
        in_specs=(rules, sspecs, P(data_axis, None)),
        out_specs=(rules, sspecs, P()),
        check_vma=False,
    ))
    return init_fn, step_fn, rules, sspecs
