"""Pipeline parallelism: GPipe-style microbatching over a "pipe" mesh axis.

The reference has NO inter-device pipeline (SURVEY.md section 2.9) — its
nearest analog is the intra-kernel producer/consumer warp pipeline
(flashattn_streaming_16x16_mw_v5_warp_specialize.cu:75-275) and the
load(t)/compute(t-1) software pipeline (flashattn_forward_wmma_v5_cp_async
.cu:221-251). This module is the inter-device version of the same idea:
the layer stack is sharded over the `pipe` axis (each stage
owns a contiguous layer slab), microbatch activations rotate stage-to-stage
with `ppermute` (over the interconnect), and the whole schedule is one
`lax.scan` of
n_micro + n_stages - 1 ticks inside `shard_map` — every device runs the
identical program, XLA overlaps the permute with the next tick's compute.

Schedule (classic SPMD pipelining):
  tick t: stage 0 injects microbatch t (while t < n_micro); every stage runs
  its slab on whatever activation it holds; the last stage emits per-token
  NLL for microbatch t - (n_stages - 1); activations ppermute p -> p+1.
Bubble ticks compute on garbage and are masked out of the loss — the
standard SPMD trade of wasted FLOPs for a uniform program.

Backward is plain jax.grad through the scan + ppermute (the transpose of a
permute is the reverse permute), i.e. the 1F1B memory optimization is left
to rematerialization (`jax.checkpoint` on the slab) rather than hand
scheduling.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from flashattention_kernel_project_tpu.models import transformer as tfm


def _stage_forward(cfg, layers_slab, x, sin, cos, *, interpret, remat):
    """Run this stage's local layer slab on activations x [mb, n, d].
    Returns (x, slab-mean MoE aux loss) — aux is 0 for dense layers."""

    def body(x, layer):
        x = tfm._attention_block(cfg, layer, x, sin, cos, interpret=interpret)
        if "moe_w1" in layer:
            x, aux = tfm._moe_mlp_block(layer, x, cfg)
        else:
            x, aux = tfm._mlp_block(layer, x, cfg), jnp.float32(0.0)
        return x, aux

    if remat:
        body = jax.checkpoint(body)
    x, aux = jax.lax.scan(body, x, layers_slab)
    return x, jnp.mean(aux)


def pp_loss_fn(
    cfg,
    params,
    tokens,
    *,
    n_micro: int,
    pipe_axis: str = "pipe",
    interpret: bool | None = None,
    remat: bool = True,
):
    """Per-device body: next-token NLL of `tokens` [B, N] computed through
    the pipeline. Call under shard_map with params["layers"] sharded
    P(pipe_axis) on the stacked layer dim and everything else replicated."""
    n_stages = jax.lax.axis_size(pipe_axis)
    stage = jax.lax.axis_index(pipe_axis)
    b, n = tokens.shape
    assert b % n_micro == 0, (b, n_micro)
    mb = b // n_micro

    micro_tokens = tokens.reshape(n_micro, mb, n)
    positions = jnp.arange(n)[None, :]
    sin, cos = tfm.rope_tables(cfg, positions)
    ticks = n_micro + n_stages - 1

    def tick(x, t):
        # stage 0 injects the next microbatch (clamped index during drain)
        mb_idx = jnp.clip(t, 0, n_micro - 1)
        toks_in = micro_tokens[mb_idx]
        x = jnp.where(stage == 0, params["embed"][toks_in], x)
        y, aux = _stage_forward(
            cfg, params["layers"], x, sin, cos,
            interpret=interpret, remat=remat,
        )
        # this stage holds microbatch t - stage; bubble ticks run on
        # garbage, so their router-balance aux must not enter the loss
        aux = jnp.where(
            jnp.logical_and(t - stage >= 0, t - stage < n_micro), aux, 0.0
        )
        # last stage: head + per-microbatch NLL, valid once the pipe is full
        out_idx = t - (n_stages - 1)
        h = tfm.rms_norm(y, params["rms_final"])
        logits = jnp.matmul(h, params["embed"].T,
                            preferred_element_type=jnp.float32)
        tgt = micro_tokens[jnp.clip(out_idx, 0, n_micro - 1)][:, 1:]
        logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        nll = -jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
        valid = jnp.logical_and(stage == n_stages - 1, out_idx >= 0)
        nll_sum = jnp.where(valid, jnp.sum(nll), 0.0)
        cnt = jnp.where(valid, nll.size, 0)
        # rotate activations to the next stage (neighbour ring)
        perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
        x_next = jax.lax.ppermute(y, pipe_axis, perm)
        return x_next, (nll_sum, cnt, aux)

    x0 = jnp.zeros((mb, n, cfg.d_model), cfg.dtype)
    _, (nll_sums, cnts, auxs) = jax.lax.scan(tick, x0, jnp.arange(ticks))
    # total over ticks lives on the last stage only; share it
    total = jax.lax.psum(jnp.sum(nll_sums), pipe_axis)
    count = jax.lax.psum(jnp.sum(cnts), pipe_axis)
    # each stage's slab-mean aux over its n_micro valid ticks; sum over
    # stages of slab means = n_stages * layer mean -> normalize both out
    aux = jax.lax.psum(jnp.sum(auxs), pipe_axis) / (n_micro * n_stages)
    return total / count.astype(jnp.float32) + cfg.moe_aux_weight * aux


def pp_param_specs(pipe_axis: str = "pipe"):
    """PartitionSpecs: the stacked layer dim sharded over the pipe axis,
    embed/final-norm replicated (stage 0 reads embed, the last stage reads
    the head — replication trades memory for zero comm)."""
    return {
        "embed": P(),
        "rms_final": P(),
        "layers": {
            k: P(pipe_axis)
            for k in (
                "rms_attn", "rms_mlp", "wq", "wk", "wv", "wo",
                "w_gate", "w_up", "w_down",
            )
        },
    }


def make_pp_train_step(
    cfg: tfm.TransformerConfig,
    mesh: Mesh,
    *,
    n_micro: int = 4,
    lr: float = 1e-3,
    pipe_axis: str = "pipe",
    interpret: bool | None = None,
    remat: bool = True,
):
    """Jitted pipeline-parallel SGD step.

    Returns (step_fn(params, tokens) -> (new_params, loss), param_specs).
    cfg.n_layers must divide evenly by the pipe-axis size."""
    n_stages = mesh.shape[pipe_axis]
    assert cfg.n_layers % n_stages == 0, (cfg.n_layers, n_stages)
    specs = pp_param_specs(pipe_axis)

    def _is_pipe(spec: P) -> bool:
        return pipe_axis in [ax for ax in spec if ax is not None]

    def step(params, tokens):
        loss, grads = jax.value_and_grad(
            functools.partial(
                pp_loss_fn, cfg, n_micro=n_micro, pipe_axis=pipe_axis,
                interpret=interpret, remat=remat,
            )
        )(params, tokens)
        # psum's transpose is psum (check_vma=False): the loss's final
        # total/count psums hand every stage a cotangent scaled by
        # n_stages, so each chip's raw grad is n_stages * (its own
        # contribution). Replicated leaves (embed, final norm) need the
        # SUM of per-stage contributions -> pmean folds the factor away
        # while summing; pipe-sharded slabs are exclusively owned ->
        # divide the factor out.
        grads = jax.tree.map(
            lambda g, spec: (
                g / n_stages if _is_pipe(spec)
                else jax.lax.pmean(g, pipe_axis)
            ),
            grads,
            specs,
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
        in_specs=(specs, P()),
        out_specs=(specs, P()),
        check_vma=False,
    )
    return jax.jit(step_sm), specs
