"""Flagship model: GQA decoder-only transformer built on the attention ops.

The reference repo has no model layer (it is a kernel study); a quantized
attention-inference engine needs a model to serve. LLaMA-style: RMSNorm, RoPE,
grouped-query
attention through ops.flash_attention (train/prefill) and ops.flash_decode
(serving), SwiGLU MLP, tied embeddings.

Pure-functional design: params are a pytree of jnp arrays; `forward`,
`loss_fn`, `train_step` are jittable/pjit-able; `param_shardings` gives the
megatron-style tensor-parallel layout over a ("data", "model") mesh.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from flashattention_kernel_project_tpu.ops.flash_attention import flash_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 1024
    n_layers: int = 8
    n_heads: int = 16
    n_kv_heads: int = 4
    d_head: int = 64
    d_ff: int = 2816
    rope_theta: float = 10000.0
    dtype: Any = jnp.bfloat16
    # sliding-window attention (Mistral-style): each token attends its
    # attn_window most recent tokens; None = full causal. Honored by the
    # fused forward/backward, the ragged chunked-prefill kernel, and the
    # decode kernels (out-of-window KV blocks/splits are skipped, so both
    # prefill and decode cost O(window) per token).
    attn_window: int | None = None
    # with attn_window: keep the first attn_sinks tokens always visible
    # (StreamingLLM attention sinks)
    attn_sinks: int = 0
    # Mixture-of-Experts MLP (models/moe.py): moe_experts > 0 replaces every
    # layer's SwiGLU with a top-k routed expert MLP (GShard dense dispatch —
    # one-hot einsums, static capacity). Experts ride the model axis in
    # param_shardings, so TP meshes get expert parallelism via GSPMD with no
    # code change. 0 = dense (default, the flagship serving config).
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head


def init_params(cfg: TransformerConfig, key: jax.Array) -> dict:
    """Scaled-normal init; weights stored in cfg.dtype."""
    keys = jax.random.split(key, cfg.n_layers + 2)

    def dense(k, shape, scale=None):
        scale = scale or (shape[0] ** -0.5)
        return (jax.random.normal(k, shape, jnp.float32) * scale).astype(cfg.dtype)

    layers = []
    for i in range(cfg.n_layers):
        lk = jax.random.split(keys[i], 7)
        layer = dict(
            wq=dense(lk[0], (cfg.d_model, cfg.q_dim)),
            wk=dense(lk[1], (cfg.d_model, cfg.kv_dim)),
            wv=dense(lk[2], (cfg.d_model, cfg.kv_dim)),
            wo=dense(lk[3], (cfg.q_dim, cfg.d_model)),
            rms_attn=jnp.ones((cfg.d_model,), jnp.float32),
            rms_mlp=jnp.ones((cfg.d_model,), jnp.float32),
        )
        if cfg.moe_experts:
            e = cfg.moe_experts
            layer.update(
                # router stays fp32: routing decisions are argmaxes over
                # near-ties, bf16 quantization would flip them
                moe_router=(jax.random.normal(
                    lk[4], (cfg.d_model, e), jnp.float32) * cfg.d_model**-0.5),
                # fan-in scales: dense()'s shape[0]**-0.5 default would use
                # num_experts as fan-in for these 3-D weights
                moe_w1=dense(lk[5], (e, cfg.d_model, cfg.d_ff),
                             scale=cfg.d_model**-0.5),
                moe_w2=dense(lk[6], (e, cfg.d_ff, cfg.d_model),
                             scale=cfg.d_ff**-0.5),
            )
        else:
            layer.update(
                w_gate=dense(lk[4], (cfg.d_model, cfg.d_ff)),
                w_up=dense(lk[5], (cfg.d_model, cfg.d_ff)),
                w_down=dense(lk[6], (cfg.d_ff, cfg.d_model)),
            )
        layers.append(layer)
    return dict(
        embed=dense(keys[-2], (cfg.vocab_size, cfg.d_model), scale=0.02),
        rms_final=jnp.ones((cfg.d_model,), jnp.float32),
        layers=_stack_layers(layers),
    )


def _stack_layers(layers: list[dict]) -> dict:
    """Stack per-layer dicts into leading-axis arrays (scan-friendly)."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *layers)


def param_shardings(cfg: TransformerConfig, data_axis="data", model_axis="model"):
    """Megatron TP layout: qkv/gate/up column-sharded, o/down row-sharded."""
    layer = dict(
        wq=P(None, None, model_axis),
        wk=P(None, None, model_axis),
        wv=P(None, None, model_axis),
        wo=P(None, model_axis, None),
        rms_attn=P(None, None),
        rms_mlp=P(None, None),
    )
    if cfg.moe_experts:
        # expert parallelism: the expert dim rides the model axis; GSPMD
        # shards the dispatch/combine einsums and inserts the psum
        layer.update(
            moe_router=P(None, None, None),
            moe_w1=P(None, model_axis, None, None),
            moe_w2=P(None, model_axis, None, None),
        )
    else:
        layer.update(
            w_gate=P(None, None, model_axis),
            w_up=P(None, None, model_axis),
            w_down=P(None, model_axis, None),
        )
    return dict(
        embed=P(None, None),
        rms_final=P(None),
        layers=layer,
    )


def rms_norm(x: jax.Array, w: jax.Array, eps: float = 1e-6) -> jax.Array:
    x32 = x.astype(jnp.float32)
    var = jnp.mean(x32 * x32, axis=-1, keepdims=True)
    return (x32 * jax.lax.rsqrt(var + eps) * w).astype(x.dtype)


def rope_tables(cfg: TransformerConfig, positions: jax.Array):
    """positions [..., N] -> (sin, cos) [..., N, d_head/2] fp32."""
    half = cfg.d_head // 2
    freqs = cfg.rope_theta ** (-jnp.arange(0, half, dtype=jnp.float32) / half)
    angles = positions[..., None].astype(jnp.float32) * freqs
    return jnp.sin(angles), jnp.cos(angles)


def apply_rope(x: jax.Array, sin: jax.Array, cos: jax.Array) -> jax.Array:
    """x [..., N, H, d_head]; sin/cos broadcastable to [..., N, 1, d_head/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    x32_1, x32_2 = x1.astype(jnp.float32), x2.astype(jnp.float32)
    return jnp.concatenate(
        [x32_1 * cos - x32_2 * sin, x32_2 * cos + x32_1 * sin], axis=-1
    ).astype(x.dtype)


def _attention_block(cfg, layer, x, sin, cos, *, interpret=None):
    b, n, _ = x.shape
    h = rms_norm(x, layer["rms_attn"])
    q = (h @ layer["wq"]).reshape(b, n, cfg.n_heads, cfg.d_head)
    k = (h @ layer["wk"]).reshape(b, n, cfg.n_kv_heads, cfg.d_head)
    v = (h @ layer["wv"]).reshape(b, n, cfg.n_kv_heads, cfg.d_head)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    o = flash_attention(
        q.transpose(0, 2, 1, 3),
        k.transpose(0, 2, 1, 3),
        v.transpose(0, 2, 1, 3),
        causal=True,
        interpret=interpret,
        window=cfg.attn_window,
        sinks=cfg.attn_sinks,
    )
    o = o.transpose(0, 2, 1, 3).reshape(b, n, cfg.q_dim)
    return x + o @ layer["wo"]


def _moe_mlp_block(layer, x, cfg=None):
    """MoE MLP residual block -> (out, aux_loss). Routing math lives in
    models/moe.py (dense dispatch); hyperparams come from cfg when given,
    else MoEConfig defaults (top_k=2, capacity 1.25) — keep cfg threaded in
    training so capacity semantics match at serve time."""
    from flashattention_kernel_project_tpu.models import moe as _moe

    top_k = cfg.moe_top_k if cfg is not None else 2
    cap_f = cfg.moe_capacity_factor if cfg is not None else 1.25
    h = rms_norm(x, layer["rms_mlp"])
    h2 = h.reshape(-1, h.shape[-1]).astype(jnp.float32)
    t, e = h2.shape[0], layer["moe_w1"].shape[0]
    d_model = h2.shape[-1]
    probs = jax.nn.softmax(h2 @ layer["moe_router"], axis=-1)
    cap = _moe.MoEConfig(num_experts=e, top_k=top_k,
                         capacity_factor=cap_f).capacity(t)
    w1 = layer["moe_w1"].astype(jnp.float32)
    w2 = layer["moe_w2"].astype(jnp.float32)
    if _moe._use_sort_dispatch("auto", t, e, cap):
        # sort-based ragged dispatch: the dense
        # [T, E, C] one-hot pair is 2x671 MB at b4/seq2048/E8 — the r3
        # train_moe8 bench OOM; same routing and drops (models/moe.py)
        slot_token, slot_tk, gates, aux = _moe._top_k_dispatch_sort(
            probs, top_k, cap)
        h2p = jnp.concatenate([h2, jnp.zeros((1, d_model), h2.dtype)])
        expert_in = h2p[slot_token[:-1]].reshape(e, cap, d_model)
        expert_out = _moe._expert_ffn(w1, w2, expert_in)
        eo = jnp.concatenate([
            expert_out.reshape(-1, d_model),
            jnp.zeros((1, d_model), expert_out.dtype),
        ])
        out = sum(
            gates[:, j, None] * eo[slot_tk[:, j]] for j in range(top_k)
        )
    else:
        dispatch, combine, aux = _moe._top_k_dispatch(probs, top_k, cap)
        expert_in = jnp.einsum("tec,td->ecd", dispatch, h2,
                               preferred_element_type=jnp.float32)
        expert_out = _moe._expert_ffn(w1, w2, expert_in)
        out = jnp.einsum("tec,ecd->td", combine, expert_out,
                         preferred_element_type=jnp.float32)
    return x + out.reshape(x.shape).astype(x.dtype), aux


def _mlp_block(layer, x, cfg=None):
    if "moe_w1" in layer:
        return _moe_mlp_block(layer, x, cfg)[0]
    h = rms_norm(x, layer["rms_mlp"])
    gated = jax.nn.silu(h @ layer["w_gate"]) * (h @ layer["w_up"])
    return x + gated @ layer["w_down"]


def forward(
    cfg: TransformerConfig,
    params: dict,
    tokens: jax.Array,
    *,
    interpret: bool | None = None,
) -> jax.Array:
    """tokens [B, N] int32 -> logits [B, N, vocab] fp32 (causal LM)."""
    return _forward_aux(cfg, params, tokens, interpret=interpret)[0]


def _forward_aux(cfg, params, tokens, *, interpret=None):
    """forward + mean MoE load-balancing aux loss (0.0 for dense cfgs)."""
    b, n = tokens.shape
    x = params["embed"][tokens]
    positions = jnp.arange(n)[None, :]
    sin, cos = rope_tables(cfg, positions)

    def body(x, layer):
        x = _attention_block(cfg, layer, x, sin, cos, interpret=interpret)
        if cfg.moe_experts:
            # rematerialized: the expert hidden ([E, C, d_ff] f32 per
            # layer, ~450 MB at b4/seq2048/E8) dominated training HBM —
            # recompute it in the backward instead of saving it
            # (the last 1.3 GB of the r3 OOM after
            # the sort dispatch removed the dense one-hots)
            x, aux = jax.checkpoint(
                lambda lyr, xx: _moe_mlp_block(lyr, xx, cfg)
            )(layer, x)
        else:
            x, aux = _mlp_block(layer, x), jnp.float32(0.0)
        return x, aux

    x, aux = jax.lax.scan(body, x, params["layers"])
    x = rms_norm(x, params["rms_final"])
    return jnp.matmul(x, params["embed"].T,
                      preferred_element_type=jnp.float32), jnp.mean(aux)


def loss_fn(cfg, params, tokens, *, interpret=None) -> jax.Array:
    """Next-token cross-entropy (mean over all positions); MoE configs add
    cfg.moe_aux_weight x the mean load-balancing loss (Switch eq. 4)."""
    logits, aux = _forward_aux(cfg, params, tokens, interpret=interpret)
    targets = tokens[:, 1:]
    logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    return jnp.mean(nll) + cfg.moe_aux_weight * aux


def sgd_train_step(cfg, params, tokens, lr=1e-3, *, interpret=None):
    """Minimal full training step (fwd + bwd + update) — the jittable unit
    the multi-chip dryrun shards. Optimizer-agnostic callers can use
    jax.grad(loss_fn) directly with optax."""
    loss, grads = jax.value_and_grad(
        lambda p: loss_fn(cfg, p, tokens, interpret=interpret)
    )(params)
    new_params = jax.tree.map(
        lambda p, g: (p.astype(jnp.float32) - lr * g.astype(jnp.float32)).astype(
            p.dtype
        ),
        params,
        grads,
    )
    return new_params, loss
