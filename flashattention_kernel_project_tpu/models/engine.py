"""Inference engine: KV-cache management, prefill, decode, generation.

The serving layer around the kernels: slot-based batch of sequences, bf16 or
INT8 KV cache (per-token
scales), prefill through the fused flash-attention kernel, decode through
the split-KV kernel, greedy/temperature sampling. The decode shapes are
exactly the reference's streaming-kernel problem (SURVEY.md section 2.6).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from flashattention_kernel_project_tpu.models import transformer as tfm
from flashattention_kernel_project_tpu.ops.flash_attention import flash_attention
from flashattention_kernel_project_tpu.ops.flash_decode import (
    flash_decode,
    flash_decode_int8,
)
from flashattention_kernel_project_tpu.ops.quant import quantize_int8


class KVCache(NamedTuple):
    """KV cache as PER-LAYER tuples of arrays.

    k, v: tuple of L arrays [B, Hkv, S_max, D] (cfg dtype / int8 quantized)
    k_scale, v_scale: tuple of L arrays [B, Hkv, S_max, 1] f32 (or None)
    lengths: [B] int32 — valid tokens per slot

    Per-layer buffers (not one stacked [L, ...] array) so a single layer's
    token append never touches the other layers: with a stacked array,
    `cache.k.at[i].set(...)` gathers + rewrites the WHOLE cache each decode
    step (measured 0.53 ms/step of pure copy at 4x8x2304 — the largest
    single cost in the decode loop); with tuples XLA donates each layer
    buffer through the loop carry and the append is just the scatter.
    """

    k: tuple
    v: tuple
    k_scale: tuple | None
    v_scale: tuple | None
    lengths: jax.Array

    @property
    def quantized(self) -> bool:
        # any 8-bit cache (int8 or fp8_e4m3); both carry per-token scales
        return jnp.dtype(self.k[0].dtype).itemsize == 1


def init_cache(
    cfg: tfm.TransformerConfig,
    batch: int,
    max_len: int,
    *,
    quantized: bool = False,
    quant_fmt: str = "int8",
) -> KVCache:
    """Allocate a linear KV cache. quantized=True stores 8-bit values
    (quant_fmt: "int8" or "fp8") + per-token scales: choose it for CAPACITY
    (half the cache memory -> 2x batch or context at fixed memory), not
    latency: the append quantizes and writes 4 buffers/layer vs 2. Pair
    with quantize_decode_params for weights."""
    shape = (batch, cfg.n_kv_heads, max_len, cfg.d_head)
    L = cfg.n_layers
    if quantized:
        assert quant_fmt in ("int8", "fp8"), quant_fmt
        qdt = jnp.int8 if quant_fmt == "int8" else jnp.float8_e4m3fn
        return KVCache(
            k=tuple(jnp.zeros(shape, qdt) for _ in range(L)),
            v=tuple(jnp.zeros(shape, qdt) for _ in range(L)),
            k_scale=tuple(
                jnp.zeros(shape[:-1] + (1,), jnp.float32) for _ in range(L)
            ),
            v_scale=tuple(
                jnp.zeros(shape[:-1] + (1,), jnp.float32) for _ in range(L)
            ),
            lengths=jnp.zeros((batch,), jnp.int32),
        )
    return KVCache(
        k=tuple(jnp.zeros(shape, cfg.dtype) for _ in range(L)),
        v=tuple(jnp.zeros(shape, cfg.dtype) for _ in range(L)),
        k_scale=None,
        v_scale=None,
        lengths=jnp.zeros((batch,), jnp.int32),
    )


def _write_tokens(cache_layer, new, lengths):
    """Insert new[B, Hkv, T, D] at per-slot positions `lengths` into
    cache_layer[B, Hkv, S, D]."""

    def one(slot_cache, slot_new, pos):
        return jax.lax.dynamic_update_slice(slot_cache, slot_new, (0, pos, 0))

    return jax.vmap(one)(cache_layer, new, lengths)


def _set_layer(layers: tuple, i: int, val) -> tuple:
    return layers[:i] + (val,) + layers[i + 1 :]


def _quantize_and_write(cache: KVCache, layer_idx, k_new, v_new, lengths):
    """Write new KV (quantizing if the cache is int8). Returns the updated
    per-layer k/v (+scale) tuples; only layer_idx's buffer is touched."""
    if cache.quantized:
        from flashattention_kernel_project_tpu.ops.quant import (
            quantize_fp8_tokenwise,
        )

        quantizer = (
            quantize_int8 if cache.k[0].dtype == jnp.int8
            else quantize_fp8_tokenwise
        )
        k_q, k_s = quantizer(k_new, axis=-1)
        v_q, v_s = quantizer(v_new, axis=-1)
        return (
            _set_layer(
                cache.k, layer_idx,
                _write_tokens(cache.k[layer_idx], k_q, lengths),
            ),
            _set_layer(
                cache.v, layer_idx,
                _write_tokens(cache.v[layer_idx], v_q, lengths),
            ),
            _set_layer(
                cache.k_scale, layer_idx,
                _write_tokens(cache.k_scale[layer_idx], k_s, lengths),
            ),
            _set_layer(
                cache.v_scale, layer_idx,
                _write_tokens(cache.v_scale[layer_idx], v_s, lengths),
            ),
        )
    dt = cache.k[layer_idx].dtype
    return (
        _set_layer(
            cache.k, layer_idx,
            _write_tokens(cache.k[layer_idx], k_new.astype(dt), lengths),
        ),
        _set_layer(
            cache.v, layer_idx,
            _write_tokens(cache.v[layer_idx], v_new.astype(dt), lengths),
        ),
        cache.k_scale,
        cache.v_scale,
    )


@functools.partial(
    jax.jit, static_argnums=(0,), static_argnames=("interpret", "axis")
)
def prefill(
    cfg: tfm.TransformerConfig,
    params: dict,
    tokens: jax.Array,
    cache: KVCache,
    *,
    interpret: bool | None = None,
    axis: str | None = None,
) -> tuple[jax.Array, KVCache]:
    """Run the prompt through the model, filling the cache at each slot's
    current length. tokens [B, T]. Returns (last-position logits, cache).

    Assumes the prefilled slots are empty (lengths[b] == 0): the fused
    attention here only attends within the prompt. (Chunked prefill against
    existing cache content is a Scheduler-level flow, not yet wired.)

    axis: tensor-parallel mesh axis (see decode_step)."""
    b, t = tokens.shape
    x = params["embed"][tokens]
    positions = cache.lengths[:, None] + jnp.arange(t)[None, :]
    sin, cos = tfm.rope_tables(cfg, positions)

    k_all, v_all, ks_all, vs_all = cache.k, cache.v, cache.k_scale, cache.v_scale
    for i in range(cfg.n_layers):
        layer = jax.tree.map(lambda p: p[i], params["layers"])
        h = tfm.rms_norm(x, layer["rms_attn"])
        q = (h @ layer["wq"]).reshape(b, t, cfg.n_heads, cfg.d_head)
        k = (h @ layer["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.d_head)
        v = (h @ layer["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.d_head)
        q = tfm.apply_rope(q, sin, cos)
        k = tfm.apply_rope(k, sin, cos)

        # assumes equal lengths at prefill time (slots prefill together);
        # ragged prompts enter via per-slot insert in the Scheduler.
        o = flash_attention(
            q.transpose(0, 2, 1, 3),
            k.transpose(0, 2, 1, 3),
            v.transpose(0, 2, 1, 3),
            causal=True,
            interpret=interpret,
            window=cfg.attn_window,
            sinks=cfg.attn_sinks,
        )
        x = x + _psum(
            o.transpose(0, 2, 1, 3).reshape(b, t, cfg.q_dim) @ layer["wo"],
            axis,
        )
        x = _mlp(layer, x, axis, cfg)

        cache_view = KVCache(k_all, v_all, ks_all, vs_all, cache.lengths)
        k_all, v_all, ks_all, vs_all = _quantize_and_write(
            cache_view, i, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3),
            cache.lengths,
        )

    x = tfm.rms_norm(x, params["rms_final"])
    logits = jnp.matmul(x[:, -1], params["embed"].T,
                        preferred_element_type=jnp.float32)
    new_cache = KVCache(k_all, v_all, ks_all, vs_all, cache.lengths + t)
    return logits, new_cache


@functools.partial(
    jax.jit,
    static_argnums=(0,),
    static_argnames=("interpret", "all_logits", "axis"),
)
def extend(
    cfg: tfm.TransformerConfig,
    params: dict,
    tokens: jax.Array,
    cache: KVCache,
    *,
    n: jax.Array | None = None,
    interpret: bool | None = None,
    all_logits: bool = False,
    axis: str | None = None,
) -> tuple[jax.Array, KVCache]:
    """Chunked prefill: append T tokens per slot to a LIVE cache and attend
    to the full prefix (per-slot lengths + offsets via the ragged kernel).
    tokens [B, T]. Returns (last-position logits [B, V] — or every
    position's [B, T, V] with all_logits=True, the speculative-decoding
    verify path — and the cache).

    n [B] (optional) makes the chunk itself ragged: slot b appends only
    its first n[b] tokens (1 <= n[b] <= T; pad the rest). Lengths advance
    by n, the per-slot kv-length bound keeps the padded tail's KV
    invisible (it is overwritten by later appends before the bound ever
    reaches it), and the returned logits are gathered at each slot's true
    last position n[b]-1 — so a bucketed/padded chunk still yields EXACT
    logits. The caller must leave T-1 slack rows per slot (the padded
    tail is still written): cache max_len >= lengths + T.

    Int8 caches attend via the fused-dequant ragged kernel — the 8-bit
    prefix stream never materializes in full precision in HBM.
    """
    from flashattention_kernel_project_tpu.ops.flash_attention import (
        flash_attention_ragged,
        flash_attention_ragged_kv_quant,
    )

    b, t = tokens.shape
    x = params["embed"][tokens]
    positions = cache.lengths[:, None] + jnp.arange(t)[None, :]
    sin, cos = tfm.rope_tables(cfg, positions)

    k_all, v_all, ks_all, vs_all = cache.k, cache.v, cache.k_scale, cache.v_scale
    new_lengths = cache.lengths + (t if n is None else n)
    for i in range(cfg.n_layers):
        layer = jax.tree.map(lambda p: p[i], params["layers"])
        h = tfm.rms_norm(x, layer["rms_attn"])
        q = (h @ layer["wq"]).reshape(b, t, cfg.n_heads, cfg.d_head)
        k = (h @ layer["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.d_head)
        v = (h @ layer["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.d_head)
        q = tfm.apply_rope(q, sin, cos)
        k = tfm.apply_rope(k, sin, cos)

        cache_view = KVCache(k_all, v_all, ks_all, vs_all, cache.lengths)
        k_all, v_all, ks_all, vs_all = _quantize_and_write(
            cache_view, i, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3),
            cache.lengths,
        )
        qh = q.transpose(0, 2, 1, 3).astype(cfg.dtype)
        ragged_kw = dict(
            causal=True,
            interpret=interpret,
            window=cfg.attn_window,
            sinks=cfg.attn_sinks,
        )
        if cache.quantized:
            o = flash_attention_ragged_kv_quant(
                qh, k_all[i], ks_all[i], v_all[i], vs_all[i],
                new_lengths, cache.lengths, **ragged_kw,
            )
        else:
            o = flash_attention_ragged(
                qh, k_all[i], v_all[i], new_lengths, cache.lengths,
                **ragged_kw,
            )
        x = x + _psum(
            o.transpose(0, 2, 1, 3).reshape(b, t, cfg.q_dim) @ layer["wo"],
            axis,
        )
        x = _mlp(layer, x, axis, cfg)

    x = tfm.rms_norm(x, params["rms_final"])
    if all_logits:
        xe = x
    elif n is None:
        xe = x[:, -1]
    else:
        xe = x[jnp.arange(b), jnp.maximum(n, 1) - 1]
    logits = jnp.matmul(xe, params["embed"].T,
                        preferred_element_type=jnp.float32)
    return logits, KVCache(k_all, v_all, ks_all, vs_all, new_lengths)


def fuse_decode_params(cfg: tfm.TransformerConfig, params: dict) -> dict:
    """One-time param transform for the decode loop: concatenate the QKV
    projections into one [D, q+2kv] matrix and gate/up into one [D, 2F].
    At decode batch sizes the layer matmuls are weight-streaming-bound
    (M ~ 8 rows), so 7 weight passes -> 5 per layer. decode_step uses the
    fused path when it sees "wqkv"; prefill/training keep the split layout
    (it is what param_shardings / checkpoints describe)."""
    L = params["layers"]
    fused_layers = {
        "rms_attn": L["rms_attn"],
        "rms_mlp": L["rms_mlp"],
        "wo": L["wo"],
        "w_down": L["w_down"],
        "wqkv": jnp.concatenate([L["wq"], L["wk"], L["wv"]], axis=-1),
        "w_gate_up": jnp.concatenate([L["w_gate"], L["w_up"]], axis=-1),
    }
    return {
        "embed": params["embed"],
        "rms_final": params["rms_final"],
        "layers": fused_layers,
    }


def quantize_decode_params(
    cfg: tfm.TransformerConfig, params: dict, fmt: str = "int8"
) -> dict:
    """8-bit weight-only decode params (apply AFTER fuse_decode_params).

    Decode at small batch is weight-streaming-bound (the whole layer weight
    crosses HBM per step for ~8 activation rows), so 8-bit storage halves
    the dominant bandwidth term; dequant happens in the matmul epilogue
    (the s8/f8 -> bf16 convert fuses into the operand read), never in HBM.
    fmt: "int8" (symmetric absmax) or "fp8" (e4m3 + scale headroom) —
    same layout, per-output-column scales either way. Embedding/logits and
    the tiny RMS vectors stay at full precision.
    """
    from flashattention_kernel_project_tpu.ops.quant import (
        quantize_fp8_tokenwise,
    )

    assert fmt in ("int8", "fp8"), fmt
    quantizer = quantize_int8 if fmt == "int8" else quantize_fp8_tokenwise
    L = params["layers"]
    qlayers = {"rms_attn": L["rms_attn"], "rms_mlp": L["rms_mlp"]}
    for name in ("wqkv", "wo", "w_gate_up", "w_down"):
        w = L[name]  # [layers, K, N]
        w_q, w_s = jax.vmap(lambda wi: quantizer(wi, axis=0))(w)
        qlayers[name + "_q"] = w_q
        qlayers[name + "_s"] = w_s  # [layers, 1, N] f32
    # lm_head (x @ embed.T) is the single largest weight stream of a decode
    # step (vocab x d_model); per-vocab-row scales. The embedding GATHER
    # keeps the full-precision table (it reads one row per token, not the
    # whole matrix — quantizing it would save nothing and cost accuracy).
    head_q, head_s = quantizer(params["embed"], axis=-1)
    return {
        "embed": params["embed"],
        "lm_head_q": head_q,            # [vocab, d] int8
        "lm_head_s": head_s,            # [vocab, 1] f32
        "rms_final": params["rms_final"],
        "layers": qlayers,
    }


def _proj(x, layer, name, out_dtype):
    """x [B, T, K] @ layer weight `name` -> [B, T, N].

    int8 weights run as `x @ w_q.astype(bf16) * scale`, relying on XLA to
    fuse the s8->bf16 convert into the matmul's operand read so the weight
    streams in 8 bits (whether it does on the card is not measured yet)."""
    if name + "_q" in layer:
        o = jax.lax.dot_general(
            x,
            layer[name + "_q"].astype(x.dtype),
            (((x.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return (o * layer[name + "_s"]).astype(out_dtype)
    return x @ layer[name]


def _lm_head(params, x):
    """Logits projection x [B, D] -> [B, vocab] (int8 head when present)."""
    if "lm_head_q" in params:
        o = jax.lax.dot_general(
            x,
            params["lm_head_q"].astype(x.dtype),
            (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return o * params["lm_head_s"][:, 0][None, :]
    # f32 accumulate and output (no bf16 rounding of the logits): keeps
    # greedy argmax identical between the decode and extend/verify paths,
    # where bf16-rounded logits flip near-tie argmaxes
    return jnp.matmul(x, params["embed"].T,
                      preferred_element_type=jnp.float32)


def _qkv(cfg, layer, h, b, t):
    """Project h -> (q, k, v) with either the fused or the split weights."""
    if "wqkv" in layer or "wqkv_q" in layer:
        qd, kvd = cfg.q_dim, cfg.kv_dim
        qkv = _proj(h, layer, "wqkv", h.dtype)
        q = qkv[..., :qd].reshape(b, t, cfg.n_heads, cfg.d_head)
        k = qkv[..., qd : qd + kvd].reshape(b, t, cfg.n_kv_heads, cfg.d_head)
        v = qkv[..., qd + kvd :].reshape(b, t, cfg.n_kv_heads, cfg.d_head)
        return q, k, v
    q = (h @ layer["wq"]).reshape(b, t, cfg.n_heads, cfg.d_head)
    k = (h @ layer["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.d_head)
    v = (h @ layer["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.d_head)
    return q, k, v


def _psum(t, axis: str | None):
    """psum over the tensor-parallel axis (no-op outside shard_map)."""
    return jax.lax.psum(t, axis) if axis else t


def _mlp(layer, x, axis: str | None = None, cfg=None):
    if "w_gate_up" in layer or "w_gate_up_q" in layer:
        h = tfm.rms_norm(x, layer["rms_mlp"])
        gu = _proj(h, layer, "w_gate_up", x.dtype)
        f = gu.shape[-1] // 2
        gated = jax.nn.silu(gu[..., :f]) * gu[..., f:]
        return x + _psum(_proj(gated, layer, "w_down", x.dtype), axis)
    if axis:
        # split layout under TP: w_gate/w_up column-sharded, w_down
        # row-parallel -> the partial sum is reduced here
        h2 = tfm.rms_norm(x, layer["rms_mlp"])
        gated = jax.nn.silu(h2 @ layer["w_gate"]) * (h2 @ layer["w_up"])
        return x + _psum(gated @ layer["w_down"], axis)
    # MoE routing hyperparams (top_k, capacity) come from cfg so a model
    # trained with non-default values serves with the same dispatch
    return tfm._mlp_block(layer, x, cfg)


@functools.partial(
    jax.jit,
    static_argnums=(0,),
    static_argnames=("n_splits", "interpret", "axis"),
)
def decode_step(
    cfg: tfm.TransformerConfig,
    params: dict,
    tokens: jax.Array,
    cache: KVCache,
    *,
    n_splits: int | None = None,
    interpret: bool | None = None,
    axis: str | None = None,
) -> tuple[jax.Array, KVCache]:
    """One decode step: tokens [B] -> (logits [B, vocab], updated cache).

    axis: tensor-parallel mesh axis when called inside shard_map with
    column/row-sharded weights and a head-sharded cache (cfg must then be
    the LOCAL config — heads and d_ff divided by the axis size); inserts
    the two megatron psums (after wo and w_down) per layer."""
    b = tokens.shape[0]
    x = params["embed"][tokens][:, None]  # [B, 1, D]
    sin, cos = tfm.rope_tables(cfg, cache.lengths[:, None])

    k_all, v_all, ks_all, vs_all = cache.k, cache.v, cache.k_scale, cache.v_scale
    new_lengths = cache.lengths + 1
    for i in range(cfg.n_layers):
        layer = jax.tree.map(lambda p: p[i], params["layers"])
        h = tfm.rms_norm(x, layer["rms_attn"])
        q, k, v = _qkv(cfg, layer, h, b, 1)
        q = tfm.apply_rope(q, sin, cos)
        k = tfm.apply_rope(k, sin, cos)

        cache_view = KVCache(k_all, v_all, ks_all, vs_all, cache.lengths)
        k_all, v_all, ks_all, vs_all = _quantize_and_write(
            cache_view, i, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3),
            cache.lengths,
        )

        q_dec = q.reshape(b, cfg.n_heads, cfg.d_head)
        if cache.quantized:
            o = flash_decode_int8(
                q_dec.astype(cfg.dtype),
                k_all[i], ks_all[i], v_all[i], vs_all[i],
                new_lengths, n_splits=n_splits, interpret=interpret,
                window=cfg.attn_window, sinks=cfg.attn_sinks,
            )
        else:
            o = flash_decode(
                q_dec.astype(cfg.dtype), k_all[i], v_all[i],
                new_lengths, n_splits=n_splits, interpret=interpret,
                window=cfg.attn_window, sinks=cfg.attn_sinks,
            )
        x = x + _psum(
            _proj(o.reshape(b, 1, cfg.q_dim), layer, "wo", x.dtype), axis
        )
        x = _mlp(layer, x, axis, cfg)

    x = tfm.rms_norm(x, params["rms_final"])
    logits = _lm_head(params, x[:, 0])
    return logits, KVCache(k_all, v_all, ks_all, vs_all, new_lengths)


@functools.partial(
    jax.jit,
    static_argnums=(0,),
    static_argnames=(
        "n_steps", "n_splits", "interpret", "axis",
        "temperature", "top_k", "top_p", "step0",
    ),
)
def decode_steps(
    cfg: tfm.TransformerConfig,
    params: dict,
    tokens: jax.Array,
    cache: KVCache,
    *,
    n_steps: int,
    n_splits: int | None = None,
    interpret: bool | None = None,
    axis: str | None = None,
    temperature: float = 0.0,
    key: jax.Array | None = None,
    top_k: int | None = None,
    top_p: float | None = None,
    step0: int = 0,
) -> tuple[jax.Array, KVCache]:
    """n_steps decode steps as ONE device-resident lax.scan program:
    tokens [B] -> ([B, n_steps] tokens, cache advanced n_steps). Greedy by
    default; temperature + key samples inside the scan (each step folds in
    step0 + i, matching the per-step loop's stream exactly).

    One dispatch instead of n_steps — the host round trip leaves the
    per-token critical path entirely; the
    scheduler's multi_step mode trades up to n_steps-1 wasted steps at
    EOS/budget for it."""

    def body(carry, i):
        cur, c = carry
        logits, c = decode_step(
            cfg, params, cur, c,
            n_splits=n_splits, interpret=interpret, axis=axis,
        )
        nxt = _sample(logits, temperature, key, i, top_k, top_p)
        return (nxt, c), nxt

    (_, cache), toks = jax.lax.scan(
        body, (tokens.astype(jnp.int32), cache),
        step0 + jnp.arange(n_steps),
    )
    return toks.swapaxes(0, 1), cache


@functools.partial(
    jax.jit,
    static_argnums=(0,),
    static_argnames=(
        # step0 is TRACED (it feeds `step0 + jnp.arange`): the scheduler
        # advances it every sampled window, and a static step0 would
        # recompile per round
        "n_steps", "interpret", "axis",
        "temperature", "top_k", "top_p",
    ),
)
def decode_steps_paged(
    cfg: tfm.TransformerConfig,
    params: dict,
    tokens: jax.Array,
    cache: PagedKVCache,
    *,
    n_steps: int,
    interpret: bool | None = None,
    axis: str | None = None,
    temperature: float = 0.0,
    key: jax.Array | None = None,
    top_k: int | None = None,
    top_p: float | None = None,
    step0: int = 0,
) -> tuple[jax.Array, PagedKVCache]:
    """decode_steps against the PAGED cache: n_steps greedy/sampled steps
    as one device-resident lax.scan (decode_step_paged + paged_append per
    step inside the scan) — the paged backend gets the same
    one-dispatch-per-window amortization as the linear one
    (Scheduler(paged=True, multi_step=N)). tokens [B] ->
    ([B, n_steps], cache advanced n_steps)."""

    def body(carry, i):
        cur, c = carry
        logits, c = decode_step_paged(
            cfg, params, cur, c, interpret=interpret, axis=axis,
        )
        nxt = _sample(logits, temperature, key, i, top_k, top_p)
        return (nxt, c), nxt

    (_, cache), toks = jax.lax.scan(
        body, (tokens.astype(jnp.int32), cache),
        step0 + jnp.arange(n_steps),
    )
    return toks.swapaxes(0, 1), cache


def generate(
    cfg: tfm.TransformerConfig,
    params: dict,
    prompt: jax.Array,
    *,
    max_new_tokens: int = 32,
    max_len: int | None = None,
    quantized_cache: bool = False,
    quant_fmt: str = "int8",
    int8_weights: bool = False,
    n_splits: int | None = None,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
    key: jax.Array | None = None,
    interpret: bool | None = None,
) -> jax.Array:
    """Greedy (or temperature) generation. prompt [B, T] -> [B, T + new]."""
    b, t = prompt.shape
    max_len = max_len or (t + max_new_tokens)
    cache = init_cache(
        cfg, b, max_len, quantized=quantized_cache, quant_fmt=quant_fmt
    )
    logits, cache = prefill(cfg, params, prompt, cache, interpret=interpret)
    dec_params = fuse_decode_params(cfg, params)
    if int8_weights:
        dec_params = quantize_decode_params(cfg, dec_params)

    # the whole decode loop is one device-resident scan (decode_steps):
    # per-token host dispatch never touches the critical path
    cur = _sample(logits, temperature, key, 0, top_k, top_p)
    parts = [prompt.astype(jnp.int32), cur[:, None]]
    if max_new_tokens > 1:
        toks, cache = decode_steps(
            cfg, dec_params, cur, cache,
            n_steps=max_new_tokens - 1, n_splits=n_splits,
            interpret=interpret, temperature=temperature, key=key,
            top_k=top_k, top_p=top_p, step0=1,
        )
        parts.append(toks)
    return jnp.concatenate(parts, axis=1)


def _sample(logits, temperature, key, step, top_k=None, top_p=None):
    """Greedy / temperature / top-k / nucleus sampling. logits [B, V]."""
    if temperature <= 0.0 or key is None:
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)
    logits = logits / temperature
    use_k = top_k is not None and 0 < top_k < logits.shape[-1]
    use_p = top_p is not None and 0.0 < top_p < 1.0
    if use_k or use_p:
        # one descending sort serves both filters
        sorted_desc = jnp.sort(logits, axis=-1)[:, ::-1]
        if use_k:
            kth = sorted_desc[:, top_k - 1][:, None]
            logits = jnp.where(logits < kth, -jnp.inf, logits)
        if use_p:
            if use_k:
                sorted_desc = jnp.where(
                    jnp.arange(sorted_desc.shape[-1])[None, :] < top_k,
                    sorted_desc, -jnp.inf,
                )
            probs = jax.nn.softmax(sorted_desc, axis=-1)
            cum = jnp.cumsum(probs, axis=-1)
            # keep the smallest prefix with cumulative prob >= top_p (always
            # keeps the argmax: cum >= p first becomes true ON the boundary)
            keep = cum - probs < top_p
            cutoff = jnp.min(
                jnp.where(keep, sorted_desc, jnp.inf), axis=-1, keepdims=True
            )
            logits = jnp.where(logits < cutoff, -jnp.inf, logits)
    k = jax.random.fold_in(key, step)
    return jax.random.categorical(k, logits, axis=-1).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Paged-cache decode (vLLM-style): the fragmentation-free serving backend.
# Pages + block tables replace the per-slot padded linear cache; decode
# attends through ops.paged_flash_decode (each KV tile gathered from the
# pages the block table names). Prefill still runs through the linear path;
# its KV is scattered
# into pages with paged_insert.
# ---------------------------------------------------------------------------

class PagedKVCache(NamedTuple):
    """k_pages/v_pages: tuple of L arrays [n_pages, Hkv, page, D] (cfg dtype,
    or int8 for a quantized pool); block_tables: [B, max_pages] int32
    (shared across layers — pages are allocated per sequence, each layer
    owns a same-shaped pool); lengths: [B] int32; k/v_scale_pages: tuple of
    L arrays [n_pages, Hkv, page, 1] f32 per-token scales (8-bit pools
    only)."""

    k_pages: tuple
    v_pages: tuple
    block_tables: jax.Array
    lengths: jax.Array
    k_scale_pages: tuple | None = None
    v_scale_pages: tuple | None = None

    @property
    def page_size(self) -> int:
        return self.k_pages[0].shape[2]

    @property
    def quantized(self) -> bool:
        # any 8-bit pool (int8 or fp8_e4m3) routes through the fused-dequant
        # paged kernels; both carry per-token scale pages
        return jnp.dtype(self.k_pages[0].dtype).itemsize == 1


def init_paged_cache(
    cfg: tfm.TransformerConfig,
    batch: int,
    n_pages: int,
    *,
    page_size: int = 128,
    max_pages_per_seq: int = 16,
    quantized: bool = False,
    quant_fmt: str = "int8",
) -> PagedKVCache:
    """quantized=True stores 8-bit pages (quant_fmt: "int8" or "fp8") +
    per-token scale pages: half the pool HBM -> 2x the page
    capacity at fixed memory (same capacity trade as the linear int8 cache,
    init_cache)."""
    shape = (n_pages, cfg.n_kv_heads, page_size, cfg.d_head)
    L = cfg.n_layers
    tables = jnp.zeros((batch, max_pages_per_seq), jnp.int32)
    lengths = jnp.zeros((batch,), jnp.int32)
    if quantized:
        assert quant_fmt in ("int8", "fp8"), quant_fmt
        qdt = jnp.int8 if quant_fmt == "int8" else jnp.float8_e4m3fn
        s_shape = (n_pages, cfg.n_kv_heads, page_size, 1)
        return PagedKVCache(
            k_pages=tuple(jnp.zeros(shape, qdt) for _ in range(L)),
            v_pages=tuple(jnp.zeros(shape, qdt) for _ in range(L)),
            block_tables=tables,
            lengths=lengths,
            k_scale_pages=tuple(
                jnp.zeros(s_shape, jnp.float32) for _ in range(L)
            ),
            v_scale_pages=tuple(
                jnp.zeros(s_shape, jnp.float32) for _ in range(L)
            ),
        )
    return PagedKVCache(
        k_pages=tuple(jnp.zeros(shape, cfg.dtype) for _ in range(L)),
        v_pages=tuple(jnp.zeros(shape, cfg.dtype) for _ in range(L)),
        block_tables=tables,
        lengths=lengths,
    )


@functools.partial(
    jax.jit,
    static_argnames=("n_full", "page", "length", "start"),
    donate_argnums=(0, 1),
)
def _scatter_pages(
    kp, vp, k_seq, v_seq, table_row, *, n_full, page, length, start=0
):
    """Scatter one layer's prefix KV into its pages. Jitted with the pool
    buffers DONATED: un-jitted dynamic_update_slice would materialize a full
    pool copy per page (O(layers * pages) multi-GB traffic per insert).
    start: first page ordinal to write (earlier pages are shared/owned by
    the prefix cache and must not be touched)."""
    for j in range(start, n_full):
        lo = j * page
        hi = min(lo + page, length)
        blk_k = jnp.zeros((kp.shape[1], page, kp.shape[3]), kp.dtype)
        blk_k = blk_k.at[:, : hi - lo].set(k_seq[:, lo:hi].astype(kp.dtype))
        blk_v = jnp.zeros_like(blk_k)
        blk_v = blk_v.at[:, : hi - lo].set(v_seq[:, lo:hi].astype(vp.dtype))
        kp = jax.lax.dynamic_update_slice(
            kp, blk_k[None], (table_row[j], 0, 0, 0)
        )
        vp = jax.lax.dynamic_update_slice(
            vp, blk_v[None], (table_row[j], 0, 0, 0)
        )
    return kp, vp


@functools.partial(
    jax.jit,
    static_argnames=("n_full", "page", "length", "start"),
    donate_argnums=(0, 1, 2, 3),
)
def _scatter_pages_q(
    kp, ksp, vp, vsp, k_seq, v_seq, table_row, *, n_full, page, length,
    start=0,
):
    """Quantized variant of _scatter_pages: per-token 8-bit quantization of
    the prefix (int8 or fp8 pool dtype), values into the 8-bit pages, scales
    into the scale pages. Same donation discipline."""
    from flashattention_kernel_project_tpu.ops.quant import (
        quantize_fp8_tokenwise,
    )

    quantizer = (
        quantize_int8 if kp.dtype == jnp.int8 else quantize_fp8_tokenwise
    )
    # only rows past the shared prefix are written — don't quantize the
    # (possibly much longer) prefix just to discard it
    base = start * page
    k_q, k_s = quantizer(k_seq[:, base:], axis=-1)  # [Hkv, T-base, D/1]
    v_q, v_s = quantizer(v_seq[:, base:], axis=-1)
    for j in range(start, n_full):
        lo = j * page
        hi = min(lo + page, length)
        hkv = kp.shape[1]

        def blk(vals, dtype, lo=lo - base, hi=hi - base):
            b_ = jnp.zeros((hkv, page, vals.shape[-1]), dtype)
            return b_.at[:, : hi - lo].set(vals[:, lo:hi].astype(dtype))

        kp = jax.lax.dynamic_update_slice(
            kp, blk(k_q, kp.dtype)[None], (table_row[j], 0, 0, 0)
        )
        vp = jax.lax.dynamic_update_slice(
            vp, blk(v_q, vp.dtype)[None], (table_row[j], 0, 0, 0)
        )
        # scales: [Hkv, hi-lo, 1] -> [1, Hkv, page, 1]
        def sblk(scales, lo=lo - base, hi=hi - base):
            s_ = jnp.zeros((hkv, page, 1), jnp.float32)
            return s_.at[:, : hi - lo].set(scales[:, lo:hi])

        ksp = jax.lax.dynamic_update_slice(
            ksp, sblk(k_s)[None], (table_row[j], 0, 0, 0)
        )
        vsp = jax.lax.dynamic_update_slice(
            vsp, sblk(v_s)[None], (table_row[j], 0, 0, 0)
        )
    return kp, ksp, vp, vsp


def paged_insert(
    cache: PagedKVCache,
    slot: int,
    table_row: jax.Array,   # [max_pages] int32 page ids for this sequence
    k_seq: tuple,           # per-layer [Hkv, T, D] prefix KV
    v_seq: tuple,
    length: int,
    *,
    start_page: int = 0,
) -> PagedKVCache:
    """Scatter a sequence's prefix KV (from a linear prefill) into its
    allocated pages and install the block table at `slot`. One jitted,
    pool-donating scatter per layer (lengths are bucketed by the scheduler,
    so the per-(T, n_full) compile cost amortizes). start_page > 0 skips
    the leading pages — they are prefix-cache pages shared with other
    sequences and already hold this content."""
    page = cache.page_size
    n_full = -(-int(length) // page)
    k_pages = list(cache.k_pages)
    v_pages = list(cache.v_pages)
    tables = cache.block_tables.at[slot].set(table_row)
    lengths = cache.lengths.at[slot].set(length)
    if cache.quantized:
        ksp = list(cache.k_scale_pages)
        vsp = list(cache.v_scale_pages)
        for li in range(len(k_pages)):
            k_pages[li], ksp[li], v_pages[li], vsp[li] = _scatter_pages_q(
                k_pages[li], ksp[li], v_pages[li], vsp[li],
                k_seq[li], v_seq[li], table_row,
                n_full=n_full, page=page, length=int(length),
                start=start_page,
            )
        return PagedKVCache(
            tuple(k_pages), tuple(v_pages), tables, lengths,
            tuple(ksp), tuple(vsp),
        )
    for li in range(len(k_pages)):
        k_pages[li], v_pages[li] = _scatter_pages(
            k_pages[li], v_pages[li], k_seq[li], v_seq[li], table_row,
            n_full=n_full, page=page, length=int(length), start=start_page,
        )
    return PagedKVCache(tuple(k_pages), tuple(v_pages), tables, lengths)


def cache_from_pages(
    cfg: tfm.TransformerConfig,
    cache: PagedKVCache,
    page_ids,
    s: int,
    max_len: int,
) -> KVCache:
    """Assemble a batch-1 LINEAR cache whose first s rows are the content
    of the given (full) pages — the prefix-cache gather that lets a new
    request skip prefill compute for a shared prompt prefix and extend
    only its suffix. An 8-bit pool is dequantized into the linear rows
    (the suffix then attends exactly what decode attends). Returns a
    full-precision cache with lengths=[s]."""
    ids = jnp.asarray(page_ids, jnp.int32)
    hkv, page, d = cache.k_pages[0].shape[1:]
    L = len(cache.k_pages)
    out = init_cache(cfg, 1, max_len, quantized=False)
    k_rows, v_rows = list(out.k), list(out.v)
    for li in range(L):
        kp = jnp.take(cache.k_pages[li], ids, axis=0)  # [ns, Hkv, page, D]
        vp = jnp.take(cache.v_pages[li], ids, axis=0)
        if cache.quantized:
            ks = jnp.take(cache.k_scale_pages[li], ids, 0)
            vs = jnp.take(cache.v_scale_pages[li], ids, 0)
            kp = kp.astype(jnp.float32) * ks
            vp = vp.astype(jnp.float32) * vs
        k_lin = jnp.moveaxis(kp, 0, 1).reshape(hkv, -1, d)[:, :s]
        v_lin = jnp.moveaxis(vp, 0, 1).reshape(hkv, -1, d)[:, :s]
        k_rows[li] = k_rows[li].at[0, :, :s].set(k_lin.astype(out.k[li].dtype))
        v_rows[li] = v_rows[li].at[0, :, :s].set(v_lin.astype(out.v[li].dtype))
    return KVCache(
        tuple(k_rows), tuple(v_rows), None, None,
        jnp.full((1,), s, jnp.int32),
    )


@functools.partial(
    jax.jit, static_argnums=(0,), static_argnames=("interpret", "axis")
)
def decode_step_paged(
    cfg: tfm.TransformerConfig,
    params: dict,
    tokens: jax.Array,
    cache: PagedKVCache,
    *,
    interpret: bool | None = None,
    axis: str | None = None,
) -> tuple[jax.Array, PagedKVCache]:
    """One decode step against the paged cache. tokens [B] -> (logits, cache).
    Slots with length 0 are masked out (zero attention output).
    axis: tensor-parallel mesh axis (see decode_step) — the page pools are
    then head-sharded and cfg is the LOCAL config."""
    from flashattention_kernel_project_tpu.ops.paged_decode import (
        paged_append,
        paged_append_quant,
        paged_flash_decode,
        paged_flash_decode_quant,
    )

    b = tokens.shape[0]
    x = params["embed"][tokens][:, None]
    sin, cos = tfm.rope_tables(cfg, cache.lengths[:, None])
    k_pages = list(cache.k_pages)
    v_pages = list(cache.v_pages)
    quant = cache.quantized
    ksp = list(cache.k_scale_pages) if quant else None
    vsp = list(cache.v_scale_pages) if quant else None
    new_lengths = cache.lengths + 1
    for i in range(cfg.n_layers):
        layer = jax.tree.map(lambda p: p[i], params["layers"])
        h = tfm.rms_norm(x, layer["rms_attn"])
        q, k, v = _qkv(cfg, layer, h, b, 1)
        q = tfm.apply_rope(q, sin, cos)
        k = tfm.apply_rope(k, sin, cos)
        qd = q.reshape(b, cfg.n_heads, cfg.d_head).astype(cfg.dtype)
        if quant:
            k_pages[i], ksp[i], v_pages[i], vsp[i] = paged_append_quant(
                k_pages[i], ksp[i], v_pages[i], vsp[i],
                k[:, 0], v[:, 0],
                cache.block_tables, cache.lengths,
            )
            o = paged_flash_decode_quant(
                qd, k_pages[i], ksp[i], v_pages[i], vsp[i],
                cache.block_tables, new_lengths,
                interpret=interpret,
            )
        else:
            k_pages[i], v_pages[i] = paged_append(
                k_pages[i], v_pages[i],
                k[:, 0], v[:, 0],
                cache.block_tables, cache.lengths,
            )
            o = paged_flash_decode(
                qd, k_pages[i], v_pages[i],
                cache.block_tables, new_lengths,
                interpret=interpret,
            )
        x = x + _psum(
            _proj(o.reshape(b, 1, cfg.q_dim), layer, "wo", x.dtype), axis
        )
        x = _mlp(layer, x, axis, cfg)
    x = tfm.rms_norm(x, params["rms_final"])
    logits = _lm_head(params, x[:, 0])
    return logits, PagedKVCache(
        tuple(k_pages), tuple(v_pages), cache.block_tables, new_lengths,
        tuple(ksp) if quant else None, tuple(vsp) if quant else None,
    )


@functools.partial(
    jax.jit, static_argnums=(0,), static_argnames=("interpret", "axis"),
    # donate the cache: every layer's page pool is functionally updated
    # once per call — without donation XLA may materialize a full-pool
    # copy per layer (advisor r2). Callers always replace the cache with
    # the returned one (serving loop / tests), so the old buffers are dead.
    donate_argnums=(3,),
)
def extend_paged(
    cfg: tfm.TransformerConfig,
    params: dict,
    tokens: jax.Array,
    cache: PagedKVCache,
    *,
    interpret: bool | None = None,
    axis: str | None = None,
) -> tuple[jax.Array, PagedKVCache]:
    """Multi-token extend against the paged cache: tokens [B, T] ->
    (all-position logits [B, T, V], cache advanced by T). The paged analog
    of `extend(..., all_logits=True)` — the speculative-decoding verify
    step over a page pool (chunk KV appended token-by-token, then one
    paged_flash_extend per layer scores every chunk position). Slots must
    accept T more tokens within their allocated pages (the scheduler's
    reserve rows guarantee it). bf16 AND 8-bit pools (round 5: the chunk
    quantizes per-token on append, the extend kernel dequants fused)."""
    from flashattention_kernel_project_tpu.ops.paged_decode import (
        paged_append_chunk,
        paged_append_chunk_quant,
        paged_flash_extend,
    )

    quant = cache.quantized
    b, t = tokens.shape
    x = params["embed"][tokens]
    positions = cache.lengths[:, None] + jnp.arange(t)[None, :]
    sin, cos = tfm.rope_tables(cfg, positions)
    k_pages = list(cache.k_pages)
    v_pages = list(cache.v_pages)
    ks_pages = list(cache.k_scale_pages) if quant else None
    vs_pages = list(cache.v_scale_pages) if quant else None
    new_lengths = cache.lengths + t
    for i in range(cfg.n_layers):
        layer = jax.tree.map(lambda p: p[i], params["layers"])
        h = tfm.rms_norm(x, layer["rms_attn"])
        q, k, v = _qkv(cfg, layer, h, b, t)
        q = tfm.apply_rope(q, sin, cos)
        k = tfm.apply_rope(k, sin, cos)
        # one scatter for the whole T-token chunk (advisor r2: T sequential
        # paged_append calls cost O(T) full-pool functional updates)
        if quant:
            (k_pages[i], ks_pages[i],
             v_pages[i], vs_pages[i]) = paged_append_chunk_quant(
                k_pages[i], ks_pages[i], v_pages[i], vs_pages[i],
                k, v, cache.block_tables, cache.lengths,
            )
        else:
            k_pages[i], v_pages[i] = paged_append_chunk(
                k_pages[i], v_pages[i],
                k.astype(cache.k_pages[0].dtype),
                v.astype(cache.v_pages[0].dtype),
                cache.block_tables, cache.lengths,
            )
        qd = (
            q.transpose(0, 2, 1, 3).astype(cfg.dtype)
        )  # [B, Hq, T, D]
        o = paged_flash_extend(
            qd, k_pages[i], v_pages[i],
            cache.block_tables, new_lengths, cache.lengths,
            interpret=interpret,
            k_scale_pages=ks_pages[i] if quant else None,
            v_scale_pages=vs_pages[i] if quant else None,
        )  # [B, Hq, T, D]
        x = x + _psum(
            _proj(
                o.transpose(0, 2, 1, 3).reshape(b, t, cfg.q_dim),
                layer, "wo", x.dtype,
            ),
            axis,
        )
        x = _mlp(layer, x, axis, cfg)
    x = tfm.rms_norm(x, params["rms_final"])
    logits = _lm_head(params, x.reshape(b * t, -1)).reshape(b, t, -1)
    return logits, PagedKVCache(
        tuple(k_pages), tuple(v_pages), cache.block_tables, new_lengths,
        tuple(ks_pages) if quant else None,
        tuple(vs_pages) if quant else None,
    )


# ---------------------------------------------------------------------------
# Speculative decoding: draft model proposes, target verifies one
# chunked-extend per round. temperature == 0 is greedy — output IDENTICAL
# to target-only greedy decoding; temperature > 0 uses rejection sampling
# (accept d_j with prob min(1, p/q), resample the residual on reject),
# which preserves the target model's sampling distribution EXACTLY. Either
# way the win is wall-clock — one target extend of k+1 tokens replaces up
# to k+1 sequential target decode steps, and prefill-shaped extends run at
# tensor-core throughput while decode is bandwidth-bound.
# ---------------------------------------------------------------------------

def speculative_accept(p, q, d, rng) -> list[int]:
    """Rejection-sampling acceptance for one slot (pure numpy, testable).

    p: [k+1, V] target probs (p[j] = target dist after the j+1-token chunk
    prefix), q: [k, V] draft probs, d: [k] draft tokens sampled from q,
    rng: np.random.Generator. Returns the committed tokens (1..k+1 of
    them): the accepted draft prefix plus one correction token sampled
    from the residual norm(max(p−q, 0)) at the first rejection, or a
    bonus token from p[k] when every draft is accepted. The committed
    sequence is distributed exactly as target-only sampling (Leviathan et
    al. 2023 / Chen et al. 2023 — no reference analog; the greedy path's
    verify-by-argmax is the temperature→0 limit of this rule).
    """
    import numpy as np

    k = len(d)
    out: list[int] = []
    for j in range(k):
        tok = int(d[j])
        p_j = p[j]
        q_tok = max(float(q[j, tok]), 1e-20)
        if rng.random() < float(p_j[tok]) / q_tok:
            out.append(tok)
            continue
        res = np.maximum(p_j - q[j], 0.0)
        s = float(res.sum())
        dist = res / s if s > 0.0 else p_j / float(p_j.sum())
        out.append(int(rng.choice(len(dist), p=dist / dist.sum())))
        return out
    pk = p[k] / float(p[k].sum())
    out.append(int(rng.choice(len(pk), p=pk)))
    return out

def speculative_generate(
    cfg: tfm.TransformerConfig,
    params: dict,
    prompt: jax.Array,
    *,
    draft_cfg: tfm.TransformerConfig,
    draft_params: dict,
    spec_k: int = 4,
    max_new_tokens: int = 32,
    max_len: int | None = None,
    temperature: float = 0.0,
    key: jax.Array | None = None,
    interpret: bool | None = None,
) -> jax.Array:
    """Speculative decoding. prompt [B, T] -> [B, T + max_new_tokens].

    Per round: the draft decodes `spec_k` tokens from its own cache; the
    target verifies them with ONE ragged chunked extend over
    [c, d_1..d_k] (c = the previous round's target-chosen token), accepts
    the longest matching prefix per slot, and emits its own next token at
    the first mismatch (or a bonus token when everything matched) — so
    each round commits 1..spec_k+1 target-grade tokens per slot. Cache
    rollback is just the per-slot `lengths` vector: KV written past a
    slot's accepted prefix is dead and gets overwritten by later rounds
    (per-slot raggedness rides the engine's existing ragged kernels).
    Requires draft_cfg.vocab_size == cfg.vocab_size.

    temperature > 0 (with a PRNG `key`) switches both models to sampling
    and the verify rule to rejection sampling (`speculative_accept`) —
    the committed stream is then distributed exactly as target-only
    temperature sampling.
    """
    import numpy as np

    assert draft_cfg.vocab_size == cfg.vocab_size
    sampling = temperature > 0.0 and key is not None
    if sampling:
        host_rng = np.random.default_rng(
            int(jax.random.randint(
                jax.random.fold_in(key, 0xACCE), (), 0, 2**31 - 1
            ))
        )
    b, t = prompt.shape
    max_len = max_len or (t + max_new_tokens + spec_k + 2)
    tcache = init_cache(cfg, b, max_len)
    dcache = init_cache(draft_cfg, b, max_len)
    tl, tcache = prefill(cfg, params, prompt, tcache, interpret=interpret)
    _, dcache = prefill(
        draft_cfg, draft_params, prompt, dcache, interpret=interpret
    )

    out = np.full((b, max_new_tokens + spec_k + 2), 0, np.int32)
    counts = np.zeros(b, np.int64)
    if sampling:
        c = _sample(tl, temperature, key, 0)  # first target token [B]
    else:
        c = jnp.argmax(tl, axis=-1).astype(jnp.int32)
    for i in range(b):
        out[i, 0] = int(np.asarray(c)[i])
    counts += 1

    rnd = 0
    while counts.min() < max_new_tokens:
        rnd += 1
        # draft: feed c, then propose spec_k tokens
        dl, dcache = decode_step(
            draft_cfg, draft_params, c, dcache, interpret=interpret
        )
        drafts, q_dists = [], []
        for j in range(spec_k):
            if sampling:
                q_dists.append(jax.nn.softmax(dl / temperature, axis=-1))
                d_j = _sample(
                    dl, temperature, jax.random.fold_in(key, rnd), j
                )
            else:
                d_j = jnp.argmax(dl, axis=-1).astype(jnp.int32)
            drafts.append(d_j)
            # feed EVERY draft token (incl. the last): the resync below may
            # mark all k as valid when the target accepts the whole chunk,
            # so d_k's KV must be present in the draft cache
            dl, dcache = decode_step(
                draft_cfg, draft_params, d_j, dcache, interpret=interpret
            )
        d = jnp.stack(drafts, axis=1)  # [B, k]

        # target: one chunked extend over [c, d_1..d_k]
        chunk = jnp.concatenate([c[:, None], d], axis=1)  # [B, k+1]
        all_l, tcache = extend(
            cfg, params, chunk, tcache, interpret=interpret, all_logits=True
        )
        d_np = np.asarray(d)
        if sampling:
            # p[:, j] = target dist after chunk[:, :j+1]; rejection-sample
            p = np.asarray(
                jax.nn.softmax(all_l / temperature, axis=-1), np.float64
            )
            q = np.asarray(jnp.stack(q_dists, axis=1), np.float64)
            takes = [
                speculative_accept(p[i], q[i], d_np[i], host_rng)
                for i in range(b)
            ]
            a = np.array([len(tk) - 1 for tk in takes], np.int64)
        else:
            preds = jnp.argmax(all_l, axis=-1).astype(jnp.int32)  # [B, k+1]
            # preds[:, j] = target's token after chunk[:, :j+1]; it verifies
            # d[:, j] for j < k, and preds[:, a] is the correction/bonus
            match = np.asarray(preds[:, :-1] == d)  # [B, k]
            a = np.where(
                match.all(axis=1), spec_k, np.argmin(match, axis=1)
            )  # accepted drafts per slot
            preds_np = np.asarray(preds)
            takes = [
                list(d_np[i, : int(a[i])]) + [int(preds_np[i, int(a[i])])]
                for i in range(b)
            ]

        # commit d[:a] + correction per slot; roll caches back to the
        # accepted prefix (+1 for c, which extend just wrote)
        new_t_len = np.asarray(tcache.lengths) - (spec_k + 1) + 1 + a
        c_next = np.empty(b, np.int32)
        for i in range(b):
            take = [int(x) for x in takes[i]]
            n0 = int(counts[i])
            # a finished slot (output already full) keeps looping only for
            # the laggards: clamp its writes to the buffer
            take = take[: max(out.shape[1] - n0, 0)]
            out[i, n0 : n0 + len(take)] = take
            counts[i] += len(take)
            c_next[i] = take[-1] if take else out[i, n0 - 1]
        # cap finished slots' cache growth too — without this a slot that
        # keeps accepting drafts would advance past max_len and the append's
        # clamped dynamic-update would corrupt committed KV
        new_t_len = np.minimum(new_t_len, t + max_new_tokens + 1)
        tcache = tcache._replace(lengths=jnp.asarray(new_t_len, jnp.int32))
        # draft holds [.., c, d_1..d_{k-1}]; resync to the target's view
        dcache = dcache._replace(lengths=jnp.asarray(new_t_len, jnp.int32))
        c = jnp.asarray(c_next)

    return jnp.concatenate(
        [prompt.astype(jnp.int32),
         jnp.asarray(out[:, :max_new_tokens], jnp.int32)], axis=1
    )
