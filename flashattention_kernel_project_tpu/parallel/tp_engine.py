"""Tensor-parallel serving engine: the full transformer decode/prefill
stack over a mesh.

parallel/mesh.py shards the ATTENTION KERNELS; this module shards the whole
ENGINE — megatron column/row-sharded projections (the two psums per layer
ride the interconnect), KV cache head-sharded P(None, "model", None, None),
embedding and
logits replicated. Inside shard_map each chip runs the stock engine
(models/engine.py) on a LOCAL config (heads and d_ff divided by the axis
size) — the mesh is purely a layout + two-collectives concern, exactly the
design stance of SURVEY.md §5.8 (the reference is single-GPU; its analog is
batch×head grid parallelism, e.g. qk_tiled_5_1_1.cu:164-170).

The returned functions are drop-in replacements for engine.prefill /
engine.extend / engine.decode_step, so the continuous-batching Scheduler
(models/serving.py) runs unmodified across the mesh — "continuous batching
across hosts" from the BASELINE north star.
"""

from __future__ import annotations

import dataclasses

import jax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flashattention_kernel_project_tpu.models import engine
from flashattention_kernel_project_tpu.models import transformer as tfm


def local_config(
    cfg: tfm.TransformerConfig, tp: int
) -> tfm.TransformerConfig:
    """The per-chip config: heads and MLP width divided over the TP axis."""
    assert cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0, (
        f"heads ({cfg.n_heads}/{cfg.n_kv_heads}) not divisible by tp={tp}"
    )
    assert cfg.d_ff % tp == 0, (cfg.d_ff, tp)
    return dataclasses.replace(
        cfg,
        n_heads=cfg.n_heads // tp,
        n_kv_heads=cfg.n_kv_heads // tp,
        d_ff=cfg.d_ff // tp,
    )


def cache_specs(quantized: bool, n_layers: int, model_axis: str = "model"):
    """PartitionSpec pytree for a head-sharded engine.KVCache."""
    kv = tuple(P(None, model_axis, None, None) for _ in range(n_layers))
    scale = kv if quantized else None
    return engine.KVCache(k=kv, v=kv, k_scale=scale, v_scale=scale, lengths=P())


def init_tp_cache(
    cfg: tfm.TransformerConfig,
    mesh: Mesh,
    batch: int,
    max_len: int,
    *,
    quantized: bool = False,
    quant_fmt: str = "int8",
    model_axis: str = "model",
) -> engine.KVCache:
    """Allocate the KV cache laid out head-sharded over the mesh."""
    cache = engine.init_cache(
        cfg, batch, max_len, quantized=quantized, quant_fmt=quant_fmt
    )
    specs = cache_specs(quantized, cfg.n_layers, model_axis)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), cache, specs
    )


def paged_cache_specs(
    quantized: bool, n_layers: int, model_axis: str = "model"
):
    """PartitionSpec pytree for a head-sharded engine.PagedKVCache: page
    pools sharded over KV heads, block tables and lengths replicated."""
    pool = tuple(P(None, model_axis, None, None) for _ in range(n_layers))
    scale = pool if quantized else None
    return engine.PagedKVCache(
        k_pages=pool, v_pages=pool, block_tables=P(), lengths=P(),
        k_scale_pages=scale, v_scale_pages=scale,
    )


def init_tp_paged_cache(
    cfg: tfm.TransformerConfig,
    mesh: Mesh,
    batch: int,
    n_pages: int,
    *,
    page_size: int = 128,
    max_pages_per_seq: int = 16,
    quantized: bool = False,
    model_axis: str = "model",
) -> engine.PagedKVCache:
    """Allocate the page pools laid out head-sharded over the mesh."""
    cache = engine.init_paged_cache(
        cfg, batch, n_pages, page_size=page_size,
        max_pages_per_seq=max_pages_per_seq, quantized=quantized,
    )
    specs = paged_cache_specs(quantized, cfg.n_layers, model_axis)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), cache, specs
    )


def make_tp_verify_extend(
    cfg: tfm.TransformerConfig,
    mesh: Mesh,
    *,
    model_axis: str = "model",
    quantized_cache: bool = False,
    interpret: bool | None = None,
):
    """TP ragged extend returning EVERY position's logits [B, T, V] — the
    speculative-decoding verify pass over the mesh."""
    tp = mesh.shape[model_axis]
    lcfg = local_config(cfg, tp)
    rules = tfm.param_shardings(cfg, model_axis=model_axis)
    cspecs = cache_specs(quantized_cache, cfg.n_layers, model_axis)

    def _extend(params, tokens, cache):
        return engine.extend(
            lcfg, params, tokens, cache, all_logits=True,
            interpret=interpret, axis=model_axis,
        )

    return jax.jit(shard_map(
        _extend, mesh=mesh, check_vma=False,
        in_specs=(rules, P(), cspecs), out_specs=(P(), cspecs),
    ))


def make_tp_paged_decode(
    cfg: tfm.TransformerConfig,
    mesh: Mesh,
    *,
    model_axis: str = "model",
    quantized_cache: bool = False,
    interpret: bool | None = None,
):
    """shard_map-wrapped decode_step_paged over head-sharded page pools.
    Returns decode_fn(params, tokens[B], cache) -> (logits, cache); params
    per tfm.param_shardings (split layout), cache per init_tp_paged_cache.
    The page SCATTER side (engine.paged_insert) runs outside shard_map —
    its per-page dynamic updates touch only the page axis, so GSPMD keeps
    the head sharding intact."""
    tp = mesh.shape[model_axis]
    lcfg = local_config(cfg, tp)
    rules = tfm.param_shardings(cfg, model_axis=model_axis)
    cspecs = paged_cache_specs(quantized_cache, cfg.n_layers, model_axis)

    def _decode(params, tokens, cache):
        return engine.decode_step_paged(
            lcfg, params, tokens, cache, interpret=interpret,
            axis=model_axis,
        )

    return jax.jit(shard_map(
        _decode, mesh=mesh, check_vma=False,
        in_specs=(rules, P(), cspecs), out_specs=(P(), cspecs),
    ))


def make_tp_paged_verify_extend(
    cfg: tfm.TransformerConfig,
    mesh: Mesh,
    *,
    model_axis: str = "model",
    interpret: bool | None = None,
):
    """TP multi-token extend over the PAGED pool returning every
    position's logits [B, T, V] — speculative decoding's verify pass with
    the target sharded over the mesh AND a vLLM-style page pool (round 5:
    the spec x paged x TP wall). The chunk append (paged_append_chunk)
    and the ragged extend kernel run per shard on the head-local pool,
    exactly like decode_step_paged in make_tp_paged_decode; bf16 pool
    (extend_paged's contract)."""
    tp = mesh.shape[model_axis]
    lcfg = local_config(cfg, tp)
    rules = tfm.param_shardings(cfg, model_axis=model_axis)
    cspecs = paged_cache_specs(False, cfg.n_layers, model_axis)

    def _extend(params, tokens, cache):
        return engine.extend_paged(
            lcfg, params, tokens, cache, interpret=interpret,
            axis=model_axis,
        )

    return jax.jit(shard_map(
        _extend, mesh=mesh, check_vma=False,
        in_specs=(rules, P(), cspecs), out_specs=(P(), cspecs),
    ))


def make_tp_decode_steps(
    cfg: tfm.TransformerConfig,
    mesh: Mesh,
    *,
    n_steps: int,
    model_axis: str = "model",
    n_splits: int | None = None,
    quantized_cache: bool = False,
    paged: bool = False,
    interpret: bool | None = None,
):
    """Multi-step decode window over the TP mesh (VERDICT r4 task 6:
    multi_step x TP — the two best throughput levers compose). The n_steps
    greedy lax.scan (engine.decode_steps / decode_steps_paged) runs INSIDE
    shard_map, so ONE dispatch advances the whole window with
    megatron-sharded weights and the head-sharded (or head-sharded paged)
    cache; the per-step psums ride the interconnect inside the scan body
    exactly as in
    the single-step TP path. fn(params, tokens[B], cache) ->
    (tokens [B, n_steps], cache advanced n_steps)."""
    tp = mesh.shape[model_axis]
    lcfg = local_config(cfg, tp)
    rules = tfm.param_shardings(cfg, model_axis=model_axis)
    if paged:
        cspecs = paged_cache_specs(quantized_cache, cfg.n_layers, model_axis)

        def _steps(params, tokens, cache):
            return engine.decode_steps_paged(
                lcfg, params, tokens, cache, n_steps=n_steps,
                interpret=interpret, axis=model_axis,
            )
    else:
        cspecs = cache_specs(quantized_cache, cfg.n_layers, model_axis)

        def _steps(params, tokens, cache):
            return engine.decode_steps(
                lcfg, params, tokens, cache, n_steps=n_steps,
                n_splits=n_splits, interpret=interpret, axis=model_axis,
            )

    return jax.jit(shard_map(
        _steps, mesh=mesh, check_vma=False,
        in_specs=(rules, P(), cspecs), out_specs=(P(), cspecs),
    ))


def make_tp_engine(
    cfg: tfm.TransformerConfig,
    mesh: Mesh,
    *,
    model_axis: str = "model",
    n_splits: int | None = None,
    quantized_cache: bool = False,
    interpret: bool | None = None,
):
    """Build the sharded engine. Returns (prefill_fn, extend_fn, decode_fn,
    param_rules). Params must be laid out per param_rules
    (parallel.shard_params); caches per init_tp_cache.

    prefill_fn(params, tokens[B,T], cache) -> (logits [B,V], cache)
    extend_fn(params, tokens[B,T], cache, n[B]) -> (logits [B,V], cache)
    decode_fn(params, tokens[B], cache) -> (logits [B,V], cache)

    Logits are replicated (the lm head is replicated — each chip computes
    them from the psum'd final hidden state).
    """
    tp = mesh.shape[model_axis]
    lcfg = local_config(cfg, tp)
    rules = tfm.param_shardings(cfg, model_axis=model_axis)
    cspecs = cache_specs(quantized_cache, cfg.n_layers, model_axis)
    logits_spec = P()

    def _prefill(params, tokens, cache):
        return engine.prefill(
            lcfg, params, tokens, cache, interpret=interpret, axis=model_axis
        )

    def _extend(params, tokens, cache, n):
        return engine.extend(
            lcfg, params, tokens, cache, n=n, interpret=interpret,
            axis=model_axis,
        )

    def _decode(params, tokens, cache):
        return engine.decode_step(
            lcfg, params, tokens, cache, n_splits=n_splits,
            interpret=interpret, axis=model_axis,
        )

    prefill_fn = jax.jit(shard_map(
        _prefill, mesh=mesh, check_vma=False,
        in_specs=(rules, P(), cspecs), out_specs=(logits_spec, cspecs),
    ))
    extend_fn = jax.jit(shard_map(
        _extend, mesh=mesh, check_vma=False,
        in_specs=(rules, P(), cspecs, P()), out_specs=(logits_spec, cspecs),
    ))
    decode_fn = jax.jit(shard_map(
        _decode, mesh=mesh, check_vma=False,
        in_specs=(rules, P(), cspecs), out_specs=(logits_spec, cspecs),
    ))
    return prefill_fn, extend_fn, decode_fn, rules


# ---------------------------------------------------------------------------
# Sequence-sharded decode engine (context parallel at serving time): the KV
# cache is sharded along its LENGTH, for contexts bigger than one chip's
# HBM. Params are replicated and every chip computes the same activations —
# redundantly, on purpose: decode is bandwidth-bound on the KV stream, and
# that stream is what gets split P ways. Per layer each chip appends the
# new token iff the global write position lands in its shard, runs split-KV
# decode over its slice for UNNORMALIZED (m, l, y) partials, and one tiny
# all_gather + the associative streaming merge (the reference's algebra,
# flashattn_streaming_16x16.cu:15-24, across chips) produces the output
# everywhere. parallel/mesh.py::seq_sharded_decode is the kernel-level
# version of the same idea; this is the whole-transformer step.
# ---------------------------------------------------------------------------

def sp_cache_specs(
    n_layers: int, seq_axis: str = "sp", quantized: bool = False
):
    kv = tuple(P(None, None, seq_axis, None) for _ in range(n_layers))
    scale = kv if quantized else None
    return engine.KVCache(
        k=kv, v=kv, k_scale=scale, v_scale=scale, lengths=P()
    )


def init_sp_cache(
    cfg: tfm.TransformerConfig,
    mesh: Mesh,
    batch: int,
    max_len: int,
    *,
    quantized: bool = False,
    quant_fmt: str = "int8",
    seq_axis: str = "sp",
) -> engine.KVCache:
    """Allocate a linear cache length-sharded over `seq_axis`
    (max_len must divide evenly); 8-bit values + scales when quantized."""
    assert max_len % mesh.shape[seq_axis] == 0, (max_len, mesh.shape)
    cache = engine.init_cache(
        cfg, batch, max_len, quantized=quantized, quant_fmt=quant_fmt
    )
    specs = sp_cache_specs(cfg.n_layers, seq_axis, quantized)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), cache, specs
    )


def _make_sp_decode_body(
    cfg: tfm.TransformerConfig,
    seq_axis: str,
    n_splits: int | None,
    quantized_cache: bool,
    interpret: bool | None,
):
    """Shard-local SP decode step body + its in/out specs — shared by the
    single-step wrapper (make_sp_decode_step) and the multi-step window
    (make_sp_decode_steps, round 5)."""
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu.ops.flash_decode import (
        flash_decode,
        flash_decode_int8,
        merge_partials,
    )
    from flashattention_kernel_project_tpu.ops.quant import (
        quantize_fp8_tokenwise,
        quantize_int8,
    )

    rep_rules = jax.tree.map(
        lambda _: P(), tfm.param_shardings(cfg),
        is_leaf=lambda x: isinstance(x, P),
    )
    cspecs = sp_cache_specs(cfg.n_layers, seq_axis, quantized_cache)

    def _write_shard(cache_layer, new, pos_c, ok):
        # new [B, Hkv, 1, D] lands at per-slot local position pos_c, but
        # only on the chip whose shard owns the global write position
        def one(slot_cache, slot_new, pos, good):
            upd = jax.lax.dynamic_update_slice(
                slot_cache, slot_new.astype(slot_cache.dtype), (0, pos, 0)
            )
            return jnp.where(good, upd, slot_cache)

        return jax.vmap(one)(cache_layer, new, pos_c, ok)

    def _decode(params, tokens, cache):
        b = tokens.shape[0]
        idx = jax.lax.axis_index(seq_axis)
        s_loc = cache.k[0].shape[2]
        x = params["embed"][tokens][:, None]
        sin, cos = tfm.rope_tables(cfg, cache.lengths[:, None])
        local_pos = cache.lengths - idx * s_loc
        ok = (local_pos >= 0) & (local_pos < s_loc)
        pos_c = jnp.clip(local_pos, 0, s_loc - 1)
        new_lengths = cache.lengths + 1
        local_len = jnp.clip(new_lengths - idx * s_loc, 0, s_loc)
        k_all, v_all = list(cache.k), list(cache.v)
        ks_all = list(cache.k_scale) if quantized_cache else None
        vs_all = list(cache.v_scale) if quantized_cache else None
        for i in range(cfg.n_layers):
            layer = jax.tree.map(lambda p: p[i], params["layers"])
            h = tfm.rms_norm(x, layer["rms_attn"])
            q, k, v = engine._qkv(cfg, layer, h, b, 1)
            q = tfm.apply_rope(q, sin, cos)
            k = tfm.apply_rope(k, sin, cos)
            k_t = k.transpose(0, 2, 1, 3)
            v_t = v.transpose(0, 2, 1, 3)
            if quantized_cache:
                quantizer = (
                    quantize_int8 if k_all[i].dtype == jnp.int8
                    else quantize_fp8_tokenwise
                )
                k_q, k_s = quantizer(k_t, axis=-1)
                v_q, v_s = quantizer(v_t, axis=-1)
                k_all[i] = _write_shard(k_all[i], k_q, pos_c, ok)
                v_all[i] = _write_shard(v_all[i], v_q, pos_c, ok)
                ks_all[i] = _write_shard(ks_all[i], k_s, pos_c, ok)
                vs_all[i] = _write_shard(vs_all[i], v_s, pos_c, ok)
            else:
                k_all[i] = _write_shard(k_all[i], k_t, pos_c, ok)
                v_all[i] = _write_shard(v_all[i], v_t, pos_c, ok)
            qd = q.reshape(b, cfg.n_heads, cfg.d_head).astype(cfg.dtype)
            if quantized_cache:
                m, l, y = flash_decode_int8(
                    qd, k_all[i], ks_all[i], v_all[i], vs_all[i],
                    local_len, n_splits=n_splits, return_partials=True,
                    interpret=interpret,
                )
            else:
                m, l, y = flash_decode(
                    qd, k_all[i], v_all[i], local_len,
                    n_splits=n_splits, return_partials=True,
                    interpret=interpret,
                )
            mm = jnp.moveaxis(jax.lax.all_gather(m, seq_axis), 0, -3)
            ll = jnp.moveaxis(jax.lax.all_gather(l, seq_axis), 0, -3)
            yy = jnp.moveaxis(jax.lax.all_gather(y, seq_axis), 0, -3)
            out = merge_partials(mm, ll, yy)  # [B, Hkv, G, D]
            o = out.reshape(b, cfg.q_dim).astype(x.dtype)
            x = x + engine._proj(o[:, None], layer, "wo", x.dtype)
            x = engine._mlp(layer, x, cfg=cfg)
        x = tfm.rms_norm(x, params["rms_final"])
        logits = engine._lm_head(params, x[:, 0])
        return logits, engine.KVCache(
            tuple(k_all), tuple(v_all),
            tuple(ks_all) if quantized_cache else None,
            tuple(vs_all) if quantized_cache else None,
            new_lengths,
        )

    return _decode, rep_rules, cspecs


def make_sp_decode_step(
    cfg: tfm.TransformerConfig,
    mesh: Mesh,
    *,
    seq_axis: str = "sp",
    n_splits: int | None = None,
    quantized_cache: bool = False,
    interpret: bool | None = None,
):
    """Returns decode_fn(params, tokens[B], cache) -> (logits, cache) with
    the cache length-sharded per init_sp_cache and params replicated
    (split layout). quantized_cache: the shards are 8-bit + per-token
    scales; the new token quantizes shard-locally and attention runs the
    fused-dequant split-KV kernel per shard."""
    _decode, rep_rules, cspecs = _make_sp_decode_body(
        cfg, seq_axis, n_splits, quantized_cache, interpret
    )
    return jax.jit(shard_map(
        _decode, mesh=mesh, check_vma=False,
        in_specs=(rep_rules, P(), cspecs), out_specs=(P(), cspecs),
    ))


def make_sp_decode_steps(
    cfg: tfm.TransformerConfig,
    mesh: Mesh,
    *,
    n_steps: int,
    seq_axis: str = "sp",
    n_splits: int | None = None,
    quantized_cache: bool = False,
    interpret: bool | None = None,
):
    """Greedy multi-step window over the LENGTH-sharded cache (round 5:
    seq_mesh x multi_step): the n_steps lax.scan runs INSIDE shard_map —
    per-step shard-local appends, split-KV partials, and the one
    all_gather + associative merge all stay inside the scan body, so one
    dispatch advances the whole window. fn(params, tokens[B], cache) ->
    (tokens [B, n_steps], cache advanced n_steps)."""
    import jax.numpy as jnp

    _decode, rep_rules, cspecs = _make_sp_decode_body(
        cfg, seq_axis, n_splits, quantized_cache, interpret
    )

    def _steps(params, tokens, cache):
        def body(carry, _):
            cur, c = carry
            logits, c = _decode(params, cur, c)
            nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            return (nxt, c), nxt

        (_, cache2), toks = jax.lax.scan(
            body, (tokens.astype(jnp.int32), cache), None, length=n_steps
        )
        return toks.swapaxes(0, 1), cache2

    return jax.jit(shard_map(
        _steps, mesh=mesh, check_vma=False,
        in_specs=(rep_rules, P(), cspecs), out_specs=(P(), cspecs),
    ))
