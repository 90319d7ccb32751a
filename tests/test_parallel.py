"""Multi-chip sharding tests on the 8-device virtual CPU mesh.

The reference has no distributed layer (SURVEY.md section 2.9); these tests
pin the designed-fresh one: head-sharded (TP) attention/decode and ring
(context-parallel) attention, all vs the same CPU oracles as the kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattention_kernel_project_tpu import ops, parallel
from flashattention_kernel_project_tpu.utils import oracles
from flashattention_kernel_project_tpu.utils.testing import assert_rel_l2


@pytest.fixture(scope="module")
def mesh8():
    return parallel.make_mesh({"model": 8})


@pytest.fixture(scope="module")
def mesh_2x4():
    return parallel.make_mesh({"data": 2, "model": 4})


@pytest.mark.smoke
def test_head_sharded_attention(rng, mesh8):
    b, hq, hkv, n, d = 2, 16, 8, 128, 32
    q = rng.standard_normal((b, hq, n, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, n, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, n, d), dtype=np.float32)
    fn = parallel.head_sharded_attention(mesh8, causal=True)
    got = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    exp = oracles.gqa_attention(q, k, v, causal=True)
    assert_rel_l2(got, exp, tol=1e-2)


def test_head_sharded_attention_2d_mesh(rng, mesh_2x4):
    b, hq, hkv, n, d = 4, 8, 4, 64, 32
    q = rng.standard_normal((b, hq, n, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, n, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, n, d), dtype=np.float32)
    fn = parallel.head_sharded_attention(mesh_2x4, causal=True)
    got = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    exp = oracles.gqa_attention(q, k, v, causal=True)
    assert_rel_l2(got, exp, tol=1e-2)


def test_head_sharded_decode(rng, mesh8):
    b, hq, hkv, s, d = 2, 16, 8, 96, 32
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    lengths = np.array([96, 41], dtype=np.int32)
    fn = parallel.head_sharded_decode(mesh8, n_splits=2)
    got = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths))
    exp = np.concatenate(
        [
            oracles.gqa_attention(
                q[i : i + 1, :, None, :], k[i : i + 1, :, : lengths[i]],
                v[i : i + 1, :, : lengths[i]],
            )[:, :, 0]
            for i in range(b)
        ],
        axis=0,
    )
    assert_rel_l2(got, exp, tol=1e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention(rng, causal):
    mesh = parallel.make_mesh({"sp": 8})
    b, h, n, d = 1, 4, 256, 32  # 32 tokens per shard
    q = rng.standard_normal((b, h, n, d), dtype=np.float32)
    k = rng.standard_normal((b, h, n, d), dtype=np.float32)
    v = rng.standard_normal((b, h, n, d), dtype=np.float32)
    fn = parallel.ring_attention(
        mesh, causal=causal, data_axis=None
    )
    got = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    exp = oracles.gqa_attention(q, k, v, causal=causal)
    assert_rel_l2(got, exp, tol=1e-2)


def test_ring_attention_matches_single_device_kernel(rng):
    """Ring over 4 shards == the fused kernel on one device."""
    mesh = parallel.make_mesh({"sp": 4}, devices=jax.devices()[:4])
    b, h, n, d = 2, 2, 128, 32
    q = rng.standard_normal((b, h, n, d), dtype=np.float32)
    k = rng.standard_normal((b, h, n, d), dtype=np.float32)
    v = rng.standard_normal((b, h, n, d), dtype=np.float32)
    ring = parallel.ring_attention(
        mesh, causal=True, data_axis=None
    )(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    single = ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
    )
    assert_rel_l2(ring, np.asarray(single), tol=1e-3)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention(rng, causal):
    mesh = parallel.make_mesh({"sp": 4}, devices=jax.devices()[:4])
    b, h, n, d = 1, 8, 128, 32  # 8 heads over 4 devices, 32 tokens/shard
    q = rng.standard_normal((b, h, n, d), dtype=np.float32)
    k = rng.standard_normal((b, h, n, d), dtype=np.float32)
    v = rng.standard_normal((b, h, n, d), dtype=np.float32)
    fn = parallel.ulysses_attention(
        mesh, causal=causal, data_axis=None
    )
    got = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    exp = oracles.gqa_attention(q, k, v, causal=causal)
    assert_rel_l2(got, exp, tol=1e-2)


@pytest.mark.smoke
def test_merge_normalized_identity():
    """Merging with an empty partial is the identity."""
    o = jnp.ones((2, 3, 4, 8))
    lse = jnp.zeros((2, 3, 4))
    from flashattention_kernel_project_tpu.ops.softmax import NEG_INF

    o_e = jnp.zeros_like(o)
    lse_e = jnp.full_like(lse, NEG_INF)
    o2, lse2 = parallel.merge_normalized(o, lse, o_e, lse_e)
    np.testing.assert_allclose(np.asarray(o2), np.asarray(o), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(lse2), np.asarray(lse), rtol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_kv_quant(rng, causal):
    """Ring over int8 KV shards (values + per-token scales rotate) vs the
    single-device fused-dequant kernel AND the dequantized-cache oracle."""
    mesh = parallel.make_mesh({"sp": 8})
    b, h, n, d = 1, 4, 256, 32
    q = rng.standard_normal((b, h, n, d), dtype=np.float32)
    k = rng.standard_normal((b, h, n, d), dtype=np.float32)
    v = rng.standard_normal((b, h, n, d), dtype=np.float32)
    k_q, k_s, v_q, v_s = ops.quantize_kv(jnp.asarray(k), jnp.asarray(v))

    fn = parallel.ring_attention_kv_quant(
        mesh, causal=causal, data_axis=None
    )
    got = np.asarray(fn(jnp.asarray(q), k_q, k_s, v_q, v_s))

    single = ops.flash_attention_kv_quant(
        jnp.asarray(q), k_q, k_s, v_q, v_s, causal=causal,
    )
    assert_rel_l2(got, np.asarray(single), tol=1e-3)

    kd = np.asarray(k_q, np.float32) * np.asarray(k_s, np.float32)
    vd = np.asarray(v_q, np.float32) * np.asarray(v_s, np.float32)
    exp = oracles.gqa_attention(q, kd, vd, causal=causal)
    assert_rel_l2(got, exp, tol=1e-2)


def test_head_sharded_decode_quant(rng, mesh8):
    """TP decode over an int8 head-sharded cache: each chip's shard stays
    8-bit; vs the dequantized-cache oracle."""
    b, hq, hkv, s, d = 2, 16, 8, 96, 32
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    lengths = np.array([96, 41], dtype=np.int32)
    k_q, k_s, v_q, v_s = ops.quantize_kv(jnp.asarray(k), jnp.asarray(v))

    fn = parallel.head_sharded_decode_quant(mesh8, n_splits=2)
    got = np.asarray(fn(
        jnp.asarray(q), k_q, k_s, v_q, v_s, jnp.asarray(lengths)
    ))
    kd = np.asarray(k_q, np.float32) * np.asarray(k_s, np.float32)
    vd = np.asarray(v_q, np.float32) * np.asarray(v_s, np.float32)
    exp = np.concatenate(
        [
            oracles.gqa_attention(
                q[i : i + 1, :, None, :], kd[i : i + 1, :, : lengths[i]],
                vd[i : i + 1, :, : lengths[i]],
            )[:, :, 0]
            for i in range(b)
        ],
        axis=0,
    )
    assert_rel_l2(got, exp, tol=1e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_trainable_grads(rng, causal):
    """Context-parallel training: value AND gradients of the differentiable
    ring must match jax.grad through the single-device fused kernel."""
    mesh = parallel.make_mesh({"sp": 4}, devices=jax.devices()[:4])
    b, h, n, d = 1, 2, 128, 32
    q = jnp.asarray(rng.standard_normal((b, h, n, d), dtype=np.float32))
    k = jnp.asarray(rng.standard_normal((b, h, n, d), dtype=np.float32))
    v = jnp.asarray(rng.standard_normal((b, h, n, d), dtype=np.float32))

    ring = parallel.ring_attention_trainable(
        mesh, causal=causal, data_axis=None
    )

    def loss_ring(q, k, v):
        o = ring(q, k, v)
        return jnp.sum(o * jnp.cos(o))

    def loss_single(q, k, v):
        o = ops.flash_attention(q, k, v, causal=causal)
        return jnp.sum(o * jnp.cos(o))

    val_r, grads_r = jax.value_and_grad(loss_ring, argnums=(0, 1, 2))(q, k, v)
    val_s, grads_s = jax.value_and_grad(loss_single, argnums=(0, 1, 2))(q, k, v)
    assert abs(float(val_r) - float(val_s)) < 1e-2 * max(1.0, abs(float(val_s)))
    for gr, gs in zip(grads_r, grads_s):
        assert_rel_l2(np.asarray(gr), np.asarray(gs), tol=1e-3)


def test_seq_sharded_decode(rng):
    """KV length sharded over the ring; gathered (m,l,y) partials merge to
    the single-device decode exactly."""
    mesh = parallel.make_mesh({"sp": 4}, devices=jax.devices()[:4])
    b, hq, hkv, s, d = 2, 8, 2, 256, 32
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    lengths = np.array([256, 100], dtype=np.int32)  # row 1 lives on 2 shards

    fn = parallel.seq_sharded_decode(mesh, data_axis=None)
    got = np.asarray(fn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths)
    ))
    single = ops.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths)
    )
    assert_rel_l2(got, np.asarray(single), tol=1e-5)


def test_ulysses_gradients(rng):
    """Ulysses (head<->seq all-to-all) is built from differentiable pieces;
    grads through it must match the single-device kernel."""
    mesh = parallel.make_mesh({"sp": 4}, devices=jax.devices()[:4])
    b, h, n, d = 1, 4, 128, 32
    q = jnp.asarray(rng.standard_normal((b, h, n, d), dtype=np.float32))
    k = jnp.asarray(rng.standard_normal((b, h, n, d), dtype=np.float32))
    v = jnp.asarray(rng.standard_normal((b, h, n, d), dtype=np.float32))
    fn = parallel.ulysses_attention(
        mesh, causal=True, data_axis=None
    )

    def loss_u(q, k, v):
        o = fn(q, k, v)
        return jnp.sum(o * jnp.cos(o))

    def loss_s(q, k, v):
        o = ops.flash_attention(q, k, v, causal=True)
        return jnp.sum(o * jnp.cos(o))

    gu = jax.grad(loss_u, argnums=(0, 1, 2))(q, k, v)
    gs = jax.grad(loss_s, argnums=(0, 1, 2))(q, k, v)
    for a, b_ in zip(gu, gs):
        assert_rel_l2(np.asarray(a), np.asarray(b_), tol=1e-3)


# ---------------------------------------------------------------------------
# Full TP serving engine (parallel/tp_engine.py): prefill/extend/decode of
# the whole transformer over the mesh vs the single-device engine.
# ---------------------------------------------------------------------------

def test_tp_engine_matches_single_device():
    from flashattention_kernel_project_tpu import models

    cfg = models.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=8, n_kv_heads=4,
        d_head=16, d_ff=64, dtype=jnp.float32,
    )
    mesh = parallel.make_mesh({"model": 4}, devices=jax.devices()[:4])
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    prefill_fn, extend_fn, decode_fn, rules = parallel.make_tp_engine(
        cfg, mesh, n_splits=2, interpret=True
    )
    sparams = parallel.shard_params(params, mesh, rules)

    prompt = jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0, 64)
    cache = parallel.init_tp_cache(cfg, mesh, 2, 48)
    logits, cache = prefill_fn(sparams, prompt, cache)

    ref_cache = models.init_cache(cfg, 2, 48)
    ref_logits, ref_cache = models.prefill(cfg, params, prompt, ref_cache)
    assert_rel_l2(np.asarray(logits), np.asarray(ref_logits), 1e-4)

    # ragged extend over the mesh
    chunk = jax.random.randint(jax.random.PRNGKey(2), (2, 4), 0, 64)
    nvec = jnp.asarray([4, 2], jnp.int32)
    logits, cache = extend_fn(sparams, chunk, cache, nvec)
    ref_logits, ref_cache = models.extend(
        cfg, params, chunk, ref_cache, n=nvec
    )
    assert_rel_l2(np.asarray(logits), np.asarray(ref_logits), 1e-4)

    # a few decode steps: sharded tokens must track the reference exactly
    cur = jnp.argmax(logits, -1).astype(jnp.int32)
    ref_cur = jnp.argmax(ref_logits, -1).astype(jnp.int32)
    for _ in range(3):
        logits, cache = decode_fn(sparams, cur, cache)
        ref_logits, ref_cache = models.decode_step(
            cfg, params, ref_cur, ref_cache, n_splits=2
        )
        assert_rel_l2(np.asarray(logits), np.asarray(ref_logits), 1e-4)
        cur = jnp.argmax(logits, -1).astype(jnp.int32)
        ref_cur = jnp.argmax(ref_logits, -1).astype(jnp.int32)
        np.testing.assert_array_equal(np.asarray(cur), np.asarray(ref_cur))
    np.testing.assert_array_equal(
        np.asarray(cache.lengths), np.asarray(ref_cache.lengths)
    )


def test_tp_engine_quantized_cache():
    """TP engine over an int8 head-sharded cache (fused dequant per shard)."""
    from flashattention_kernel_project_tpu import models

    cfg = models.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=8, n_kv_heads=4,
        d_head=16, d_ff=64, dtype=jnp.float32,
    )
    mesh = parallel.make_mesh({"model": 4}, devices=jax.devices()[:4])
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    prefill_fn, _, decode_fn, rules = parallel.make_tp_engine(
        cfg, mesh, n_splits=2, quantized_cache=True, interpret=True
    )
    sparams = parallel.shard_params(params, mesh, rules)
    prompt = jax.random.randint(jax.random.PRNGKey(3), (2, 10), 0, 64)
    cache = parallel.init_tp_cache(cfg, mesh, 2, 32, quantized=True)
    logits, cache = prefill_fn(sparams, prompt, cache)

    ref_cache = models.init_cache(cfg, 2, 32, quantized=True)
    ref_logits, ref_cache = models.prefill(cfg, params, prompt, ref_cache)
    assert_rel_l2(np.asarray(logits), np.asarray(ref_logits), 1e-4)
    cur = jnp.argmax(logits, -1).astype(jnp.int32)
    logits, cache = decode_fn(sparams, cur, cache)
    ref_logits, _ = models.decode_step(cfg, params, cur, ref_cache, n_splits=2)
    assert_rel_l2(np.asarray(logits), np.asarray(ref_logits), 1e-4)


def test_ring_attention_window(rng):
    """Sliding-window ring attention: global-position band semantics must
    match the single-device windowed kernel, with the ring truncated to
    ceil(window/shard) hops (out-of-window shards never rotate)."""
    mesh_sp4 = parallel.make_mesh({"sp": 4}, devices=jax.devices()[:4])
    b, h, d = 1, 2, 32
    n = 64 * 4  # 4 shards of 64
    q = jnp.asarray(rng.standard_normal((b, h, n, d), dtype=np.float32))
    k = jnp.asarray(rng.standard_normal((b, h, n, d), dtype=np.float32))
    v = jnp.asarray(rng.standard_normal((b, h, n, d), dtype=np.float32))
    for w in (48, 100, 200):  # < shard, spanning 2 shards, spanning 4
        fn = parallel.ring_attention(
            mesh_sp4, causal=True, data_axis=None, window=w,
        )
        out = fn(q, k, v)
        ref = ops.flash_attention(
            q, k, v, causal=True, window=w
        )
        assert_rel_l2(np.asarray(out), np.asarray(ref), 1e-5)


def test_ring_attention_kv_quant_window(rng):
    mesh_sp4 = parallel.make_mesh({"sp": 4}, devices=jax.devices()[:4])
    b, h, d = 1, 2, 32
    n = 64 * 4
    q = jnp.asarray(rng.standard_normal((b, h, n, d), dtype=np.float32))
    k = jnp.asarray(rng.standard_normal((b, h, n, d), dtype=np.float32))
    v = jnp.asarray(rng.standard_normal((b, h, n, d), dtype=np.float32))
    kq, ks, vq, vs = ops.quantize_kv(k, v)
    fn = parallel.ring_attention_kv_quant(
        mesh_sp4, causal=True, data_axis=None, window=100,
    )
    out = fn(q, kq, ks, vq, vs)
    ref = ops.flash_attention_kv_quant(
        q, kq, ks, vq, vs, causal=True, window=100,
    )
    assert_rel_l2(np.asarray(out), np.asarray(ref), 1e-5)


def test_sp_decode_engine_matches_single_device():
    """Sequence-sharded decode ENGINE step (cache length-sharded, params
    replicated, streaming-merge across chips): tokens and logits must
    track the single-device engine."""
    from flashattention_kernel_project_tpu import models
    from flashattention_kernel_project_tpu.parallel import tp_engine

    cfg = models.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=64, dtype=jnp.float32,
    )
    mesh = parallel.make_mesh({"sp": 4}, devices=jax.devices()[:4])
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    prompt = jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0, 64)

    ref_cache = models.init_cache(cfg, 2, 64)
    logits, ref_cache = models.prefill(cfg, params, prompt, ref_cache)
    # shard the prefilled cache along its length
    cache = jax.tree.map(
        lambda x, s: jax.device_put(x, jax.sharding.NamedSharding(mesh, s)),
        ref_cache, tp_engine.sp_cache_specs(cfg.n_layers),
    )
    dec = tp_engine.make_sp_decode_step(cfg, mesh, n_splits=2, interpret=True)

    cur = jnp.argmax(logits, -1).astype(jnp.int32)
    ref_cur = cur
    for _ in range(4):
        lg, cache = dec(params, cur, cache)
        ref_lg, ref_cache = models.decode_step(
            cfg, params, ref_cur, ref_cache, n_splits=2
        )
        assert_rel_l2(np.asarray(lg), np.asarray(ref_lg), 1e-4)
        cur = jnp.argmax(lg, -1).astype(jnp.int32)
        ref_cur = jnp.argmax(ref_lg, -1).astype(jnp.int32)
        np.testing.assert_array_equal(np.asarray(cur), np.asarray(ref_cur))
    np.testing.assert_array_equal(
        np.asarray(cache.lengths), np.asarray(ref_cache.lengths)
    )


def test_sp_decode_engine_quantized():
    """SP decode engine over an int8 length-sharded cache: shard-local
    token quantization + fused-dequant partials, merged across chips —
    tracks the single-device quantized decode."""
    from flashattention_kernel_project_tpu import models
    from flashattention_kernel_project_tpu.parallel import tp_engine

    cfg = models.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=64, dtype=jnp.float32,
    )
    mesh = parallel.make_mesh({"sp": 4}, devices=jax.devices()[:4])
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    prompt = jax.random.randint(jax.random.PRNGKey(2), (2, 10), 0, 64)

    ref_cache = models.init_cache(cfg, 2, 64, quantized=True)
    logits, ref_cache = models.prefill(cfg, params, prompt, ref_cache)
    cache = jax.tree.map(
        lambda x, s: jax.device_put(x, jax.sharding.NamedSharding(mesh, s)),
        ref_cache, tp_engine.sp_cache_specs(cfg.n_layers, quantized=True),
    )
    dec = tp_engine.make_sp_decode_step(
        cfg, mesh, n_splits=2, quantized_cache=True, interpret=True
    )
    cur = jnp.argmax(logits, -1).astype(jnp.int32)
    for _ in range(3):
        lg, cache = dec(params, cur, cache)
        ref_lg, ref_cache = models.decode_step(
            cfg, params, cur, ref_cache, n_splits=2
        )
        assert_rel_l2(np.asarray(lg), np.asarray(ref_lg), 1e-4)
        cur = jnp.argmax(lg, -1).astype(jnp.int32)
        ref_cur = jnp.argmax(ref_lg, -1).astype(jnp.int32)
        np.testing.assert_array_equal(np.asarray(cur), np.asarray(ref_cur))
