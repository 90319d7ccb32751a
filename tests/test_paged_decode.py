"""Paged-KV decode (tiles gathered through block tables) vs the linear oracle."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from flashattention_kernel_project_tpu import ops
from flashattention_kernel_project_tpu.utils import oracles
from flashattention_kernel_project_tpu.utils.testing import assert_rel_l2


def _paged_from_linear(k_lin, v_lin, page_size, pool, max_pages, n_pages):
    """Scatter linear [B,Hkv,S,D] caches into pages; returns pages + tables."""
    b, hkv, s, d = k_lin.shape
    k_pages = np.zeros((n_pages, hkv, page_size, d), k_lin.dtype)
    v_pages = np.zeros_like(k_pages)
    tables = np.zeros((b, max_pages), np.int32)
    for i in range(b):
        n_needed = -(-s // page_size)
        pages = pool.alloc(n_needed)
        tables[i] = pool.table_for(pages, max_pages)
        for j, pid in enumerate(pages):
            lo = j * page_size
            hi = min(lo + page_size, s)
            k_pages[pid, :, : hi - lo] = k_lin[i, :, lo:hi]
            v_pages[pid, :, : hi - lo] = v_lin[i, :, lo:hi]
    return k_pages, v_pages, tables


@pytest.mark.parametrize("page", [128, 16])
@pytest.mark.smoke
def test_paged_decode_matches_oracle(rng, page):
    """One page per tile (128) and several pages gathered per tile (16)."""
    b, hq, hkv, s, d = 3, 8, 2, 640, 64
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    lengths = np.array([640, 333, 1], np.int32)

    max_pages = -(-s // page)
    n_pages = b * max_pages + 1
    pool = ops.PagePool(n_pages)
    kp, vp, tables = _paged_from_linear(k, v, page, pool, max_pages, n_pages)
    got = ops.paged_flash_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lengths),
    )
    for i in range(b):
        exp = oracles.gqa_attention(
            q[i : i + 1, :, None],
            k[i : i + 1, :, : lengths[i]],
            v[i : i + 1, :, : lengths[i]],
            causal=False,
        )[:, :, 0]
        assert_rel_l2(np.asarray(got)[i : i + 1], exp, tol=1e-2)


def test_paged_decode_shuffled_pages(rng):
    """Pages deliberately allocated out of order: the block table is the
    only thing holding sequence order."""
    b, hq, hkv, s, d, page = 2, 4, 2, 384, 32, 128
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    lengths = np.array([384, 200], np.int32)

    n_pages = 16
    k_pages = np.zeros((n_pages, hkv, page, d), np.float32)
    v_pages = np.zeros_like(k_pages)
    # scrambled page ids
    ids = [[7, 3, 11], [12, 5, 9]]
    tables = np.zeros((b, 4), np.int32)
    for i in range(b):
        tables[i, :3] = ids[i]
        for j, pid in enumerate(ids[i]):
            lo = j * page
            k_pages[pid, :, : min(page, s - lo)] = k[i, :, lo : lo + page]
            v_pages[pid, :, : min(page, s - lo)] = v[i, :, lo : lo + page]
    got = ops.paged_flash_decode(
        jnp.asarray(q), jnp.asarray(k_pages), jnp.asarray(v_pages),
        jnp.asarray(tables), jnp.asarray(lengths),
    )
    for i in range(b):
        exp = oracles.gqa_attention(
            q[i : i + 1, :, None],
            k[i : i + 1, :, : lengths[i]],
            v[i : i + 1, :, : lengths[i]],
            causal=False,
        )[:, :, 0]
        assert_rel_l2(np.asarray(got)[i : i + 1], exp, tol=1e-2)


def test_paged_append_then_decode(rng):
    """Token-by-token appends through paged_append reproduce the linear
    cache decode exactly."""
    b, hq, hkv, d, page = 2, 4, 2, 32, 128
    steps = 130  # crosses a page boundary
    pool = ops.PagePool(16)
    n_pages = 16
    k_pages = jnp.zeros((n_pages, hkv, page, d), jnp.float32)
    v_pages = jnp.zeros_like(k_pages)
    tables = np.zeros((b, 4), np.int32)
    pages = [pool.alloc(2) for _ in range(b)]
    for i in range(b):
        tables[i, :2] = pages[i]
    k_lin = np.zeros((b, hkv, steps, d), np.float32)
    v_lin = np.zeros_like(k_lin)
    lengths = np.zeros((b,), np.int32)
    for t in range(steps):
        k_new = rng.standard_normal((b, hkv, d), dtype=np.float32)
        v_new = rng.standard_normal((b, hkv, d), dtype=np.float32)
        k_lin[:, :, t] = k_new
        v_lin[:, :, t] = v_new
        k_pages, v_pages = ops.paged_append(
            k_pages, v_pages, jnp.asarray(k_new), jnp.asarray(v_new),
            jnp.asarray(tables), jnp.asarray(lengths),
        )
        lengths += 1
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    got = ops.paged_flash_decode(
        jnp.asarray(q), k_pages, v_pages, jnp.asarray(tables),
        jnp.asarray(lengths),
    )
    exp_all = ops.flash_decode(
        jnp.asarray(q), jnp.asarray(k_lin), jnp.asarray(v_lin),
        jnp.asarray(lengths),
    )
    assert_rel_l2(np.asarray(got), np.asarray(exp_all), tol=1e-3)


@pytest.mark.smoke
def test_page_pool():
    pool = ops.PagePool(8)
    a = pool.alloc(3)
    assert len(set(a)) == 3 and 0 not in a
    assert pool.free_pages == 4
    pool.free(a)
    assert pool.free_pages == 7
    with pytest.raises(MemoryError):
        pool.alloc(100)


def test_engine_paged_decode_matches_linear(rng):
    """Full model: linear-cache decode_step and paged decode_step produce
    the same logits after identical prefill."""
    import jax
    from flashattention_kernel_project_tpu import models
    from flashattention_kernel_project_tpu.models import engine

    cfg = models.TransformerConfig(
        vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=128, dtype=jnp.float32,
    )
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    b, t = 2, 48
    prompt = jax.random.randint(jax.random.PRNGKey(1), (b, t), 0, 128)

    lin = engine.init_cache(cfg, b, 256)
    logits_lin, lin = engine.prefill(cfg, params, prompt, lin)

    pool = ops.PagePool(32)
    paged = engine.init_paged_cache(cfg, b, 32, page_size=128,
                                    max_pages_per_seq=4)
    for i in range(b):
        pages = pool.alloc(2)  # room to decode past the prefix
        row = jnp.asarray(pool.table_for(pages, 4))
        k_seq = tuple(lin.k[li][i] for li in range(cfg.n_layers))
        v_seq = tuple(lin.v[li][i] for li in range(cfg.n_layers))
        paged = engine.paged_insert(paged, i, row, k_seq, v_seq, t)

    tok = jnp.argmax(logits_lin, -1).astype(jnp.int32)
    for step in range(3):
        l1, lin = engine.decode_step(cfg, params, tok, lin)
        l2, paged = engine.decode_step_paged(cfg, params, tok, paged)
        np.testing.assert_allclose(
            np.asarray(l1), np.asarray(l2), rtol=2e-4, atol=2e-4
        )
        tok = jnp.argmax(l1, -1).astype(jnp.int32)


@pytest.mark.parametrize("page", [128, 32])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_paged_decode_quant_matches_dequant_oracle(rng, fmt, page):
    """8-bit page pool with per-token scale pages vs the oracle on the
    dequantized cache."""
    b, hq, hkv, s, d = 3, 8, 2, 640, 64
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    lengths = np.array([640, 333, 1], np.int32)

    k_q, k_s, v_q, v_s = ops.quantize_kv(
        jnp.asarray(k), jnp.asarray(v), fmt=fmt
    )
    max_pages = -(-s // page)
    n_pages = b * max_pages + 1
    pool = ops.PagePool(n_pages)
    kp, vp, tables = _paged_from_linear(
        np.asarray(k_q), np.asarray(v_q), page, pool, max_pages, n_pages
    )
    # scatter the scales into scale pages using the same tables
    ksp = np.zeros((n_pages, hkv, page, 1), np.float32)
    vsp = np.zeros_like(ksp)
    for i in range(b):
        for j, pid in enumerate(tables[i]):
            lo, hi = j * page, min((j + 1) * page, s)
            if lo >= s or (j > 0 and pid == 0):
                break
            ksp[pid, :, : hi - lo] = np.asarray(k_s)[i, :, lo:hi]
            vsp[pid, :, : hi - lo] = np.asarray(v_s)[i, :, lo:hi]

    got = ops.paged_flash_decode_quant(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(ksp),
        jnp.asarray(vp), jnp.asarray(vsp),
        jnp.asarray(tables), jnp.asarray(lengths),
    )
    kd = np.asarray(k_q, np.float32) * np.asarray(k_s, np.float32)
    vd = np.asarray(v_q, np.float32) * np.asarray(v_s, np.float32)
    for i in range(b):
        exp = oracles.gqa_attention(
            q[i : i + 1, :, None],
            kd[i : i + 1, :, : lengths[i]],
            vd[i : i + 1, :, : lengths[i]],
            causal=False,
        )[:, :, 0]
        assert_rel_l2(np.asarray(got)[i : i + 1], exp, tol=1e-2)


def test_paged_append_quant_roundtrip(rng):
    """Append tokens one at a time into an int8 pool, then decode: must match
    decoding the same tokens from a bf16 linear reference within int8 error."""
    b, hq, hkv, d, page = 2, 4, 2, 32, 128
    n_pages, max_pages = 8, 2
    k_pages = jnp.zeros((n_pages, hkv, page, d), jnp.int8)
    v_pages = jnp.zeros_like(k_pages)
    ksp = jnp.zeros((n_pages, hkv, page, 1), jnp.float32)
    vsp = jnp.zeros_like(ksp)
    pool = ops.PagePool(n_pages)
    tables = np.stack([
        pool.table_for(pool.alloc(1), max_pages) for _ in range(b)
    ])
    tables = jnp.asarray(tables)

    n_tok = 5
    ks = rng.standard_normal((n_tok, b, hkv, d)).astype(np.float32)
    vs = rng.standard_normal((n_tok, b, hkv, d)).astype(np.float32)
    lengths = jnp.zeros((b,), jnp.int32)
    for t in range(n_tok):
        k_pages, ksp, v_pages, vsp = ops.paged_append_quant(
            k_pages, ksp, v_pages, vsp,
            jnp.asarray(ks[t]), jnp.asarray(vs[t]), tables, lengths,
        )
        lengths = lengths + 1

    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    got = ops.paged_flash_decode_quant(
        jnp.asarray(q), k_pages, ksp, v_pages, vsp, tables, lengths,
    )
    k_lin = np.moveaxis(ks, 0, 2)  # [B, Hkv, T, D]
    v_lin = np.moveaxis(vs, 0, 2)
    for i in range(b):
        exp = oracles.gqa_attention(
            q[i : i + 1, :, None], k_lin[i : i + 1], v_lin[i : i + 1],
            causal=False,
        )[:, :, 0]
        assert_rel_l2(np.asarray(got)[i : i + 1], exp, tol=2e-2)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_engine_paged_decode_quantized(rng, fmt):
    """Full model on an 8-bit page pool (int8 and fp8): quantized paged
    decode must track the full-precision linear-cache decode within
    8-bit-cache error."""
    import jax
    from flashattention_kernel_project_tpu import models
    from flashattention_kernel_project_tpu.models import engine
    from flashattention_kernel_project_tpu.utils.testing import rel_l2

    cfg = models.TransformerConfig(
        vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=128, dtype=jnp.float32,
    )
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    b, t = 2, 48
    prompt = jax.random.randint(jax.random.PRNGKey(1), (b, t), 0, 128)

    lin = engine.init_cache(cfg, b, 256)
    logits_lin, lin = engine.prefill(cfg, params, prompt, lin)

    pool = ops.PagePool(32)
    paged = engine.init_paged_cache(
        cfg, b, 32, page_size=128, max_pages_per_seq=4, quantized=True,
        quant_fmt=fmt,
    )
    assert paged.quantized
    for i in range(b):
        pages = pool.alloc(2)
        row = jnp.asarray(pool.table_for(pages, 4))
        k_seq = tuple(lin.k[li][i] for li in range(cfg.n_layers))
        v_seq = tuple(lin.v[li][i] for li in range(cfg.n_layers))
        paged = engine.paged_insert(paged, i, row, k_seq, v_seq, t)

    tok = jnp.argmax(logits_lin, -1).astype(jnp.int32)
    for step in range(3):
        l1, lin = engine.decode_step(cfg, params, tok, lin)
        l2, paged = engine.decode_step_paged(cfg, params, tok, paged)
        assert rel_l2(np.asarray(l2), np.asarray(l1)) < 5e-2
        tok = jnp.argmax(l1, -1).astype(jnp.int32)


def test_paged_extend_matches_causal_oracle(rng):
    """Multi-token causal extend over pages: chunk token t of every slot
    attends exactly [0, old_len + t] — the paged speculative-verify step
    (reference has no analog; vLLM-layer per BASELINE north star)."""
    b, hq, hkv, d, page = 2, 4, 2, 32, 128
    t = 4
    old = np.array([130, 7], np.int32)  # crosses a page boundary / tiny
    s_max = int(old.max()) + t
    k_lin = rng.standard_normal((b, hkv, s_max, d)).astype(np.float32)
    v_lin = rng.standard_normal((b, hkv, s_max, d)).astype(np.float32)
    q = rng.standard_normal((b, hq, t, d)).astype(np.float32)

    pool = ops.PagePool(16)
    kp, vp, tables = _paged_from_linear(k_lin, v_lin, page, pool, 4, 16)
    got = ops.paged_flash_extend(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(old + t), jnp.asarray(old),
    )
    for i in range(b):
        s_i = int(old[i]) + t
        exp = oracles.gqa_attention(
            q[i : i + 1],
            k_lin[i : i + 1, :, :s_i],
            v_lin[i : i + 1, :, :s_i],
            causal=True,
            q_offset=int(old[i]),
        )
        assert_rel_l2(np.asarray(got)[i : i + 1], exp, tol=1e-2)


def test_engine_extend_paged_matches_linear_extend(rng):
    """Full model: extend_paged (paged speculative verify) produces the
    same all-position logits and advanced cache as the linear-cache
    engine.extend(all_logits=True)."""
    import jax
    from flashattention_kernel_project_tpu import models
    from flashattention_kernel_project_tpu.models import engine

    cfg = models.TransformerConfig(
        vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=128, dtype=jnp.float32,
    )
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    b, t0, t = 2, 48, 4
    prompt = jax.random.randint(jax.random.PRNGKey(1), (b, t0), 0, 128)

    lin = engine.init_cache(cfg, b, 256)
    logits_lin, lin = engine.prefill(cfg, params, prompt, lin)

    pool = ops.PagePool(32)
    paged = engine.init_paged_cache(cfg, b, 32, page_size=128,
                                    max_pages_per_seq=4)
    for i in range(b):
        pages = pool.alloc(2)
        row = jnp.asarray(pool.table_for(pages, 4))
        k_seq = tuple(lin.k[li][i] for li in range(cfg.n_layers))
        v_seq = tuple(lin.v[li][i] for li in range(cfg.n_layers))
        paged = engine.paged_insert(paged, i, row, k_seq, v_seq, t0)

    chunk = jax.random.randint(jax.random.PRNGKey(2), (b, t), 0, 128)
    l1, lin = engine.extend(cfg, params, chunk, lin, all_logits=True)
    l2, paged = engine.extend_paged(cfg, params, chunk, paged)
    np.testing.assert_allclose(
        np.asarray(l1), np.asarray(l2), rtol=3e-4, atol=3e-4
    )
    assert np.array_equal(np.asarray(paged.lengths), np.asarray(lin.lengths))
    # and a follow-up single-token decode still agrees (cache state intact)
    tok = jnp.argmax(l1[:, -1], -1).astype(jnp.int32)
    d1, lin = engine.decode_step(cfg, params, tok, lin)
    d2, paged = engine.decode_step_paged(cfg, params, tok, paged)
    np.testing.assert_allclose(
        np.asarray(d1), np.asarray(d2), rtol=3e-4, atol=3e-4
    )
