"""Flagship transformer: forward/loss/grad, and the decode engine vs a
full-forward reference (KV-cached generation must match teacher-forced
logits)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattention_kernel_project_tpu import models
from flashattention_kernel_project_tpu.utils.testing import assert_rel_l2

CFG = models.TransformerConfig(
    vocab_size=128,
    d_model=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    dtype=jnp.float32,
)


@pytest.fixture(scope="module")
def params():
    return models.init_params(CFG, jax.random.PRNGKey(0))


@pytest.mark.smoke
def test_forward_shapes(params):
    tokens = jnp.zeros((2, 16), jnp.int32)
    logits = models.forward(CFG, params, tokens)
    assert logits.shape == (2, 16, CFG.vocab_size)
    assert logits.dtype == jnp.float32
    assert np.isfinite(np.asarray(logits)).all()


@pytest.mark.smoke
def test_loss_and_grad(params):
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 32), 0, CFG.vocab_size)
    loss, grads = jax.value_and_grad(lambda p: models.loss_fn(CFG, p, tokens))(params)
    assert np.isfinite(float(loss))
    flat = jax.tree.leaves(grads)
    assert all(np.isfinite(np.asarray(g)).all() for g in flat)
    # loss should be near log(vocab) at init
    assert abs(float(loss) - np.log(CFG.vocab_size)) < 1.0


def test_train_step_reduces_loss(params):
    tokens = jax.random.randint(jax.random.PRNGKey(2), (4, 32), 0, CFG.vocab_size)
    p = params
    loss0 = float(models.loss_fn(CFG, p, tokens))
    for _ in range(5):
        p, loss = models.sgd_train_step(CFG, p, tokens, lr=1e-1)
    assert float(loss) < loss0


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_matches_teacher_forcing(params, quantized):
    """Greedy generation via prefill+decode_step must produce the same tokens
    as repeatedly running the full forward (the reference-oracle pattern,
    applied at the model level)."""
    prompt = jax.random.randint(jax.random.PRNGKey(3), (2, 8), 0, CFG.vocab_size)
    n_new = 6

    out = models.generate(
        CFG, params, prompt, max_new_tokens=n_new, quantized_cache=quantized,
        n_splits=2,
    )
    assert out.shape == (2, 8 + n_new)

    # full-forward reference decode (no cache)
    ref = prompt
    for _ in range(n_new):
        logits = models.forward(CFG, params, ref)
        nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        ref = jnp.concatenate([ref, nxt[:, None]], axis=1)

    if quantized:
        # int8 cache may legitimately flip a late token once logits are
        # near-tied; require the first few decoded tokens to match.
        np.testing.assert_array_equal(np.asarray(out)[:, :11], np.asarray(ref)[:, :11])
    else:
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_int8_weight_decode_close_to_fp(params):
    """decode_step with int8 weight-only params (fused-dequant matmul) must
    track the full-precision decode logits closely and produce the same
    greedy token at a confident step."""
    prompt = jax.random.randint(jax.random.PRNGKey(5), (2, 8), 0, CFG.vocab_size)
    cache = models.init_cache(CFG, 2, 32)
    logits, cache = models.prefill(CFG, params, prompt, cache)
    nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)

    fused = models.fuse_decode_params(CFG, params)
    q8 = models.quantize_decode_params(CFG, fused)
    lf, _ = models.decode_step(CFG, fused, nxt, cache)
    lq, _ = models.decode_step(CFG, q8, nxt, cache)
    assert_rel_l2(lq, np.asarray(lf), tol=5e-2)
    # the greedy token must survive quantization on this (deterministic)
    # fixture — a logits perturbation big enough to flip the argmax here
    # is a real regression even if it sneaks under the rel-L2 gate
    np.testing.assert_array_equal(
        np.argmax(np.asarray(lq), -1), np.argmax(np.asarray(lf), -1)
    )


def test_generate_int8_weights(params):
    prompt = jax.random.randint(jax.random.PRNGKey(6), (1, 6), 0, CFG.vocab_size)
    out = models.generate(
        CFG, params, prompt, max_new_tokens=4, int8_weights=True
    )
    assert out.shape == (1, 10)
    assert np.asarray(out)[:, :6].tolist() == np.asarray(prompt).tolist()


def test_sampling_top_k_top_p():
    """top-k keeps only the k best tokens; top-p keeps the smallest nucleus
    (and always contains the argmax)."""
    from flashattention_kernel_project_tpu.models.engine import _sample

    logits = jnp.log(jnp.asarray([[0.5, 0.3, 0.15, 0.05]], jnp.float32))
    key = jax.random.PRNGKey(0)
    # top_k=2: only tokens {0, 1} can appear
    draws = {
        int(_sample(logits, 1.0, jax.random.fold_in(key, i), i, top_k=2)[0])
        for i in range(64)
    }
    assert draws <= {0, 1} and len(draws) == 2
    # top_p=0.6: nucleus is {0, 1} (0.5 < 0.6 <= 0.8)
    draws_p = {
        int(_sample(logits, 1.0, jax.random.fold_in(key, i), i, top_p=0.6)[0])
        for i in range(64)
    }
    assert draws_p <= {0, 1} and len(draws_p) == 2
    # top_p tiny: degenerates to greedy (argmax always kept)
    draws_g = {
        int(_sample(logits, 1.0, jax.random.fold_in(key, i), i, top_p=1e-6)[0])
        for i in range(16)
    }
    assert draws_g == {0}


def test_extend_chunked_prefill_matches_full(params):
    """prefill(first chunk) + extend(second chunk) == forward(full prompt),
    and subsequent decode from the extended cache stays correct."""
    tokens = jax.random.randint(jax.random.PRNGKey(7), (2, 24), 0, CFG.vocab_size)
    cache = models.init_cache(CFG, 2, 64)
    _, cache = models.prefill(CFG, params, tokens[:, :16], cache)
    logits, cache = models.extend(CFG, params, tokens[:, 16:], cache)

    full = models.forward(CFG, params, tokens)
    assert_rel_l2(logits, np.asarray(full)[:, -1], tol=1e-3)
    assert np.all(np.asarray(cache.lengths) == 24)

    # one decode step from the chunk-built cache
    nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    logits2, _ = models.decode_step(CFG, params, nxt, cache, n_splits=2)
    full2 = models.forward(
        CFG, params, jnp.concatenate([tokens, nxt[:, None]], axis=1)
    )
    assert_rel_l2(logits2, np.asarray(full2)[:, -1], tol=1e-3)


def test_prefill_logits_match_forward(params):
    tokens = jax.random.randint(jax.random.PRNGKey(4), (2, 12), 0, CFG.vocab_size)
    cache = models.init_cache(CFG, 2, 32)
    logits, cache2 = models.prefill(CFG, params, tokens, cache)
    full = models.forward(CFG, params, tokens)
    assert_rel_l2(logits, np.asarray(full)[:, -1], tol=1e-3)
    assert np.all(np.asarray(cache2.lengths) == 12)


def test_extend_quantized_cache(params):
    """Chunked prefill against an int8 cache runs the fused-dequant ragged
    kernel (no HBM dequant copy) and must track the full-precision forward
    within int8-cache error."""
    tokens = jax.random.randint(jax.random.PRNGKey(9), (2, 24), 0, CFG.vocab_size)
    cache = models.init_cache(CFG, 2, 64, quantized=True)
    _, cache = models.prefill(CFG, params, tokens[:, :16], cache)
    logits, cache = models.extend(CFG, params, tokens[:, 16:], cache)

    full = models.forward(CFG, params, tokens)
    assert_rel_l2(logits, np.asarray(full)[:, -1], tol=5e-2)
    assert np.all(np.asarray(cache.lengths) == 24)


def test_fp8_linear_cache_decode_and_extend(params):
    """fp8_e4m3 linear cache: generate and chunked prefill both route
    through the fused-dequant kernels and track full precision."""
    prompt = jax.random.randint(jax.random.PRNGKey(11), (2, 8), 0, CFG.vocab_size)
    out = models.generate(
        CFG, params, prompt, max_new_tokens=4, quantized_cache=True,
        quant_fmt="fp8",
    )
    ref = prompt
    for _ in range(4):
        logits = models.forward(CFG, params, ref)
        nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        ref = jnp.concatenate([ref, nxt[:, None]], axis=1)
    # e4m3 (~2 mantissa digits) flips near-tied tokens earlier than int8:
    # require the first generated token; later ones may legitimately diverge
    np.testing.assert_array_equal(
        np.asarray(out)[:, :9], np.asarray(ref)[:, :9]
    )

    tokens = jax.random.randint(jax.random.PRNGKey(12), (2, 24), 0, CFG.vocab_size)
    cache = models.init_cache(CFG, 2, 64, quantized=True, quant_fmt="fp8")
    assert cache.quantized and cache.k[0].dtype == jnp.float8_e4m3fn
    _, cache = models.prefill(CFG, params, tokens[:, :16], cache)
    logits, cache = models.extend(CFG, params, tokens[:, 16:], cache)
    full = models.forward(CFG, params, tokens)
    assert_rel_l2(logits, np.asarray(full)[:, -1], tol=5e-2)


def test_sliding_window_decode_matches_teacher_forcing():
    """attn_window wired end to end: windowed generate must equal the
    windowed full-forward reference (prefill kernel band == decode band)."""
    cfg = dataclasses.replace(CFG, attn_window=12)
    params = models.init_params(cfg, jax.random.PRNGKey(13))
    prompt = jax.random.randint(jax.random.PRNGKey(14), (2, 20), 0, cfg.vocab_size)
    n_new = 5

    out = models.generate(cfg, params, prompt, max_new_tokens=n_new)
    ref = prompt
    for _ in range(n_new):
        logits = models.forward(cfg, params, ref)
        nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        ref = jnp.concatenate([ref, nxt[:, None]], axis=1)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_window_sinks_decode_matches_teacher_forcing():
    """attn_window + attn_sinks end to end: generate == teacher forcing."""
    cfg = dataclasses.replace(CFG, attn_window=10, attn_sinks=4)
    params = models.init_params(cfg, jax.random.PRNGKey(15))
    prompt = jax.random.randint(jax.random.PRNGKey(16), (2, 20), 0, cfg.vocab_size)
    out = models.generate(cfg, params, prompt, max_new_tokens=5)
    ref = prompt
    for _ in range(5):
        logits = models.forward(cfg, params, ref)
        nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        ref = jnp.concatenate([ref, nxt[:, None]], axis=1)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


@pytest.mark.parametrize("same_draft", [True, False])
def test_speculative_generate_matches_greedy(params, same_draft):
    """Greedy speculative decoding must produce EXACTLY the target model's
    greedy continuation — with a perfect draft (same model, high
    acceptance) and with an unrelated random draft (low acceptance)."""
    prompt = jax.random.randint(jax.random.PRNGKey(17), (2, 8), 0, CFG.vocab_size)
    n_new = 10
    if same_draft:
        draft_cfg, draft_params = CFG, params
    else:
        draft_cfg = dataclasses.replace(CFG, n_layers=1, d_ff=64)
        draft_params = models.init_params(draft_cfg, jax.random.PRNGKey(99))

    out = models.speculative_generate(
        CFG, params, prompt,
        draft_cfg=draft_cfg, draft_params=draft_params,
        spec_k=3, max_new_tokens=n_new,
    )
    ref = models.generate(CFG, params, prompt, max_new_tokens=n_new)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_speculative_accept_preserves_target_dist():
    """The rejection-sampling rule must make the FIRST committed token's
    marginal exactly the target dist p[0], whatever the draft dist is —
    the distribution-preservation theorem, checked empirically."""
    rng = np.random.default_rng(3)
    V, k = 6, 2
    p = rng.dirichlet(np.ones(V), size=k + 1)  # target dists per position
    q = rng.dirichlet(np.ones(V) * 0.3, size=k)  # skewed draft dists
    n = 20000
    hist = np.zeros(V)
    for _ in range(n):
        d = [rng.choice(V, p=q[j]) for j in range(k)]
        take = models.speculative_accept(p, q, np.array(d), rng)
        hist[take[0]] += 1
    tv = 0.5 * np.abs(hist / n - p[0]).sum()
    assert tv < 0.03, (tv, hist / n, p[0])


def test_speculative_accept_perfect_draft():
    """q == p accepts every draft: always k+1 committed tokens."""
    rng = np.random.default_rng(4)
    V, k = 8, 3
    p = rng.dirichlet(np.ones(V), size=k + 1)
    for _ in range(200):
        d = np.array([rng.choice(V, p=p[j]) for j in range(k)])
        take = models.speculative_accept(p, p[:k], d, rng)
        assert len(take) == k + 1
        assert take[:k] == list(d)


def test_speculative_generate_sampling(params):
    """temperature>0 spec decode: deterministic given the key, valid
    tokens, and a same-model draft still yields a sane stream."""
    prompt = jax.random.randint(jax.random.PRNGKey(21), (2, 8), 0, CFG.vocab_size)
    draft_cfg = dataclasses.replace(CFG, n_layers=1, d_ff=64)
    draft_params = models.init_params(draft_cfg, jax.random.PRNGKey(98))
    kw = dict(
        draft_cfg=draft_cfg, draft_params=draft_params,
        spec_k=3, max_new_tokens=12, temperature=0.8,
        key=jax.random.PRNGKey(5),
    )
    out1 = models.speculative_generate(CFG, params, prompt, **kw)
    out2 = models.speculative_generate(CFG, params, prompt, **kw)
    assert out1.shape == (2, 8 + 12)
    np.testing.assert_array_equal(np.asarray(out1), np.asarray(out2))
    assert (np.asarray(out1) >= 0).all() and (np.asarray(out1) < CFG.vocab_size).all()


def test_extend_ragged_n_matches_exact_prefill(params):
    """engine.extend with per-slot n: padded ragged chunks must yield the
    same logits and cache state as exact-length prefill per slot."""
    lens = [5, 4]
    prompts = [
        jax.random.randint(jax.random.PRNGKey(30 + i), (n,), 0, CFG.vocab_size)
        for i, n in enumerate(lens)
    ]
    chunk_c = 4
    b = len(prompts)
    cache = models.init_cache(CFG, b, 32)
    # feed in two ragged chunks of width 4: slot0 n=(4,1), slot1 n=(3,1)->
    # use per-chunk n vectors covering uneven raggedness
    n1 = np.array([4, 3], np.int32)
    c1 = np.zeros((b, chunk_c), np.int32)
    for i in range(b):
        c1[i, : n1[i]] = np.asarray(prompts[i][: n1[i]])
    logits1, cache = models.extend(
        CFG, params, jnp.asarray(c1), cache, n=jnp.asarray(n1)
    )
    n2 = np.array([1, 1], np.int32)  # hold the second slot at 1 more too
    c2 = np.zeros((b, chunk_c), np.int32)
    for i in range(b):
        rest = np.asarray(prompts[i][n1[i] : n1[i] + n2[i]])
        c2[i, : len(rest)] = rest
    logits2, cache = models.extend(
        CFG, params, jnp.asarray(c2), cache, n=jnp.asarray(n2)
    )
    np.testing.assert_array_equal(
        np.asarray(cache.lengths), np.array([5, 4], np.int32)
    )
    # reference: exact-length batch-1 prefill of each slot's fed prefix
    for i, total in enumerate([5, 4]):
        ref_cache = models.init_cache(CFG, 1, 32)
        ref_logits, ref_cache = models.prefill(
            CFG, params, jnp.asarray(prompts[i][None, :total]), ref_cache
        )
        assert_rel_l2(
            np.asarray(logits2[i]), np.asarray(ref_logits[0]), 2e-5
        )
        for l in range(CFG.n_layers):
            assert_rel_l2(
                np.asarray(cache.k[l][i, :, :total]),
                np.asarray(ref_cache.k[l][0, :, :total]),
                2e-5,
            )


def test_fp8_weight_decode_close_to_fp(params):
    """fp8(e4m3) weight-only decode params track full precision like the
    int8 path (same fused-dequant epilogue, fp8 storage)."""
    prompt = jax.random.randint(jax.random.PRNGKey(40), (2, 8), 0, CFG.vocab_size)
    cache = models.init_cache(CFG, 2, 32)
    logits, cache = models.prefill(CFG, params, prompt, cache)
    nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    fused = models.fuse_decode_params(CFG, params)
    q8 = models.quantize_decode_params(CFG, fused, fmt="fp8")
    assert q8["layers"]["wqkv_q"].dtype == jnp.float8_e4m3fn
    lf, _ = models.decode_step(CFG, fused, nxt, cache)
    lq, _ = models.decode_step(CFG, q8, nxt, cache)
    # e4m3's 3-bit mantissa is coarser than int8-with-per-column-scale
    # (~6% vs ~0.8% weight error) — the logits gate reflects that
    assert_rel_l2(lq, np.asarray(lf), tol=1.2e-1)
    np.testing.assert_array_equal(
        np.argmax(np.asarray(lq), -1), np.argmax(np.asarray(lf), -1)
    )
