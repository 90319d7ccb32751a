"""Continuous-batching scheduler: staggered arrivals must produce the same
tokens as isolated generation (the batch is invisible to each request)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattention_kernel_project_tpu import models
from flashattention_kernel_project_tpu.models.serving import Scheduler

CFG = models.TransformerConfig(
    vocab_size=64,
    d_model=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    dtype=jnp.float32,
)


def _isolated_reference(params, prompt, n_new):
    ref = jnp.asarray(prompt[None, :], jnp.int32)
    for _ in range(n_new):
        logits = models.forward(CFG, params, ref)
        nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        ref = jnp.concatenate([ref, nxt[:, None]], axis=1)
    return list(np.asarray(ref)[0, prompt.shape[0]:])


@pytest.mark.smoke
def test_scheduler_matches_isolated_generation():
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    sched = Scheduler(CFG, params, max_batch=3, max_len=128)

    prompts = [
        rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
        for n in (5, 9, 3, 12)  # 4 requests > 3 slots forces queueing
    ]
    uids = [sched.submit(p, max_new_tokens=4) for p in prompts]
    out = sched.run()

    for uid, prompt in zip(uids, prompts):
        exp = _isolated_reference(params, prompt, 4)
        assert out[uid] == exp, (uid, out[uid], exp)


@pytest.mark.smoke
def test_scheduler_eos_frees_slot():
    params = models.init_params(CFG, jax.random.PRNGKey(1))
    sched = Scheduler(CFG, params, max_batch=1, max_len=128, eos_token=None)
    p = np.array([1, 2, 3], np.int32)
    u1 = sched.submit(p, max_new_tokens=2)
    u2 = sched.submit(p, max_new_tokens=2)
    out = sched.run()
    assert len(out[u1]) == 2 and len(out[u2]) == 2
    assert out[u1] == out[u2]  # same prompt, same tokens, slot reuse is clean


def test_scheduler_chunked_prefill_matches_isolated():
    """Chunked prefill (ragged extend chunks, decode interleaved) must be
    invisible: same tokens as one-shot prefill and isolated generation,
    including chunk sizes that don't divide the prompt lengths."""
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    sched = Scheduler(CFG, params, max_batch=3, max_len=128, prefill_chunk=5)

    prompts = [
        rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
        for n in (7, 13, 3, 11)  # remainders 2, 3, 3, 1 vs chunk 5
    ]
    uids = [sched.submit(p, max_new_tokens=4) for p in prompts]
    out = sched.run()

    for uid, prompt in zip(uids, prompts):
        exp = _isolated_reference(params, prompt, 4)
        assert out[uid] == exp, (uid, out[uid], exp)


def test_scheduler_chunked_prefill_quantized_cache():
    """Chunked prefill through the int8 fused-dequant ragged path."""
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    sched = Scheduler(
        CFG, params, max_batch=2, max_len=128,
        prefill_chunk=6, quantized_cache=True,
    )
    prompts = [
        rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
        for n in (8, 5)
    ]
    uids = [sched.submit(p, max_new_tokens=3) for p in prompts]
    out = sched.run()
    ref = Scheduler(
        CFG, params, max_batch=2, max_len=128, quantized_cache=True
    )
    ruids = [ref.submit(p, max_new_tokens=3) for p in prompts]
    rout = ref.run()
    for u, ru in zip(uids, ruids):
        assert out[u] == rout[ru], (out[u], rout[ru])


def test_scheduler_tp_mesh_matches_single_device():
    """Scheduler(mesh=...): the whole continuous-batching loop runs over a
    tensor-parallel mesh (sharded weights + head-sharded cache) and must
    produce exactly the single-device scheduler's tokens."""
    from flashattention_kernel_project_tpu import parallel

    cfg = models.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=8, n_kv_heads=4,
        d_head=16, d_ff=64, dtype=jnp.float32,
    )
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    mesh = parallel.make_mesh({"model": 4}, devices=jax.devices()[:4])
    rng = np.random.default_rng(3)
    prompts = [
        rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        for n in (6, 11, 4)
    ]

    tp = Scheduler(
        cfg, params, max_batch=2, max_len=64, mesh=mesh,
        prefill_chunk=5, interpret=True,
    )
    uids = [tp.submit(p, max_new_tokens=4) for p in prompts]
    out = tp.run()

    ref = Scheduler(cfg, params, max_batch=2, max_len=64, interpret=True)
    ruids = [ref.submit(p, max_new_tokens=4) for p in prompts]
    rout = ref.run()
    for u, ru in zip(uids, ruids):
        assert out[u] == rout[ru], (out[u], rout[ru])


def test_scheduler_paged_matches_linear():
    """Paged-pool scheduler must produce exactly the linear-cache
    scheduler's tokens, including slot reuse (page recycling + junk-page
    table reset after retirement)."""
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    prompts = [
        rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
        for n in (6, 11, 4, 9)  # 4 requests > 2 slots: retirement + reuse
    ]
    pg = Scheduler(
        CFG, params, max_batch=2, max_len=64, paged=True, page_size=16,
    )
    uids = [pg.submit(p, max_new_tokens=4) for p in prompts]
    out = pg.run()
    assert pg._pool.free_pages == pg._n_pages - 1  # all pages recycled

    ref = Scheduler(CFG, params, max_batch=2, max_len=64)
    ruids = [ref.submit(p, max_new_tokens=4) for p in prompts]
    rout = ref.run()
    for u, ru in zip(uids, ruids):
        assert out[u] == rout[ru], (out[u], rout[ru])


def test_scheduler_paged_quantized():
    """int8 page pool end to end: prefix quantized by the page scatter,
    decode through the fused-dequant paged kernel."""
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    prompts = [
        rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
        for n in (8, 5)
    ]
    pg = Scheduler(
        CFG, params, max_batch=2, max_len=64, paged=True, page_size=16,
        quantized_cache=True,
    )
    uids = [pg.submit(p, max_new_tokens=3) for p in prompts]
    out = pg.run()
    # int8-cache scheduler over the LINEAR cache is the numerics reference
    ref = Scheduler(
        CFG, params, max_batch=2, max_len=64, quantized_cache=True
    )
    ruids = [ref.submit(p, max_new_tokens=3) for p in prompts]
    rout = ref.run()
    for u, ru in zip(uids, ruids):
        assert out[u] == rout[ru], (out[u], rout[ru])


def test_scheduler_paged_pool_exhaustion():
    """Oversubscribed pool: allocation past capacity raises MemoryError
    (the documented failure mode), it does not corrupt other requests."""
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    sched = Scheduler(
        CFG, params, max_batch=2, max_len=64, paged=True, page_size=16,
        n_pages=3,  # junk page + 2 usable: second insert cannot fit
    )
    p = np.arange(20, dtype=np.int32) % CFG.vocab_size
    sched.submit(p, max_new_tokens=8)   # needs ceil(28/16)=2 pages
    sched.submit(p, max_new_tokens=8)
    import pytest as _pytest
    with _pytest.raises(MemoryError):
        sched.run()


def test_scheduler_paged_chunked_prefill():
    """Chunked prefill composes with the page pool."""
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(6)
    prompts = [
        rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
        for n in (13, 7)
    ]
    pg = Scheduler(
        CFG, params, max_batch=2, max_len=64, paged=True, page_size=16,
        prefill_chunk=5,
    )
    uids = [pg.submit(p, max_new_tokens=4) for p in prompts]
    out = pg.run()
    ref = Scheduler(CFG, params, max_batch=2, max_len=64)
    ruids = [ref.submit(p, max_new_tokens=4) for p in prompts]
    rout = ref.run()
    for u, ru in zip(uids, ruids):
        assert out[u] == rout[ru], (out[u], rout[ru])


def test_scheduler_prefix_cache_shares_pages():
    """Automatic prefix caching: two live requests with a common prompt
    prefix share the prefix's full pages (refcounted), skip its prefill
    compute, and still produce exactly the non-shared scheduler's tokens."""
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    base = rng.integers(0, CFG.vocab_size, size=40).astype(np.int32)
    p1 = np.concatenate([base, rng.integers(0, CFG.vocab_size, size=5).astype(np.int32)])
    p2 = np.concatenate([base, rng.integers(0, CFG.vocab_size, size=9).astype(np.int32)])

    pg = Scheduler(
        CFG, params, max_batch=2, max_len=128, paged=True, page_size=16,
        prefix_cache=True,
    )
    u1 = pg.submit(p1, max_new_tokens=4)
    u2 = pg.submit(p2, max_new_tokens=4)
    pg._fill_slots()  # insert both; second must reuse the first's pages
    shared = set(pg._slot_pages[0]) & set(pg._slot_pages[1])
    assert len(shared) == 40 // 16, (pg._slot_pages, shared)
    for pid in shared:
        assert pg._page_refs[pid] == 2
    out = pg.run()

    ref = Scheduler(CFG, params, max_batch=2, max_len=128, paged=True,
                    page_size=16)
    r1 = ref.submit(p1, max_new_tokens=4)
    r2 = ref.submit(p2, max_new_tokens=4)
    rout = ref.run()
    assert out[u1] == rout[r1] and out[u2] == rout[r2]
    # all pages recycled, index emptied once both requests retired
    assert pg._pool.free_pages == pg._n_pages - 1
    assert not pg._prefix_index and not pg._page_refs


def test_scheduler_prefix_cache_page_aligned_prompt():
    """A prompt that is exactly page-aligned never shares its final full
    page (the suffix extend needs >= 1 token), and identical prompts
    still decode identically."""
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(8)
    p = rng.integers(0, CFG.vocab_size, size=32).astype(np.int32)  # 2 pages
    pg = Scheduler(
        CFG, params, max_batch=2, max_len=128, paged=True, page_size=16,
        prefix_cache=True,
    )
    u1 = pg.submit(p, max_new_tokens=3)
    u2 = pg.submit(p, max_new_tokens=3)
    pg._fill_slots()
    shared = set(pg._slot_pages[0]) & set(pg._slot_pages[1])
    assert len(shared) == 1  # first page shared, final page held back
    out = pg.run()
    assert out[u1] == out[u2]

    ref = Scheduler(CFG, params, max_batch=2, max_len=128)
    r1 = ref.submit(p, max_new_tokens=3)
    rout = ref.run()
    assert out[u1] == rout[r1]


def test_scheduler_prefix_cache_quantized_pool():
    """Prefix sharing over an int8 pool: the gathered prefix is the
    dequantized pages (exactly what decode attends); stream stays sane and
    accounting closes."""
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(9)
    base = rng.integers(0, CFG.vocab_size, size=32).astype(np.int32)
    p1 = np.concatenate([base, [1, 2, 3]]).astype(np.int32)
    p2 = np.concatenate([base, [4, 5]]).astype(np.int32)
    pg = Scheduler(
        CFG, params, max_batch=2, max_len=128, paged=True, page_size=16,
        prefix_cache=True, quantized_cache=True,
    )
    u1 = pg.submit(p1, max_new_tokens=3)
    u2 = pg.submit(p2, max_new_tokens=3)
    pg._fill_slots()
    assert len(set(pg._slot_pages[0]) & set(pg._slot_pages[1])) == 2
    out = pg.run()
    assert len(out[u1]) == 3 and len(out[u2]) == 3
    assert all(0 <= t < CFG.vocab_size for t in out[u1] + out[u2])
    assert pg._pool.free_pages == pg._n_pages - 1


def test_scheduler_metrics():
    """metrics(): every finished request carries submit/TTFT/done stamps
    and the aggregate accounting adds up."""
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    sched = Scheduler(CFG, params, max_batch=2, max_len=64)
    p = np.array([1, 2, 3, 4], np.int32)
    uids = [sched.submit(p, max_new_tokens=3) for _ in range(3)]
    out = sched.run()
    m = sched.metrics()
    assert m.requests == 3
    assert m.tokens == sum(len(out[u]) for u in uids) == 9
    assert m.wall_s > 0 and m.tok_per_s > 0
    assert 0 < m.ttft_s_mean <= m.latency_s_mean
    assert m.latency_s_p95 >= m.latency_s_mean * 0.5
    for r in sched.finished:
        assert r.t_submit <= r.t_first_token <= r.t_done


@pytest.mark.parametrize("same_draft", [True, False])
def test_scheduler_speculative_matches_plain(same_draft):
    """Scheduler(draft_...): continuous batching + speculative decoding
    must produce EXACTLY the plain scheduler's greedy tokens — with a
    perfect draft (same model) and a low-acceptance random draft —
    including queueing past the slot count."""
    import dataclasses as dc

    params = models.init_params(CFG, jax.random.PRNGKey(0))
    if same_draft:
        draft_cfg, draft_params = CFG, params
    else:
        draft_cfg = dc.replace(CFG, n_layers=1, d_ff=64)
        draft_params = models.init_params(draft_cfg, jax.random.PRNGKey(99))
    rng = np.random.default_rng(10)
    prompts = [
        rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
        for n in (6, 11, 4)
    ]
    sp = Scheduler(
        CFG, params, max_batch=2, max_len=64,
        draft_cfg=draft_cfg, draft_params=draft_params, spec_k=3,
    )
    uids = [sp.submit(p, max_new_tokens=6) for p in prompts]
    out = sp.run()

    ref = Scheduler(CFG, params, max_batch=2, max_len=64)
    ruids = [ref.submit(p, max_new_tokens=6) for p in prompts]
    rout = ref.run()
    for u, ru in zip(uids, ruids):
        assert out[u] == rout[ru], (out[u], rout[ru])


def test_scheduler_speculative_eos():
    """EOS inside an accepted draft chunk retires the request mid-round
    and drops the rest of the round's tokens."""
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    p = np.array([1, 2, 3], np.int32)
    # find whatever token plain greedy emits second, use it as EOS
    probe = Scheduler(CFG, params, max_batch=1, max_len=64)
    pu = probe.submit(p, max_new_tokens=4)
    eos = probe.run()[pu][1]

    sp = Scheduler(
        CFG, params, max_batch=1, max_len=64, eos_token=int(eos),
        draft_cfg=CFG, draft_params=params, spec_k=3,
    )
    u = sp.submit(p, max_new_tokens=8)
    out = sp.run()
    ref = Scheduler(CFG, params, max_batch=1, max_len=64, eos_token=int(eos))
    ru = ref.submit(p, max_new_tokens=8)
    rout = ref.run()
    assert out[u] == rout[ru]
    assert out[u][-1] == eos and len(out[u]) <= 8


def test_scheduler_multi_step_matches_plain():
    """multi_step decode windows (device-resident scan) must produce
    exactly the plain scheduler's tokens, with EOS/budget retirement
    mid-window dropping the window's tail."""
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    prompts = [
        rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
        for n in (6, 11, 4)
    ]
    ms = Scheduler(CFG, params, max_batch=2, max_len=64, multi_step=3)
    uids = [ms.submit(p, max_new_tokens=7) for p in prompts]  # 7 % 3 != 0
    out = ms.run()

    ref = Scheduler(CFG, params, max_batch=2, max_len=64)
    ruids = [ref.submit(p, max_new_tokens=7) for p in prompts]
    rout = ref.run()
    for u, ru in zip(uids, ruids):
        assert out[u] == rout[ru], (out[u], rout[ru])


def test_scheduler_multi_step_tp_mesh_matches_plain():
    """multi_step x TP mesh: the decode window's
    lax.scan runs INSIDE shard_map over the tensor-parallel mesh
    (tp_engine.make_tp_decode_steps) and must produce exactly the plain
    single-device scheduler's tokens — linear and paged backends."""
    from flashattention_kernel_project_tpu import parallel

    cfg = models.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=8, n_kv_heads=4,
        d_head=16, d_ff=64, dtype=jnp.float32,
    )
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    mesh = parallel.make_mesh({"model": 4}, devices=jax.devices()[:4])
    rng = np.random.default_rng(21)
    prompts = [
        rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        for n in (6, 11, 4)
    ]

    ref = Scheduler(cfg, params, max_batch=2, max_len=64, interpret=True)
    ruids = [ref.submit(p, max_new_tokens=7) for p in prompts]
    rout = ref.run()

    for paged in (False, True):
        kw = dict(paged=True, page_size=8) if paged else {}
        tp = Scheduler(
            cfg, params, max_batch=2, max_len=64, mesh=mesh,
            multi_step=3, interpret=True, **kw,
        )
        uids = [tp.submit(p, max_new_tokens=7) for p in prompts]
        out = tp.run()
        for u, ru in zip(uids, ruids):
            assert out[u] == rout[ru], (paged, out[u], rout[ru])


def test_decode_steps_matches_sequential():
    """engine.decode_steps == n sequential decode_step calls."""
    from flashattention_kernel_project_tpu.models import engine

    params = models.init_params(CFG, jax.random.PRNGKey(0))
    prompt = jax.random.randint(jax.random.PRNGKey(12), (2, 8), 0, CFG.vocab_size)
    cache = engine.init_cache(CFG, 2, 32)
    logits, cache = engine.prefill(CFG, params, prompt, cache)
    cur = jnp.argmax(logits, -1).astype(jnp.int32)

    toks, c_scan = engine.decode_steps(CFG, params, cur, cache, n_steps=4)
    ref_cur, c_ref, ref_toks = cur, cache, []
    for _ in range(4):
        lg, c_ref = engine.decode_step(CFG, params, ref_cur, c_ref)
        ref_cur = jnp.argmax(lg, -1).astype(jnp.int32)
        ref_toks.append(np.asarray(ref_cur))
    np.testing.assert_array_equal(np.asarray(toks), np.stack(ref_toks, 1))
    np.testing.assert_array_equal(
        np.asarray(c_scan.lengths), np.asarray(c_ref.lengths)
    )
    for l in range(CFG.n_layers):
        np.testing.assert_allclose(
            np.asarray(c_scan.k[l]), np.asarray(c_ref.k[l]), atol=1e-6
        )


def test_scheduler_sampling_deterministic_and_valid():
    """temperature sampling in the batch loop: deterministic given the
    key, valid token range, and temperature ~0 equals greedy."""
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(12)
    prompts = [
        rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
        for n in (6, 9)
    ]

    def run(key, temp):
        s = Scheduler(
            CFG, params, max_batch=2, max_len=64,
            temperature=temp, top_k=8, key=key,
        )
        uids = [s.submit(p, max_new_tokens=5) for p in prompts]
        return [s.run()[u] for u in uids]

    a = run(jax.random.PRNGKey(7), 0.9)
    b = run(jax.random.PRNGKey(7), 0.9)
    assert a == b
    assert all(0 <= t < CFG.vocab_size for seq in a for t in seq)

    lo = run(jax.random.PRNGKey(7), 1e-4)  # ~greedy
    ref = Scheduler(CFG, params, max_batch=2, max_len=64)
    ruids = [ref.submit(p, max_new_tokens=5) for p in prompts]
    rout = ref.run()
    assert lo == [rout[u] for u in ruids]


def test_scheduler_tp_paged_prefix_matches_single_device():
    """The full stack at once: TP mesh x paged pool x prefix cache x
    chunked prefill — tokens must equal the single-device paged scheduler."""
    from flashattention_kernel_project_tpu import parallel

    cfg = models.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=8, n_kv_heads=4,
        d_head=16, d_ff=64, dtype=jnp.float32,
    )
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    mesh = parallel.make_mesh({"model": 4}, devices=jax.devices()[:4])
    rng = np.random.default_rng(13)
    base = rng.integers(0, cfg.vocab_size, size=32).astype(np.int32)
    prompts = [
        np.concatenate([base, rng.integers(0, cfg.vocab_size, size=e).astype(np.int32)])
        for e in (3, 6, 2)
    ]
    tp = Scheduler(
        cfg, params, max_batch=2, max_len=96, mesh=mesh,
        paged=True, page_size=16, prefix_cache=True, prefill_chunk=16,
        interpret=True,
    )
    uids = [tp.submit(p, max_new_tokens=4) for p in prompts]
    out = tp.run()

    ref = Scheduler(
        cfg, params, max_batch=2, max_len=96, paged=True, page_size=16,
        interpret=True,
    )
    ruids = [ref.submit(p, max_new_tokens=4) for p in prompts]
    rout = ref.run()
    for u, ru in zip(uids, ruids):
        assert out[u] == rout[ru], (out[u], rout[ru])
    assert tp._pool.free_pages == tp._n_pages - 1


def test_scheduler_streaming_callbacks():
    """on_token streams every committed token in order, flags the last one
    done, across plain / spec / multi_step modes."""
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    p = np.array([3, 1, 4, 1, 5], np.int32)

    def run(**kw):
        sched = Scheduler(CFG, params, max_batch=2, max_len=64, **kw)
        seen = {}

        def cb(uid, tok, done):
            seen.setdefault(uid, []).append((tok, done))

        uids = [sched.submit(p, max_new_tokens=5, on_token=cb) for _ in range(2)]
        out = sched.run()
        for u in uids:
            toks = [t for t, _ in seen[u]]
            assert toks == out[u]
            assert [d for _, d in seen[u]] == [False] * 4 + [True]
        return [out[u] for u in uids]

    plain = run()
    assert run(multi_step=3) == plain
    assert run(draft_cfg=CFG, draft_params=params, spec_k=3) == plain


def test_scheduler_multi_step_paged_matches_plain():
    """multi_step x paged: device-resident decode
    windows over the page pool must produce the plain paged scheduler's
    tokens exactly, including page allocation for the window's overshoot
    rows past a request's budget."""
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(13)
    prompts = [
        rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
        for n in (6, 9, 4)
    ]
    # page_size 8 with budget 7 + multi_step 3: the window overshoots a
    # page boundary, exercising the +reserve page allocation
    ms = Scheduler(CFG, params, max_batch=2, max_len=64, paged=True,
                   page_size=8, multi_step=3)
    uids = [ms.submit(p, max_new_tokens=7) for p in prompts]
    out = ms.run()

    ref = Scheduler(CFG, params, max_batch=2, max_len=64, paged=True,
                    page_size=8)
    ruids = [ref.submit(p, max_new_tokens=7) for p in prompts]
    rout = ref.run()
    for u, ru in zip(uids, ruids):
        assert out[u] == rout[ru], (out[u], rout[ru])


def test_scheduler_fuzz_schedules():
    """Randomized serving stress: random prompt lengths/budgets across the
    backend matrix (linear/paged x chunked x multi_step) must all produce
    the isolated-generation reference stream for every request."""
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(77)
    prompts = [
        rng.integers(0, CFG.vocab_size, size=int(n)).astype(np.int32)
        for n in rng.integers(3, 20, size=6)
    ]
    budgets = [int(b) for b in rng.integers(1, 7, size=6)]
    refs = {}
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        refs[i] = _isolated_reference(params, p, b)

    for kw in (
        dict(),
        dict(prefill_chunk=4),
        dict(paged=True, page_size=8),
        dict(paged=True, page_size=8, prefix_cache=True, prefill_chunk=6),
        dict(multi_step=4),
        dict(paged=True, page_size=8, multi_step=4),
    ):
        sched = Scheduler(CFG, params, max_batch=3, max_len=64, **kw)
        uids = [
            sched.submit(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)
        ]
        out = sched.run()
        for i, u in enumerate(uids):
            assert out[u] == refs[i], (kw, i, out[u], refs[i])


def test_scheduler_seq_sharded_matches_single_device():
    """Scheduler(seq_mesh=...): the batch KV cache sharded along its
    LENGTH (the beyond-one-chip's-HBM mode) must produce the plain
    scheduler's tokens exactly."""
    from flashattention_kernel_project_tpu import parallel

    params = models.init_params(CFG, jax.random.PRNGKey(0))
    mesh = parallel.make_mesh({"sp": 4}, devices=jax.devices()[:4])
    rng = np.random.default_rng(14)
    prompts = [
        rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
        for n in (6, 11, 4)
    ]
    sp = Scheduler(
        CFG, params, max_batch=2, max_len=64, seq_mesh=mesh, interpret=True,
    )
    uids = [sp.submit(p, max_new_tokens=4) for p in prompts]
    out = sp.run()

    ref = Scheduler(CFG, params, max_batch=2, max_len=64, interpret=True)
    ruids = [ref.submit(p, max_new_tokens=4) for p in prompts]
    rout = ref.run()
    for u, ru in zip(uids, ruids):
        assert out[u] == rout[ru], (out[u], rout[ru])


def test_scheduler_speculative_over_tp_mesh():
    """Speculative decoding with the TARGET sharded over the TP mesh (the
    draft stays replicated): tokens must equal the plain single-device
    scheduler's greedy stream."""
    import dataclasses as dc

    from flashattention_kernel_project_tpu import parallel

    cfg = models.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=8, n_kv_heads=4,
        d_head=16, d_ff=64, dtype=jnp.float32,
    )
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    draft_cfg = dc.replace(cfg, n_layers=1, d_ff=32, n_heads=4, n_kv_heads=2)
    draft_params = models.init_params(draft_cfg, jax.random.PRNGKey(9))
    mesh = parallel.make_mesh({"model": 4}, devices=jax.devices()[:4])
    rng = np.random.default_rng(15)
    prompts = [
        rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        for n in (6, 9)
    ]
    sp = Scheduler(
        cfg, params, max_batch=2, max_len=64, mesh=mesh,
        draft_cfg=draft_cfg, draft_params=draft_params, spec_k=3,
        interpret=True,
    )
    uids = [sp.submit(p, max_new_tokens=5) for p in prompts]
    out = sp.run()

    ref = Scheduler(cfg, params, max_batch=2, max_len=64, interpret=True)
    ruids = [ref.submit(p, max_new_tokens=5) for p in prompts]
    rout = ref.run()
    for u, ru in zip(uids, ruids):
        assert out[u] == rout[ru], (out[u], rout[ru])


def test_scheduler_per_request_temperature():
    """Per-request sampling: a greedy request and a sampled request share
    the batch; the greedy one matches the plain scheduler exactly, the
    sampled one is deterministic given the key."""
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(16)
    p1 = rng.integers(0, CFG.vocab_size, size=7).astype(np.int32)
    p2 = rng.integers(0, CFG.vocab_size, size=5).astype(np.int32)

    def run():
        s = Scheduler(
            CFG, params, max_batch=2, max_len=64, key=jax.random.PRNGKey(3)
        )
        u1 = s.submit(p1, max_new_tokens=5)                 # greedy
        u2 = s.submit(p2, max_new_tokens=5, temperature=0.9)  # sampled
        out = s.run()
        return out[u1], out[u2]

    g1, s1 = run()
    g2, s2 = run()
    assert (g1, s1) == (g2, s2)

    ref = Scheduler(CFG, params, max_batch=2, max_len=64)
    r1 = ref.submit(p1, max_new_tokens=5)
    ref.submit(p2, max_new_tokens=5)
    rout = ref.run()
    assert g1 == rout[r1]  # greedy slot unaffected by its sampled neighbor

    # spec + per-request temperature (and top-k/p) is OPEN since round 5
    # (rejection sampling with filtered proposals); per-request overrides
    # remain walled only for multi_step windows
    import pytest as _pytest
    ms = Scheduler(
        CFG, params, max_batch=1, max_len=64, multi_step=3,
        key=jax.random.PRNGKey(0),
    )
    with _pytest.raises(ValueError):
        ms.submit(p1, max_new_tokens=2, temperature=0.5)


def test_scheduler_cancel():
    """cancel(): a queued request vanishes; a running one is evicted
    (slot + pages recycled) and the surviving requests are unaffected."""
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(17)
    p = [rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
         for n in (6, 8, 5)]

    sched = Scheduler(CFG, params, max_batch=2, max_len=64, paged=True,
                      page_size=16)
    u0 = sched.submit(p[0], max_new_tokens=6)
    u1 = sched.submit(p[1], max_new_tokens=6)
    u2 = sched.submit(p[2], max_new_tokens=6)  # queued (2 slots)
    assert sched.cancel(u2)                    # cancel while pending
    sched._fill_slots()
    assert sched.cancel(u1)                    # cancel while running
    assert not sched.cancel(u1)                # double-cancel: no-op
    out = sched.run()
    assert set(out.keys()) == {u0}
    assert len(out[u0]) == 6
    assert sched._pool.free_pages == sched._n_pages - 1

    ref = Scheduler(CFG, params, max_batch=2, max_len=64)
    r0 = ref.submit(p[0], max_new_tokens=6)
    rout = ref.run()
    assert out[u0] == rout[r0]  # the survivor is unaffected by eviction


def test_scheduler_speculative_paged_over_tp_mesh():
    """spec x paged x TP (round 5): the verify extend runs per shard on
    the head-local page pool (make_tp_paged_verify_extend); tokens must
    equal the plain single-device scheduler's greedy stream."""
    import dataclasses as dc

    from flashattention_kernel_project_tpu import parallel

    cfg = models.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=8, n_kv_heads=4,
        d_head=16, d_ff=64, dtype=jnp.float32,
    )
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    draft_cfg = dc.replace(cfg, n_layers=1, d_ff=32, n_heads=4, n_kv_heads=2)
    draft_params = models.init_params(draft_cfg, jax.random.PRNGKey(9))
    mesh = parallel.make_mesh({"model": 4}, devices=jax.devices()[:4])
    rng = np.random.default_rng(23)
    prompts = [
        rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        for n in (6, 11, 4)
    ]
    sp = Scheduler(
        cfg, params, max_batch=2, max_len=64, mesh=mesh, paged=True,
        page_size=8, draft_cfg=draft_cfg, draft_params=draft_params,
        spec_k=3, interpret=True,
    )
    uids = [sp.submit(p, max_new_tokens=6) for p in prompts]
    out = sp.run()
    assert sp._pool.free_pages == sp._n_pages - 1

    ref = Scheduler(cfg, params, max_batch=2, max_len=64, interpret=True)
    ruids = [ref.submit(p, max_new_tokens=6) for p in prompts]
    rout = ref.run()
    for u, ru in zip(uids, ruids):
        assert out[u] == rout[ru], (out[u], rout[ru])


def test_scheduler_multi_step_seq_mesh_matches_plain():
    """seq_mesh x multi_step (round 5): the greedy window scan runs over
    the LENGTH-sharded cache inside shard_map (make_sp_decode_steps) and
    must produce exactly the plain scheduler's tokens."""
    from flashattention_kernel_project_tpu import parallel

    params = models.init_params(CFG, jax.random.PRNGKey(0))
    mesh = parallel.make_mesh({"sp": 4}, devices=jax.devices()[:4])
    rng = np.random.default_rng(37)
    prompts = [
        rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
        for n in (6, 11, 4)
    ]
    sp = Scheduler(
        CFG, params, max_batch=2, max_len=64, seq_mesh=mesh,
        multi_step=3, interpret=True,
    )
    uids = [sp.submit(p, max_new_tokens=7) for p in prompts]
    out = sp.run()

    ref = Scheduler(CFG, params, max_batch=2, max_len=64, interpret=True)
    ruids = [ref.submit(p, max_new_tokens=7) for p in prompts]
    rout = ref.run()
    for u, ru in zip(uids, ruids):
        assert out[u] == rout[ru], (out[u], rout[ru])


@pytest.mark.parametrize("paged", [False, True])
def test_scheduler_multi_step_sampling(paged):
    """multi_step x scheduler-level sampling (round 5): the window scan
    samples per step (engine._sample with the folded step counter) —
    deterministic given the key, valid tokens, and temperature=0 with a
    key still reproduces plain greedy exactly."""
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(41)
    prompts = [
        rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
        for n in (6, 11)
    ]
    kw = dict(paged=True, page_size=8) if paged else {}

    def run(temp):
        s = Scheduler(
            CFG, params, max_batch=2, max_len=64, multi_step=3,
            temperature=temp, key=jax.random.PRNGKey(7), **kw,
        )
        uids = [s.submit(p, max_new_tokens=7) for p in prompts]
        out = s.run()
        return [out[u] for u in uids]

    a = run(0.8)
    b = run(0.8)
    assert a == b  # deterministic given the key
    for toks in a:
        assert len(toks) == 7
        assert all(0 <= t < CFG.vocab_size for t in toks)

    g = run(0.0)  # temp 0 + key: greedy
    ref = Scheduler(CFG, params, max_batch=2, max_len=64)
    ruids = [ref.submit(p, max_new_tokens=7) for p in prompts]
    rout = ref.run()
    assert g == [rout[u] for u in ruids]


def test_scheduler_speculative_sampling():
    """In-batch speculative SAMPLING (round 5): sampled slots commit via
    the rejection rule (engine.speculative_accept); greedy slots in the
    same batch must still match the plain greedy scheduler EXACTLY, and
    the whole run is deterministic given the scheduler key."""
    import dataclasses as dc

    params = models.init_params(CFG, jax.random.PRNGKey(0))
    draft_cfg = dc.replace(CFG, n_layers=1, d_ff=64)
    draft_params = models.init_params(draft_cfg, jax.random.PRNGKey(99))
    rng = np.random.default_rng(31)
    prompts = [
        rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
        for n in (6, 11)
    ]

    def run(**kw):
        s = Scheduler(
            CFG, params, max_batch=2, max_len=64,
            draft_cfg=draft_cfg, draft_params=draft_params, spec_k=3,
            temperature=0.0, key=jax.random.PRNGKey(5), **kw,
        )
        u0 = s.submit(prompts[0], max_new_tokens=6)  # greedy (default 0)
        u1 = s.submit(prompts[1], max_new_tokens=6, temperature=0.8)
        out = s.run()
        return out[u0], out[u1]

    g0, s1 = run()
    g0b, s1b = run()
    assert g0 == g0b and s1 == s1b  # deterministic given the key
    assert len(s1) == 6 and all(0 <= t < CFG.vocab_size for t in s1)

    # top-k filtered speculative sampling (round 5): q is the draft's
    # actual filtered proposal, p the target's filtered distribution
    gk, sk = run(top_k=8)
    gk2, sk2 = run(top_k=8)
    assert (gk, sk) == (gk2, sk2)
    assert len(sk) == 6 and all(0 <= t < CFG.vocab_size for t in sk)

    ref = Scheduler(CFG, params, max_batch=2, max_len=64)
    ru = ref.submit(prompts[0], max_new_tokens=6)
    rout = ref.run()
    assert g0 == rout[ru], (g0, rout[ru])  # greedy slot unchanged by mix


def test_scheduler_speculative_paged_quantized_matches_nonspec():
    """spec x paged x QUANTIZED pool (round 5): the verify chunk
    quantizes per-token on append (paged_append_chunk_quant) and the
    extend kernel dequants fused — committed tokens must exactly match
    the NON-spec quantized-paged scheduler (same int8 cache numerics,
    spec only changes the schedule)."""
    import dataclasses as dc

    params = models.init_params(CFG, jax.random.PRNGKey(0))
    draft_cfg = dc.replace(CFG, n_layers=1, d_ff=64)
    draft_params = models.init_params(draft_cfg, jax.random.PRNGKey(99))
    rng = np.random.default_rng(27)
    prompts = [
        rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
        for n in (6, 11, 4)
    ]
    sp = Scheduler(
        CFG, params, max_batch=2, max_len=64, paged=True, page_size=8,
        quantized_cache=True,
        draft_cfg=draft_cfg, draft_params=draft_params, spec_k=3,
    )
    uids = [sp.submit(p, max_new_tokens=6) for p in prompts]
    out = sp.run()
    assert sp._pool.free_pages == sp._n_pages - 1

    ref = Scheduler(
        CFG, params, max_batch=2, max_len=64, paged=True, page_size=8,
        quantized_cache=True,
    )
    ruids = [ref.submit(p, max_new_tokens=6) for p in prompts]
    rout = ref.run()
    for u, ru in zip(uids, ruids):
        assert out[u] == rout[ru], (out[u], rout[ru])


@pytest.mark.parametrize("same_draft", [True, False])
def test_scheduler_speculative_paged_matches_plain(same_draft):
    """Speculative decoding over the PAGED backend (extend_paged verify):
    tokens must be EXACTLY the plain scheduler's greedy output — spec
    scratch rows live inside each slot's allocated pages and roll back via
    the lengths vector, same as the linear backend."""
    import dataclasses as dc

    params = models.init_params(CFG, jax.random.PRNGKey(0))
    if same_draft:
        draft_cfg, draft_params = CFG, params
    else:
        draft_cfg = dc.replace(CFG, n_layers=1, d_ff=64)
        draft_params = models.init_params(draft_cfg, jax.random.PRNGKey(99))
    rng = np.random.default_rng(10)
    prompts = [
        rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
        for n in (6, 11, 4)
    ]
    sp = Scheduler(
        CFG, params, max_batch=2, max_len=64, paged=True,
        draft_cfg=draft_cfg, draft_params=draft_params, spec_k=3,
    )
    uids = [sp.submit(p, max_new_tokens=6) for p in prompts]
    out = sp.run()
    assert sp._pool.free_pages == sp._n_pages - 1  # all pages returned

    ref = Scheduler(CFG, params, max_batch=2, max_len=64)
    ruids = [ref.submit(p, max_new_tokens=6) for p in prompts]
    rout = ref.run()
    for u, ru in zip(uids, ruids):
        assert out[u] == rout[ru], (out[u], rout[ru])
