"""Continuous-batching serving scheduler.

Continuous batching around the decode kernels, as a single-host slot
scheduler: a fixed
decode batch of B slots, new requests prefilled (bucketed prompt lengths to
bound recompiles) and inserted into free slots while other slots keep
decoding; finished slots are freed immediately. The decode step always runs
the full batch — empty slots carry length 0, which the decode kernel masks
to zero output (verified in tests) — so there is exactly ONE compiled decode
program regardless of occupancy.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from flashattention_kernel_project_tpu.models import engine
from flashattention_kernel_project_tpu.models import transformer as tfm
from flashattention_kernel_project_tpu.runtime.native import BatchSchedulerCore
from flashattention_kernel_project_tpu.utils.health import with_retries


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # [T] int32
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    temperature: float | None = None  # None -> the scheduler default
    # observability (seconds, time.perf_counter clock)
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0


@dataclasses.dataclass
class ServingMetrics:
    """Aggregate serving stats over the finished requests (SURVEY §5.5's
    metrics subsystem, serving-grade: the reference only printf'd kernel
    timings; a serving engine is judged on TTFT and per-request latency)."""

    requests: int
    tokens: int
    wall_s: float
    tok_per_s: float
    ttft_s_mean: float      # submit -> first committed token
    ttft_s_p95: float
    latency_s_mean: float   # submit -> done
    latency_s_p95: float

    def __str__(self):
        return (
            f"{self.requests} req, {self.tokens} tok in {self.wall_s:.2f}s "
            f"= {self.tok_per_s:,.0f} tok/s | TTFT mean {self.ttft_s_mean*1e3:.0f}ms "
            f"p95 {self.ttft_s_p95*1e3:.0f}ms | latency mean "
            f"{self.latency_s_mean*1e3:.0f}ms p95 {self.latency_s_p95*1e3:.0f}ms"
        )


def _host_filtered_probs(z, t, top_k, top_p):
    """numpy mirror of engine._sample's temperature/top-k/top-p filter,
    returning the PROBABILITIES the device categorical draws from —
    the q (draft proposal) and p (target) distributions the rejection
    rule needs. z: [..., V] f32 logits."""
    z = np.asarray(z, np.float64) / float(t)
    v = z.shape[-1]
    use_k = top_k is not None and 0 < top_k < v
    use_p = top_p is not None and 0.0 < top_p < 1.0
    if use_k or use_p:
        sd = -np.sort(-z, axis=-1)
        if use_k:
            kth = sd[..., top_k - 1][..., None]
            z = np.where(z < kth, -np.inf, z)
        if use_p:
            if use_k:
                sd = np.where(np.arange(v) < top_k, sd, -np.inf)
            e = np.exp(sd - sd.max(-1, keepdims=True))
            probs = e / e.sum(-1, keepdims=True)
            cum = np.cumsum(probs, -1)
            keep = cum - probs < top_p
            cutoff = np.min(
                np.where(keep, sd, np.inf), axis=-1, keepdims=True
            )
            z = np.where(z < cutoff, -np.inf, z)
    z = z - z.max(-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(-1, keepdims=True)


class Scheduler:
    """Slot-based continuous batching over the KV-cache engine."""

    def __init__(
        self,
        cfg: tfm.TransformerConfig,
        params: dict,
        *,
        max_batch: int = 8,
        max_len: int = 2048,
        quantized_cache: bool = False,
        eos_token: int | None = None,
        n_splits: int | None = None,
        prefill_chunk: int | None = None,
        mesh=None,
        model_axis: str = "model",
        seq_mesh=None,
        seq_axis: str = "sp",
        paged: bool = False,
        page_size: int = 128,
        n_pages: int | None = None,
        prefix_cache: bool = False,
        draft_cfg: tfm.TransformerConfig | None = None,
        draft_params: dict | None = None,
        spec_k: int = 4,
        multi_step: int = 1,
        temperature: float = 0.0,
        top_k: int | None = None,
        top_p: float | None = None,
        key=None,
        interpret: bool | None = None,
    ):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_token = eos_token
        self.n_splits = n_splits
        self.prefill_chunk = prefill_chunk
        self.mesh = mesh
        self.seq_mesh = seq_mesh
        self.paged = paged
        self.interpret = interpret
        if seq_mesh is not None and (mesh is not None or paged):
            raise NotImplementedError(
                "seq_mesh (length-sharded cache) is a linear single-TP mode"
            )
        # per-scheduler sampling (temperature/top-k/nucleus). Greedy when
        # temperature == 0 or no key. Deterministic given the key: each
        # sample folds in a monotonically increasing step counter.
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self._key = key
        self._sample_step = 0
        self.sampling = temperature > 0.0 and key is not None
        # per-slot effective temperature (requests may override the
        # scheduler default per submit(); 0 = greedy)
        self._slot_temp = np.zeros(max_batch, np.float32)
        if paged:
            # vLLM-style backend: a shared page pool replaces the per-slot
            # max_len reservation. Pages are allocated at insert for the
            # request's full budget (prompt + max_new) and returned to the
            # pool at retirement — undersizing n_pages below
            # max_batch*max_len/page_size + 1 oversubscribes capacity on
            # the bet that requests retire early (allocation raises
            # MemoryError when the bet fails). Page 0 is the reserved junk
            # page: retired/empty slots' block tables point at it, so
            # their masked decode appends land harmlessly there.
            from flashattention_kernel_project_tpu.ops.paged_decode import (
                PagePool,
            )

            self._page = page_size
            self._pages_per_seq = -(-max_len // page_size)
            self._n_pages = n_pages or (max_batch * self._pages_per_seq + 1)
            if mesh is not None:
                from flashattention_kernel_project_tpu.parallel import (
                    tp_engine,
                )

                self.cache = tp_engine.init_tp_paged_cache(
                    cfg, mesh, max_batch, self._n_pages,
                    page_size=page_size,
                    max_pages_per_seq=self._pages_per_seq,
                    quantized=quantized_cache, model_axis=model_axis,
                )
            else:
                self.cache = engine.init_paged_cache(
                    cfg, max_batch, self._n_pages, page_size=page_size,
                    max_pages_per_seq=self._pages_per_seq,
                    quantized=quantized_cache,
                )
            self._pool = PagePool(self._n_pages)
            self._slot_pages: list[list[int]] = [[] for _ in range(max_batch)]
            # automatic prefix caching (vLLM-style): full prompt pages are
            # content-addressed by a position-chained hash; a new request
            # whose prompt starts with an already-resident block chain
            # reuses those pages (refcounted) AND skips their prefill
            # compute — the shared rows are gathered back into the batch-1
            # cache and only the suffix runs through ragged extend.
            self._prefix_index: dict[bytes, int] = {}   # key -> page id
            self._page_refs: dict[int, int] = {}        # page id -> refs
            self._page_key: dict[int, bytes] = {}       # page id -> key
        elif prefix_cache:
            raise ValueError("prefix_cache requires paged=True")
        self.prefix_cache = prefix_cache
        # speculative decoding: a draft model proposes spec_k tokens per
        # round, ONE ragged target extend verifies the whole batch.
        # Greedy slots commit exactly what plain greedy decode would emit
        # (tests pin this); sampled slots (round 5) run the
        # rejection-sampling rule (engine.speculative_accept), whose
        # committed stream is distributed exactly as target-only
        # temperature sampling. Either way the win is wall-clock. The
        # verify extend needs spec_k+1 scratch rows past each slot's
        # committed length (the admission core reserves them).
        self.spec = draft_cfg is not None
        if self.spec:
            if seq_mesh is not None:
                raise NotImplementedError(
                    "speculative decoding: linear or paged cache (no seq_mesh)"
                )
            if paged and quantized_cache and mesh is not None:
                raise NotImplementedError(
                    "speculative x paged x quantized x TP: the TP paged "
                    "verify is wired bf16-only (compose any three)"
                )
            # sampling (any temperature/top-k/top-p combination) verifies
            # via the rejection rule with q = the draft's ACTUAL filtered
            # proposal distribution and p = the target's filtered
            # distribution (_host_filtered_probs mirrors engine._sample)
            assert draft_cfg.vocab_size == cfg.vocab_size
            self.draft_cfg = draft_cfg
            self.spec_k = spec_k
            # the draft stays replicated/single-logical-device even under a
            # TP mesh — it is small by construction; only the target's
            # verify extend shards
            self.dcache = engine.init_cache(draft_cfg, max_batch, max_len)
            self._draft_split_params = draft_params
            self._draft_params = engine.fuse_decode_params(
                draft_cfg, draft_params
            )
            self._draft_decode = functools.partial(
                engine.decode_step, draft_cfg, interpret=interpret
            )
        if seq_mesh is not None:
            # sequence-parallel serving: the batch cache is sharded along
            # its LENGTH over the mesh (contexts beyond one chip's HBM);
            # params replicated, decode through the SP engine step
            # (shard-local appends + streaming merge across chips).
            # Prefill stays the batch-1 single-logical path — the splice
            # into the sharded cache distributes under GSPMD.
            from flashattention_kernel_project_tpu.parallel import tp_engine

            assert max_len % seq_mesh.shape[seq_axis] == 0, (
                max_len, dict(seq_mesh.shape),
            )
            self.cache = tp_engine.init_sp_cache(
                cfg, seq_mesh, max_batch, max_len,
                quantized=quantized_cache, seq_axis=seq_axis,
            )
            self._sp_decode = tp_engine.make_sp_decode_step(
                cfg, seq_mesh, seq_axis=seq_axis, n_splits=n_splits,
                quantized_cache=quantized_cache, interpret=interpret,
            )
        else:
            self._sp_decode = None
        if mesh is not None:
            # tensor-parallel mode: the whole engine runs shard_map'd over
            # the mesh (parallel/tp_engine.py) — megatron-sharded weights,
            # head-sharded cache. Prefill always takes the ragged-extend
            # path (exact last-position logits, no bucket-padding refill),
            # chunked when prefill_chunk is set.
            from flashattention_kernel_project_tpu.parallel import (
                shard_params, tp_engine,
            )

            _, ef, df, rules = tp_engine.make_tp_engine(
                cfg, mesh, model_axis=model_axis, n_splits=n_splits,
                quantized_cache=quantized_cache, interpret=interpret,
            )
            self.params = shard_params(params, mesh, rules)
            if not paged:
                self.cache = tp_engine.init_tp_cache(
                    cfg, mesh, max_batch, max_len,
                    quantized=quantized_cache, model_axis=model_axis,
                )
            self._tp_extend = ef
            if not self.spec:
                self._tp_verify = None
            elif paged:
                # spec x paged x TP (round 5): the verify extend runs the
                # chunk append + ragged extend per shard on the
                # head-local page pool
                self._tp_verify = tp_engine.make_tp_paged_verify_extend(
                    cfg, mesh, model_axis=model_axis, interpret=interpret,
                )
            else:
                self._tp_verify = tp_engine.make_tp_verify_extend(
                    cfg, mesh, model_axis=model_axis,
                    quantized_cache=quantized_cache, interpret=interpret,
                )
            # paged mode prefills full-precision; the page scatter owns
            # the quantization (same rule as the single-device path)
            self._init_cache1 = functools.partial(
                tp_engine.init_tp_cache, cfg, mesh,
                quantized=quantized_cache and not paged,
                model_axis=model_axis,
            )
        else:
            if not paged and seq_mesh is None:
                self.cache = engine.init_cache(
                    cfg, max_batch, max_len, quantized=quantized_cache
                )
            self._tp_extend = None
            self._tp_verify = None
            # paged mode prefills into a full-precision batch-1 cache — the
            # page scatter (engine._scatter_pages_q) owns the quantization
            self._init_cache1 = functools.partial(
                engine.init_cache, cfg,
                quantized=quantized_cache and not paged,
            )
        self.slots: list[Request | None] = [None] * max_batch
        self.cur_tokens = np.zeros(max_batch, np.int32)
        self.finished: list[Request] = []
        # all scheduling DECISIONS (admission order, slot choice, budget/EOS
        # finish, prompt bucketing) live in the native C++ core
        # (runtime/scheduler.cpp; behavior-identical Python fallback)
        # multi-token modes write past the committed length before the
        # host sees EOS/budget: spec's verify extend needs spec_k+1 scratch
        # rows per slot, multi_step decode needs multi_step — reserve them
        # at admission
        self.multi_step = multi_step
        self._tp_steps = None
        if multi_step > 1:
            # linear, paged, TP-mesh AND seq_mesh backends (the window
            # scan runs inside shard_map: make_tp_decode_steps /
            # make_sp_decode_steps). Scheduler-level sampling rides the
            # single-device scan (engine._sample inside decode_steps,
            # round 5); spec, per-request temperature overrides, and
            # sampling-over-mesh remain walls
            if self.spec:
                raise NotImplementedError(
                    "multi_step: no spec composition"
                )
            if self.sampling and (mesh is not None or seq_mesh is not None):
                raise NotImplementedError(
                    "multi_step sampling over a mesh: not wired (the "
                    "shard_map windows bake greedy; single-device "
                    "linear/paged sampling windows are supported)"
                )
            if mesh is not None:
                from flashattention_kernel_project_tpu.parallel import (
                    tp_engine,
                )

                self._tp_steps = tp_engine.make_tp_decode_steps(
                    cfg, mesh, n_steps=multi_step, model_axis=model_axis,
                    n_splits=n_splits, quantized_cache=quantized_cache,
                    paged=paged, interpret=interpret,
                )
            elif seq_mesh is not None:
                # seq_mesh x multi_step (round 5): the n-step greedy scan
                # over the LENGTH-sharded cache — shard-local appends +
                # the all_gather/merge stay inside the scan body
                from flashattention_kernel_project_tpu.parallel import (
                    tp_engine,
                )

                self._tp_steps = tp_engine.make_sp_decode_steps(
                    cfg, seq_mesh, n_steps=multi_step, seq_axis=seq_axis,
                    n_splits=n_splits, quantized_cache=quantized_cache,
                    interpret=interpret,
                )
        self._reserve = spec_k + 1 if self.spec else (
            multi_step if multi_step > 1 else 0
        )
        self.core = BatchSchedulerCore(max_batch, max_len - self._reserve)
        self._callbacks: dict[int, Callable[[int, int, bool], None]] = {}
        self._requests: dict[int, Request] = {}

        # one compiled single-seq prefill per prompt bucket
        self._prefill_1 = functools.partial(
            engine.prefill, cfg, interpret=interpret
        )
        if seq_mesh is not None:
            self._decode_params = self.params  # replicated split layout
            self._decode = self._sp_decode
        elif mesh is not None:
            self._decode_params = self.params  # sharded split layout
            if paged:
                from flashattention_kernel_project_tpu.parallel import (
                    tp_engine,
                )

                self._decode = tp_engine.make_tp_paged_decode(
                    cfg, mesh, model_axis=model_axis,
                    quantized_cache=quantized_cache, interpret=interpret,
                )
            else:
                self._decode = df
        elif paged:
            self._decode_params = engine.fuse_decode_params(cfg, params)
            self._decode = functools.partial(
                engine.decode_step_paged, cfg, interpret=interpret
            )
        else:
            self._decode_params = engine.fuse_decode_params(cfg, params)
            self._decode = functools.partial(
                engine.decode_step, cfg, n_splits=n_splits, interpret=interpret
            )

    # ----------------------------------------------------------------- API
    def submit(
        self,
        prompt: np.ndarray,
        max_new_tokens: int = 32,
        on_token: Callable[[int, int, bool], None] | None = None,
        temperature: float | None = None,
    ) -> int:
        """Queue a request. on_token(uid, token, done) streams each
        committed token as it lands (greedy modes commit in bursts:
        chunked-prefill interleave, spec rounds, multi_step windows).
        temperature overrides the scheduler default for THIS request
        (requires a scheduler `key`; 0 = greedy; spec/multi_step modes
        are greedy-only)."""
        prompt = np.asarray(prompt, np.int32)
        if temperature is not None and temperature > 0.0:
            if self._key is None:
                raise ValueError("per-request temperature needs a key")
            if self.multi_step > 1:
                raise ValueError(
                    "multi_step: per-request temperature overrides are "
                    "not supported (scheduler-level sampling is)"
                )
        uid = self.core.submit(len(prompt), max_new_tokens)
        if uid < 0:
            cap = self.max_len - self._reserve
            extra = (
                f" (= max_len {self.max_len} minus {self._reserve} scratch "
                f"rows reserved by spec/multi_step)"
                if self._reserve else ""
            )
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new_tokens}) "
                f"exceeds capacity {cap}{extra}"
            )
        self._requests[uid] = Request(
            uid, prompt, max_new_tokens, t_submit=time.perf_counter(),
            temperature=temperature,
        )
        if on_token is not None:
            self._callbacks[uid] = on_token
        return uid

    def cancel(self, uid: int) -> bool:
        """Abort a request: pending ones leave the queue, running ones are
        evicted (their slot + pages free immediately). The partial output
        is discarded — cancelled uids do not appear in run()'s result.
        Returns False for unknown/already-finished uids."""
        rc = self.core.cancel(uid)
        if rc == 0:
            return False
        self._requests.pop(uid, None)
        self._callbacks.pop(uid, None)
        if rc == 2:
            for slot, req in enumerate(self.slots):
                if req is not None and req.uid == uid:
                    self.slots[slot] = None
                    self._release_slot(slot)
                    break
        return True

    def run(self) -> dict[int, list[int]]:
        """Drain all requests; returns {uid: generated tokens}."""
        t0 = time.perf_counter()
        while self.core.pending() or self.core.active():
            self._fill_slots()
            self._decode_once()
        self._wall_s = getattr(self, "_wall_s", 0.0) + time.perf_counter() - t0
        return {r.uid: r.generated for r in self.finished}

    def metrics(self) -> ServingMetrics:
        """Aggregate stats over the requests finished so far."""
        fin = self.finished
        ttft = np.array([r.t_first_token - r.t_submit for r in fin])
        lat = np.array([r.t_done - r.t_submit for r in fin])
        toks = sum(len(r.generated) for r in fin)
        wall = getattr(self, "_wall_s", 0.0)
        return ServingMetrics(
            requests=len(fin),
            tokens=toks,
            wall_s=wall,
            tok_per_s=toks / wall if wall > 0 else 0.0,
            ttft_s_mean=float(ttft.mean()) if len(fin) else 0.0,
            ttft_s_p95=float(np.percentile(ttft, 95)) if len(fin) else 0.0,
            latency_s_mean=float(lat.mean()) if len(fin) else 0.0,
            latency_s_p95=float(np.percentile(lat, 95)) if len(fin) else 0.0,
        )

    # ------------------------------------------------------------ internals
    def _fill_slots(self):
        for uid, slot, bucket in self.core.fill():
            self._insert(slot, self._requests[uid], bucket)

    def _insert(self, slot: int, req: Request, tb: int):
        """Prefill the prompt as a batch-1 sequence, splice its KV into the
        batch cache at `slot`, record the first generated token.

        With `prefill_chunk` set, the prompt enters in fixed-size ragged
        chunks (engine.extend with n=) and the running slots get a decode
        step between chunks — Sarathi-style chunked prefill, bounding the
        decode stall a long prompt inflicts on the batch to one chunk's
        latency instead of a whole prefill. The ragged last-position
        gather also makes the returned logits exact for bucket-padded
        prompts, so no second full forward is needed on that path.
        """
        t = len(req.prompt)
        shared: list[int] = []
        keys: list[bytes] = []
        if self.paged and self.prefix_cache:
            shared, keys = self._match_prefix(req.prompt)
        if shared:
            # shared-prefix fast path: gather the resident pages into the
            # batch-1 cache and prefill only the suffix
            logits, cache1 = self._chunked_prefill(
                req, tb, prefix_pages=shared
            )
        elif self.prefill_chunk or self.mesh is not None:
            logits, cache1 = self._chunked_prefill(req, tb)
        else:
            prompt = np.zeros((1, tb), np.int32)
            prompt[0, :t] = req.prompt
            cache1 = self._init_cache1(1, tb)
            logits, cache1 = with_retries(
                self._prefill_1, self.params, jnp.asarray(prompt), cache1
            )
            # bucket padding attends causally within the prompt, so position
            # t-1's logits are unaffected by the padded tail; but `prefill`
            # returns last-position logits — recompute the true last
            # position. Run the exact-length path when t != tb.
            if t != tb:
                logits = self._exact_last_logits(req.prompt)
        if self.paged:
            self._insert_pages(slot, req, cache1, t, shared, keys)
        else:
            self._splice_linear(slot, cache1, tb, t)
        if self.spec:
            # draft-side prefill: only the KV rows matter (the draft's
            # prompt logits are never used), so a bucket-padded one-shot
            # prefill is exact enough — rows [0:t] are position-correct
            dprompt = np.zeros((1, tb), np.int32)
            dprompt[0, :t] = req.prompt
            dcache1 = engine.init_cache(self.draft_cfg, 1, tb)
            _, dcache1 = engine.prefill(
                self.draft_cfg, self._draft_split_params,
                jnp.asarray(dprompt), dcache1, interpret=self.interpret,
            )
            self.dcache = self._splice_linear(
                slot, dcache1, tb, t, into=self.dcache
            )
        self.slots[slot] = req
        t_eff = req.temperature
        if t_eff is None:
            t_eff = self.temperature if self.sampling else 0.0
        self._slot_temp[slot] = t_eff
        first = int(np.asarray(
            self._pick(jnp.asarray(logits), temps=[t_eff])
        )[0])
        self.cur_tokens[slot] = first
        req.generated.append(first)
        req.t_first_token = time.perf_counter()
        self._on_token(slot, first)

    def _splice_linear(self, slot: int, cache1, tb: int, t: int, into=None):
        # splice per-layer KV [1,Hkv,tb,D] -> cache layer [slot, :, :tb]
        target = self.cache if into is None else into

        def splice(big, small):
            return jax.lax.dynamic_update_slice(
                big, small[:, :, :tb].astype(big.dtype), (slot, 0, 0, 0)
            )

        def splice_all(bigs, smalls):
            return tuple(splice(b, s) for b, s in zip(bigs, smalls))

        new_k = splice_all(target.k, cache1.k)
        new_v = splice_all(target.v, cache1.v)
        ks, vs = target.k_scale, target.v_scale
        if target.quantized:
            ks = splice_all(ks, cache1.k_scale)
            vs = splice_all(vs, cache1.v_scale)
        lengths = target.lengths.at[slot].set(t)
        out = engine.KVCache(new_k, new_v, ks, vs, lengths)
        if into is None:
            self.cache = out
        return out

    def _match_prefix(self, prompt: np.ndarray):
        """Longest chain of resident full prompt pages. Returns (page ids,
        chained keys for EVERY full prompt page). Keys chain through the
        preceding page's key, so a block only matches at the same absolute
        positions (KV rows embed RoPE positions). The final full page is
        never matched when the prompt is exactly page-aligned — the suffix
        extend needs at least one token to produce the first logits."""
        import hashlib

        page = self._page
        t = len(prompt)
        n_full = t // page
        keys: list[bytes] = []
        prev = b""
        for j in range(n_full):
            h = hashlib.blake2b(digest_size=16)
            h.update(prev)
            h.update(np.ascontiguousarray(prompt[j * page : (j + 1) * page]))
            prev = h.digest()
            keys.append(prev)
        matchable = min(n_full, (t - 1) // page)
        shared: list[int] = []
        for j in range(matchable):
            pid = self._prefix_index.get(keys[j])
            if pid is None:
                break
            shared.append(pid)
        return shared, keys

    def _insert_pages(
        self, slot: int, req: Request, cache1, t: int,
        shared: list[int] = (), keys: list[bytes] = (),
    ):
        """Allocate pages for the request's full budget (reusing the shared
        prefix pages), scatter the prefilled suffix into the new ones,
        install the block table, and register the request's own full
        prompt pages in the prefix index."""
        # +_reserve: multi-token modes (spec verify, multi_step windows)
        # append up to `reserve` rows PAST the budget before the host rolls
        # back — those writes must land in this slot's own pages, not spill
        # onto the junk page where the same round would read garbage back
        n_total = -(-(t + req.max_new_tokens + self._reserve) // self._page)
        new_pages = self._pool.alloc(n_total - len(shared))
        for pid in shared:
            self._page_refs[pid] += 1
        for pid in new_pages:
            self._page_refs[pid] = 1
        pages = list(shared) + new_pages
        self._slot_pages[slot] = pages
        row = self._pool.table_for(pages, self._pages_per_seq)
        k_seq = tuple(k[0, :, :t] for k in cache1.k)
        v_seq = tuple(v[0, :, :t] for v in cache1.v)
        self.cache = engine.paged_insert(
            self.cache, slot, jnp.asarray(row), k_seq, v_seq, t,
            start_page=len(shared),
        )
        if self.prefix_cache:
            # register this prompt's full pages (tail partial page and
            # generated-token pages are never shared); an already-indexed
            # key keeps its original page — this one stays private
            for j in range(len(shared), t // self._page):
                if keys[j] not in self._prefix_index:
                    self._prefix_index[keys[j]] = pages[j]
                    self._page_key[pages[j]] = keys[j]

    def _chunked_prefill(self, req: Request, tb: int, prefix_pages=None):
        """Feed the prompt through ragged `extend` in prefill_chunk-sized
        pieces against a batch-1 cache, decoding the live batch between
        chunks. The cache is sized tb + C: the last ragged chunk's padded
        tail still writes C-n dead rows past the prompt (the splice trims
        back to tb). Compiled programs stay bounded: one extend per
        (chunk, bucket) pair."""
        c = min(self.prefill_chunk or tb, tb)
        t = len(req.prompt)
        if prefix_pages:
            s = len(prefix_pages) * self._page
            cache1 = engine.cache_from_pages(
                self.cfg, self.cache, prefix_pages, s, tb + c
            )
        else:
            s = 0
            cache1 = self._init_cache1(1, tb + c)
        logits = None
        for j0 in range(s, t, c):
            nj = min(c, t - j0)
            chunk = np.zeros((1, c), np.int32)
            chunk[0, :nj] = req.prompt[j0 : j0 + nj]
            nvec = jnp.full((1,), nj, jnp.int32)
            if self._tp_extend is not None:
                logits, cache1 = with_retries(
                    self._tp_extend, self.params, jnp.asarray(chunk),
                    cache1, nvec,
                )
            else:
                logits, cache1 = with_retries(
                    functools.partial(
                        engine.extend, self.cfg, self.params,
                        jnp.asarray(chunk), cache1, n=nvec,
                        interpret=self.interpret,
                    )
                )
            if j0 + nj < t:
                self._decode_once()
        return logits, cache1

    def _exact_last_logits(self, prompt: np.ndarray):
        logits = tfm.forward(
            self.cfg,
            self.params,
            jnp.asarray(prompt[None, :]),
            interpret=self.interpret,
        )
        return logits[:, -1]

    def _decode_once(self):
        if not self.core.active():
            return
        if self.spec:
            return self._spec_round()
        if self.multi_step > 1:
            return self._multi_step_round()
        # transient runtime faults (worker restarts, seen as UNAVAILABLE)
        # retry with a cooldown; real errors fail fast
        # (SURVEY §5.3 — the serving loop is where liveness matters)
        logits, self.cache = with_retries(
            self._decode,
            self._decode_params, jnp.asarray(self.cur_tokens), self.cache,
        )
        nxt = np.asarray(self._pick(logits), np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(nxt[i])
            req.generated.append(tok)
            self.cur_tokens[i] = tok
            self._on_token(i, tok)

    def _spec_round(self):
        """One speculative round over the live batch: spec_k draft decode
        steps propose, one ragged target extend over [cur, d_1..d_k]
        verifies every slot; each slot commits its accepted prefix + the
        target's correction/bonus token (1..spec_k+1 target-grade tokens).
        Rollback is the per-slot lengths vector — KV written past a slot's
        accepted prefix is dead and overwritten by later rounds. EOS or
        budget exhaustion mid-commit retires the slot and drops the rest
        of its round."""
        k = self.spec_k
        cur = jnp.asarray(self.cur_tokens)
        B = len(self.slots)
        temps = self._slot_temp[:B]
        any_sampled = bool((temps > 0).any()) and self._key is not None
        dl, self.dcache = with_retries(
            self._draft_decode, self._draft_params, cur, self.dcache
        )
        drafts = []
        dl_steps = []  # sampled slots need q = the draft's proposal dist
        for _ in range(k):
            if any_sampled:
                dl_steps.append(np.asarray(dl, np.float32))
                # _pick: greedy rows argmax, temp>0 rows sample from
                # softmax(logits/temp) — exactly the q used in the
                # rejection rule below
                d_j = jnp.asarray(self._pick(dl), jnp.int32)
            else:
                d_j = jnp.argmax(dl, axis=-1).astype(jnp.int32)
            drafts.append(d_j)
            dl, self.dcache = with_retries(
                self._draft_decode, self._draft_params, d_j, self.dcache
            )
        d = jnp.stack(drafts, axis=1)                      # [B, k]
        chunk = jnp.concatenate([cur[:, None], d], axis=1)  # [B, k+1]
        old_len = np.asarray(self.cache.lengths).copy()
        if self._tp_verify is not None:
            all_l, self.cache = with_retries(
                self._tp_verify, self.params, chunk, self.cache
            )
        elif self.paged:
            # paged verify: one multi-token causal extend over the page
            # pool (spec scratch rows live inside the slot's allocated
            # pages — the admission reserve caps committed lengths)
            all_l, self.cache = with_retries(
                functools.partial(
                    engine.extend_paged, self.cfg, self.params, chunk,
                    self.cache, interpret=self.interpret,
                )
            )
        else:
            all_l, self.cache = with_retries(
                functools.partial(
                    engine.extend, self.cfg, self.params, chunk, self.cache,
                    all_logits=True, interpret=self.interpret,
                )
            )
        preds = np.asarray(jnp.argmax(all_l, axis=-1), np.int32)  # [B, k+1]
        d_np = np.asarray(d)
        match = preds[:, :-1] == d_np
        a = np.where(match.all(axis=1), k, np.argmin(match, axis=1))
        if any_sampled:
            # per-round host rng for the rejection rule — deterministic
            # given the scheduler key (the same fold-in discipline as
            # engine.speculative_generate)
            import jax as _jax

            self._sample_step += 1
            host_rng = np.random.default_rng(
                int(_jax.random.randint(
                    _jax.random.fold_in(
                        self._key, 0xACCE0000 + self._sample_step
                    ), (), 0, 2 ** 31 - 1,
                ))
            )
            all_np = np.asarray(all_l, np.float32)  # [B, k+1, V]
            dq_np = np.stack(dl_steps, axis=1)      # [B, k, V]

        new_len = old_len.copy()
        for i, req in enumerate(self.slots):
            if req is None:
                new_len[i] = 0  # empty slot: undo the extend's advance
                continue
            if any_sampled and temps[i] > 0:
                # rejection-sampling verify (speculative_accept): the
                # committed stream is distributed exactly as target-only
                # sampling (same temperature/top-k/top-p filters) for
                # this slot; q is the draft's actual filtered proposal
                p_i = _host_filtered_probs(
                    all_np[i], temps[i], self.top_k, self.top_p
                )
                q_i = _host_filtered_probs(
                    dq_np[i], temps[i], self.top_k, self.top_p
                )
                take = engine.speculative_accept(
                    p_i, q_i, d_np[i], host_rng
                )
            else:
                take = (
                    list(d_np[i, : int(a[i])]) + [int(preds[i, int(a[i])])]
                )
            committed = 0
            for tok in take:
                committed += 1
                req.generated.append(int(tok))
                self.cur_tokens[i] = int(tok)
                self._on_token(i, int(tok))
                if self.slots[i] is None:
                    break  # retired mid-round; drop the rest
            new_len[i] = 0 if self.slots[i] is None else old_len[i] + committed
        self.cache = self.cache._replace(
            lengths=jnp.asarray(new_len, jnp.int32)
        )
        # the draft consumed [cur, d_1..d_k]; resync to the target's view
        self.dcache = self.dcache._replace(
            lengths=jnp.asarray(new_len, jnp.int32)
        )

    def _multi_step_round(self):
        """multi_step greedy decode steps as one device-resident program
        (engine.decode_steps): the host round trip leaves the per-token
        path; tokens a slot produced past its EOS/budget are dropped and
        its lengths rolled back (same rollback discipline as the
        speculative round)."""
        m = self.multi_step
        old_len = np.asarray(self.cache.lengths).copy()
        # scheduler-level sampling rides INSIDE the scan (round 5):
        # engine._sample per step with the step counter folded into the
        # key — deterministic given the scheduler key, like _pick
        samp = dict(
            temperature=self.temperature, key=self._key,
            top_k=self.top_k, top_p=self.top_p,
            step0=self._sample_step,
        ) if self.sampling else {}
        if samp:
            self._sample_step += m
        if self._tp_steps is not None:
            step_fn = functools.partial(
                self._tp_steps, self._decode_params,
                jnp.asarray(self.cur_tokens), self.cache,
            )
        elif self.paged:
            step_fn = functools.partial(
                engine.decode_steps_paged, self.cfg, self._decode_params,
                jnp.asarray(self.cur_tokens), self.cache, n_steps=m,
                interpret=self.interpret, **samp,
            )
        else:
            step_fn = functools.partial(
                engine.decode_steps, self.cfg, self._decode_params,
                jnp.asarray(self.cur_tokens), self.cache, n_steps=m,
                n_splits=self.n_splits, interpret=self.interpret, **samp,
            )
        toks, self.cache = with_retries(step_fn)
        toks = np.asarray(toks)
        new_len = old_len.copy()
        for i, req in enumerate(self.slots):
            if req is None:
                new_len[i] = 0  # empty slot: undo the window's advance
                continue
            committed = 0
            for j in range(m):
                committed += 1
                tok = int(toks[i, j])
                req.generated.append(tok)
                self.cur_tokens[i] = tok
                self._on_token(i, tok)
                if self.slots[i] is None:
                    break  # retired mid-window; drop the rest
            new_len[i] = 0 if self.slots[i] is None else old_len[i] + committed
        self.cache = self.cache._replace(
            lengths=jnp.asarray(new_len, jnp.int32)
        )

    def _pick(self, logits, temps=None):
        """Per-slot greedy or temperature/top-k/top-p choice [B,V]->[B].
        temps: per-row effective temperatures (defaults to the live slots'
        vector); rows with temp <= 0 take the argmax."""
        if temps is None:
            temps = self._slot_temp[: logits.shape[0]]
        temps = np.asarray(temps, np.float32)
        greedy = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        if self._key is None or not (temps > 0).any():
            return greedy
        self._sample_step += 1
        scaled = logits / jnp.clip(jnp.asarray(temps), 1e-6)[:, None]
        sampled = engine._sample(
            scaled, 1.0, self._key, self._sample_step,
            self.top_k, self.top_p,
        )
        return jnp.where(jnp.asarray(temps) > 0, sampled, greedy)

    def _on_token(self, slot: int, token: int):
        """Report the token to the core; on finish, retire the request and
        zero the slot length so the decode kernel masks it out."""
        eos = -1 if self.eos_token is None else self.eos_token
        finished = self.core.on_token(slot, token, eos)
        req_now = self.slots[slot]
        cb = self._callbacks.get(req_now.uid) if req_now else None
        if cb is not None:
            cb(req_now.uid, token, finished)
        if finished:
            req = self.slots[slot]
            req.done = True
            req.t_done = time.perf_counter()
            self.finished.append(req)
            self.slots[slot] = None
            self._requests.pop(req.uid, None)
            self._callbacks.pop(req.uid, None)
            self._release_slot(slot)

    def _release_slot(self, slot: int):
        """Free a slot's device-side state (at retirement or cancel): zero
        its length so decode masks it, recycle its pages."""
        self._slot_temp[slot] = 0.0
        self.cache = self.cache._replace(
            lengths=self.cache.lengths.at[slot].set(0)
        )
        if self.paged:
            # drop this slot's references; free pages nobody else
            # holds (and unregister them from the prefix index), then
            # point the table at the junk page: the retired slot keeps
            # riding the full-batch decode (masked output), and its
            # append must not write into pages another request owns
            dead = []
            for pid in self._slot_pages[slot]:
                self._page_refs[pid] -= 1
                if self._page_refs[pid] == 0:
                    dead.append(pid)
                    del self._page_refs[pid]
                    key = self._page_key.pop(pid, None)
                    if key is not None:
                        self._prefix_index.pop(key, None)
            self._pool.free(dead)
            self._slot_pages[slot] = []
            self.cache = self.cache._replace(
                block_tables=self.cache.block_tables.at[slot].set(0)
            )
