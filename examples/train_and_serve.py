#!/usr/bin/env python
"""End-to-end walkthrough: train a tiny GQA transformer, checkpoint it,
resume, then serve it (prefill + KV-cached decode with sampling).

On a GPU the kernels run compiled; elsewhere the script runs them in the
Pallas interpreter (slow, for a quick look). For the multi-device version
of the train step see parallel/train.py and __graft_entry__.py's
dryrun_multichip.

    python examples/train_and_serve.py [--steps 20]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=0.1)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import models

    cfg = models.TransformerConfig(
        vocab_size=256,
        d_model=128,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,   # GQA 2:1
        d_head=32,
        d_ff=256,
        dtype=jnp.float32,
    )
    params = models.init_params(cfg, jax.random.PRNGKey(0))

    # --- train on a toy corpus (predict the next byte of a repeating motif),
    # streamed through the native data loader (runtime/dataloader.cpp:
    # mmap + prefetch threads; numpy fallback if g++ is absent)
    from flashattention_kernel_project_tpu.runtime import (
        TokenLoader,
        write_token_file,
    )

    rng = np.random.default_rng(0)
    motif = rng.integers(0, cfg.vocab_size, 64)
    corpus = np.tile(motif, 64).astype(np.uint32)
    tok_path = os.path.join(tempfile.mkdtemp(prefix="fkp_data_"), "toks.bin")
    write_token_file(tok_path, corpus)

    loss = float("nan")
    with TokenLoader(tok_path, batch=8, seq_len=128, seed=0) as loader:
        print(f"data loader backend: {'native C++' if loader.native else 'numpy'}")
        for step in range(args.steps):
            tokens = jnp.asarray(loader.next_batch()[:, :-1], jnp.int32)
            params, loss = models.sgd_train_step(cfg, params, tokens, lr=args.lr)
            if step % 5 == 0 or step == args.steps - 1:
                print(f"step {step:3d}  loss {float(loss):.4f}")

    # --- checkpoint + resume
    ckpt_dir = tempfile.mkdtemp(prefix="fkp_ckpt_")
    models.save_checkpoint(ckpt_dir, params, step=args.steps, config=cfg)
    state = models.restore_checkpoint(ckpt_dir, params_template=params)
    restored = state["params"]
    print(f"checkpoint round-trip OK (step {state['step']}) -> {ckpt_dir}")

    # --- serve: greedy decode should reproduce the motif from a prefix
    prompt = jnp.asarray(corpus[None, :32], jnp.int32)
    out = models.generate(
        cfg, restored, prompt, max_new_tokens=16, temperature=0.0
    )
    want = corpus[32:48]
    got = np.asarray(out)[0, 32:]
    acc = float((got == want).mean())
    print(f"greedy continuation accuracy vs corpus: {acc:.2f}")

    # --- sampled generation (top-k / nucleus)
    sampled = models.generate(
        cfg, restored, prompt, max_new_tokens=16,
        temperature=0.8, top_k=32, top_p=0.95, key=jax.random.PRNGKey(1),
    )
    print("sampled tail:", np.asarray(sampled)[0, 32:].tolist())

    # --- production serving loop: continuous batching over the paged-pool
    # KV backend with automatic prefix caching and chunked prefill — four
    # requests sharing a prompt prefix, two slots, mixed lengths
    from flashattention_kernel_project_tpu.models.serving import Scheduler

    sched = Scheduler(
        cfg, restored, max_batch=2, max_len=256,
        paged=True, page_size=32, prefix_cache=True, prefill_chunk=64,
    )
    uids = [
        sched.submit(corpus[: 64 + 7 * i], max_new_tokens=12)
        for i in range(4)
    ]
    outs = sched.run()
    print("scheduler (paged + prefix cache + chunked prefill):",
          sched.metrics())
    assert all(len(outs[u]) == 12 for u in uids)

    # --- speculative decoding: a 1-layer draft accelerates the 2-layer
    # target; committed tokens are exactly the target's greedy stream
    import dataclasses

    draft_cfg = dataclasses.replace(cfg, n_layers=1, d_ff=128)
    draft_params = models.init_params(draft_cfg, jax.random.PRNGKey(7))
    spec = Scheduler(
        cfg, restored, max_batch=2, max_len=256,
        draft_cfg=draft_cfg, draft_params=draft_params, spec_k=4,
    )
    su = [spec.submit(corpus[:32], max_new_tokens=12) for _ in range(2)]
    souts = spec.run()
    assert souts[su[0]] == souts[su[1]]
    print("speculative scheduler:", spec.metrics())


if __name__ == "__main__":
    import jax

    from flashattention_kernel_project_tpu.utils.platform import (
        interpret_kernels,
    )

    # off the GPU the kernels run in the Pallas interpreter
    with interpret_kernels(jax.default_backend() != "gpu"):
        main()
