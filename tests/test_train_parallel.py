"""DP x TP training step on the virtual 8-device mesh: numerics must match
the single-device train step, and loss must decrease."""

import jax
import jax.numpy as jnp
import numpy as np

from flashattention_kernel_project_tpu import models, parallel
import pytest

CFG = models.TransformerConfig(
    vocab_size=64,
    d_model=64,
    n_layers=2,
    n_heads=8,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    dtype=jnp.float32,
)


@pytest.mark.smoke
def test_tp_dp_step_matches_single_device():
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0, CFG.vocab_size)

    mesh = parallel.make_mesh({"data": 2, "model": 4})
    step, rules = parallel.make_train_step(CFG, mesh, lr=1e-2)
    sharded = parallel.shard_params(params, mesh, rules)
    new_sharded, loss_tp = step(sharded, tokens)

    new_single, loss_single = models.sgd_train_step(CFG, params, tokens, lr=1e-2)
    np.testing.assert_allclose(float(loss_tp), float(loss_single), rtol=1e-4)
    for a, b in zip(jax.tree.leaves(new_sharded), jax.tree.leaves(new_single)):
        # collective reduction order differs from single-device accumulation,
        # but only at fp-noise scale: atol is tight enough that a constant
        # factor on any leaf's gradient (the psum-transpose tp x bug class)
        # cannot hide inside the update (lr * g * 3 ~ 1e-4 >> 2e-5)
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-3, atol=2e-5
        )


def test_tp_dp_loss_decreases():
    params = models.init_params(CFG, jax.random.PRNGKey(2))
    tokens = jax.random.randint(jax.random.PRNGKey(3), (4, 32), 0, CFG.vocab_size)
    mesh = parallel.make_mesh({"data": 2, "model": 4})
    step, rules = parallel.make_train_step(CFG, mesh, lr=5e-2)
    p = parallel.shard_params(params, mesh, rules)
    losses = []
    for _ in range(4):
        p, loss = step(p, tokens)
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_cp_step_matches_single_device():
    """Context-parallel (sequence-sharded ring) train step == single-device
    step: same loss, same updated params."""
    params = models.init_params(CFG, jax.random.PRNGKey(0))
    tokens = jax.random.randint(
        jax.random.PRNGKey(2), (2, 64), 0, CFG.vocab_size
    )

    mesh = parallel.make_mesh({"sp": 4}, devices=jax.devices()[:4])
    step, rules = parallel.make_cp_train_step(CFG, mesh, lr=1e-2)
    sharded = parallel.shard_params(params, mesh, rules)
    new_cp, loss_cp = step(sharded, tokens)

    new_single, loss_single = models.sgd_train_step(CFG, params, tokens, lr=1e-2)
    np.testing.assert_allclose(float(loss_cp), float(loss_single), rtol=1e-4)
    for a, b in zip(jax.tree.leaves(new_cp), jax.tree.leaves(new_single)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-3, atol=2e-5
        )


def test_cp_step_loss_decreases():
    params = models.init_params(CFG, jax.random.PRNGKey(3))
    tokens = jax.random.randint(
        jax.random.PRNGKey(4), (2, 64), 0, CFG.vocab_size
    )
    mesh = parallel.make_mesh({"sp": 4}, devices=jax.devices()[:4])
    step, rules = parallel.make_cp_train_step(CFG, mesh, lr=1e-1)
    p = parallel.shard_params(params, mesh, rules)
    _, loss0 = step(p, tokens)
    for _ in range(3):
        p, loss = step(p, tokens)
    assert float(loss) < float(loss0)


def test_optax_adamw_step_matches_single_device():
    """make_optax_train_step (AdamW + global-norm clip over DP x TP) must
    track a single-device optax run: same loss trace, same final params."""
    import optax

    params = models.init_params(CFG, jax.random.PRNGKey(4))
    tokens = jax.random.randint(jax.random.PRNGKey(5), (4, 32), 0, CFG.vocab_size)
    opt = optax.adamw(1e-2)
    mesh = parallel.make_mesh({"data": 2, "model": 4})
    init_fn, step_fn, rules, sspecs = parallel.make_optax_train_step(
        CFG, mesh, opt, params, clip_norm=1.0
    )
    p_tp = parallel.shard_params(params, mesh, rules)
    s_tp = init_fn(p_tp)

    # single-device reference: identical loss + clip-by-global-norm + adamw
    ref_opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-2))
    p_ref = params
    s_ref = ref_opt.init(p_ref)

    def ref_loss(p):
        return models.loss_fn(CFG, p, tokens)

    for _ in range(3):
        p_tp, s_tp, loss_tp = step_fn(p_tp, s_tp, tokens)
        loss_ref, grads = jax.value_and_grad(ref_loss)(p_ref)
        updates, s_ref = ref_opt.update(grads, s_ref, p_ref)
        p_ref = optax.apply_updates(p_ref, updates)
        np.testing.assert_allclose(float(loss_tp), float(loss_ref), rtol=1e-4)

    # adam's g/sqrt(nu) normalization is sign-like on early steps, so
    # collective-order fp noise can move single elements by O(lr); the
    # per-step loss equality above is the functional check, this bounds
    # total drift to a fraction of one step's movement
    for a, b in zip(jax.tree.leaves(p_tp), jax.tree.leaves(p_ref)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=5e-4
        )


def test_optax_momentum_step_matches_single_device_exactly():
    """With a LINEAR optimizer (SGD+momentum, no grad normalization) the
    sharded optax step must match single-device numerics tightly — this
    pins the state sharding, psums, and clip machinery exactly."""
    import optax

    params = models.init_params(CFG, jax.random.PRNGKey(6))
    tokens = jax.random.randint(jax.random.PRNGKey(7), (4, 32), 0, CFG.vocab_size)
    opt = optax.sgd(1e-1, momentum=0.9)
    mesh = parallel.make_mesh({"data": 2, "model": 4})
    init_fn, step_fn, rules, _ = parallel.make_optax_train_step(
        CFG, mesh, opt, params, clip_norm=0.5
    )
    p_tp = parallel.shard_params(params, mesh, rules)
    s_tp = init_fn(p_tp)

    ref_opt = optax.chain(
        optax.clip_by_global_norm(0.5), optax.sgd(1e-1, momentum=0.9)
    )
    p_ref, s_ref = params, None
    s_ref = ref_opt.init(p_ref)
    for _ in range(3):
        p_tp, s_tp, loss_tp = step_fn(p_tp, s_tp, tokens)
        loss_ref, grads = jax.value_and_grad(
            lambda p: models.loss_fn(CFG, p, tokens)
        )(p_ref)
        updates, s_ref = ref_opt.update(grads, s_ref, p_ref)
        p_ref = optax.apply_updates(p_ref, updates)
        np.testing.assert_allclose(float(loss_tp), float(loss_ref), rtol=1e-4)
    for a, b in zip(jax.tree.leaves(p_tp), jax.tree.leaves(p_ref)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-3, atol=5e-4
        )


def test_tp_remat_matches_no_remat():
    """jax.checkpoint per layer must not change the numerics — only the
    backward's memory/FLOPs trade."""
    params = models.init_params(CFG, jax.random.PRNGKey(8))
    tokens = jax.random.randint(jax.random.PRNGKey(9), (4, 32), 0, CFG.vocab_size)
    mesh = parallel.make_mesh({"data": 2, "model": 4})
    step_a, rules = parallel.make_train_step(CFG, mesh, lr=1e-2, remat=False)
    step_b, _ = parallel.make_train_step(CFG, mesh, lr=1e-2, remat=True)
    p = parallel.shard_params(params, mesh, rules)
    pa, la = step_a(p, tokens)
    pb, lb = step_b(p, tokens)
    np.testing.assert_allclose(float(la), float(lb), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(pa), jax.tree.leaves(pb)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
