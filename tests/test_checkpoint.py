"""Checkpoint/resume: params + opt state + step survive a save/restore
round-trip, including restore onto a sharded mesh template (SURVEY.md
section 5.4 — absent in the reference; required for a serving/training
framework)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from flashattention_kernel_project_tpu import models, parallel


@pytest.fixture
def cfg():
    return models.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
        d_head=8, d_ff=64, dtype=jnp.float32,
    )


@pytest.mark.smoke
def test_checkpoint_roundtrip(tmp_path, cfg):
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    path = models.save_checkpoint(
        str(tmp_path / "ck"), params, step=7, opt_state=opt_state, config=cfg
    )
    got = models.restore_checkpoint(
        path, params_template=params, opt_state_template=opt_state
    )
    assert got["step"] == 7
    assert got["config"]["d_model"] == 32
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(got["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(
        jax.tree.leaves(opt_state), jax.tree.leaves(got["opt_state"])
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_restore_sharded(tmp_path, cfg):
    """Restore directly into a mesh-sharded layout via an abstract template."""
    params = models.init_params(cfg, jax.random.PRNGKey(1))
    path = models.save_checkpoint(str(tmp_path / "ck"), params, step=1)

    mesh = parallel.make_mesh({"data": 2, "model": 4})
    from flashattention_kernel_project_tpu.models import transformer as tfm
    rules = tfm.param_shardings(cfg, data_axis="data", model_axis="model")
    template = jax.tree.map(
        lambda p, rule: jax.ShapeDtypeStruct(
            p.shape, p.dtype,
            sharding=jax.sharding.NamedSharding(mesh, rule),
        ),
        params, rules,
    )
    got = models.restore_checkpoint(path, params_template=template)
    restored = got["params"]
    leaf = jax.tree.leaves(restored)[0]
    assert isinstance(leaf.sharding, jax.sharding.NamedSharding)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_params_only_restore_from_training_checkpoint(tmp_path, cfg):
    """The serving case: restore ONLY params from a checkpoint that was
    saved with optimizer state (regression: a single-item tree made this a
    structure mismatch)."""
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    opt_state = optax.adam(1e-3).init(params)
    path = models.save_checkpoint(
        str(tmp_path / "ck"), params, step=5, opt_state=opt_state
    )
    got = models.restore_checkpoint(path, params_template=params)
    assert "opt_state" in got  # present on disk -> still returned
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(got["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_resume_identical_through_sharded_optax_step(tmp_path, cfg):
    """Save mid-training from the DP x TP optax step, restore into the
    sharded layout, continue — the resumed run must produce the same
    losses and final params as the uninterrupted one."""
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0, cfg.vocab_size)
    mesh = parallel.make_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
    opt = optax.adamw(1e-2)
    init_fn, step_fn, rules, sspecs = parallel.make_optax_train_step(
        cfg, mesh, opt, params
    )
    p = parallel.shard_params(params, mesh, rules)
    s = init_fn(p)

    # uninterrupted: 4 steps
    p_ref, s_ref = p, s
    losses_ref = []
    for _ in range(4):
        p_ref, s_ref, loss = step_fn(p_ref, s_ref, tokens)
        losses_ref.append(float(loss))

    # interrupted: 2 steps, checkpoint, restore into the mesh, 2 more
    p2, s2 = p, s
    for _ in range(2):
        p2, s2, _ = step_fn(p2, s2, tokens)
    from flashattention_kernel_project_tpu.models import checkpoint as ck

    ck.save_checkpoint(str(tmp_path / "mid"), p2, step=2, opt_state=s2)
    got = ck.restore_checkpoint(
        str(tmp_path / "mid"),
        params_template=p2, opt_state_template=s2,
    )
    assert got["step"] == 2
    p3, s3 = got["params"], got["opt_state"]
    losses_resumed = []
    for _ in range(2):
        p3, s3, loss = step_fn(p3, s3, tokens)
        losses_resumed.append(float(loss))

    np.testing.assert_allclose(losses_resumed, losses_ref[2:], rtol=1e-6)
    for a, b in zip(jax.tree.leaves(p3), jax.tree.leaves(p_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
