"""Pipeline parallelism (GPipe-style over a 'pipe' mesh axis) vs the
single-device reference: identical loss, finite grads, loss decreases."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from flashattention_kernel_project_tpu import models, parallel
from flashattention_kernel_project_tpu.models import transformer as tfm


@pytest.fixture
def cfg():
    return models.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=4, n_heads=4, n_kv_heads=2,
        d_head=8, d_ff=64, dtype=jnp.float32,
    )


@pytest.mark.smoke
def test_pp_loss_matches_reference(cfg):
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0, 64)
    ref = float(tfm.loss_fn(cfg, params, tokens, interpret=True))

    mesh = parallel.make_mesh({"pipe": 4}, devices=jax.devices()[:4])
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    import functools
    specs = parallel.pp_param_specs()
    loss_sm = jax.jit(shard_map(
        functools.partial(
            parallel.pp_loss_fn, cfg, n_micro=2, interpret=True, remat=False
        ),
        mesh=mesh, in_specs=(specs, P()), out_specs=P(), check_vma=False,
    ))
    got = float(loss_sm(params, tokens))
    np.testing.assert_allclose(got, ref, rtol=2e-5)


def test_pp_train_step_decreases_loss(cfg):
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(2), (4, 32), 0, 64)
    mesh = parallel.make_mesh({"pipe": 4}, devices=jax.devices()[:4])
    step, specs = parallel.make_pp_train_step(
        cfg, mesh, n_micro=2, lr=0.1, interpret=True, remat=True
    )
    p, l0 = step(params, tokens)
    for _ in range(3):
        p, l = step(p, tokens)
    assert np.isfinite(float(l0)) and float(l) < float(l0)


def test_pp_train_step_matches_single_device(cfg):
    """One PP step == one single-device SGD step: atol tight enough that a
    constant factor on any leaf's gradient (the psum-transpose n_stages x
    bug class) cannot hide inside the update."""
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(3), (4, 32), 0, 64)
    mesh = parallel.make_mesh({"pipe": 4}, devices=jax.devices()[:4])
    step, specs = parallel.make_pp_train_step(
        cfg, mesh, n_micro=2, lr=1e-2, interpret=True, remat=False
    )
    sharded = parallel.shard_params(params, mesh, specs)
    new_pp, loss_pp = step(sharded, tokens)

    new_ref, loss_ref = models.sgd_train_step(cfg, params, tokens, lr=1e-2, interpret=True)
    np.testing.assert_allclose(float(loss_pp), float(loss_ref), rtol=1e-4)
    for a, b in zip(jax.tree.leaves(new_pp), jax.tree.leaves(new_ref)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-3, atol=2e-5
        )
