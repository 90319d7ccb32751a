"""MoE FFN + expert parallelism tests (8-device virtual CPU mesh).

The reference has no MoE/EP (SURVEY.md section 2.9 row "Expert parallel:
absent"); these tests pin the designed-fresh layer: GShard-style dense
dispatch numerics (vs a plain-numpy loop oracle) and EP == single-device
equivalence over the mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattention_kernel_project_tpu import models, parallel
from flashattention_kernel_project_tpu.utils.testing import assert_rel_l2


CFG = models.MoEConfig(d_model=32, d_ff=64, num_experts=8, top_k=2,
                       capacity_factor=2.0)


@pytest.fixture(scope="module")
def params():
    return models.init_moe_params(jax.random.key(0), CFG)


def _numpy_moe_oracle(params, x, cfg):
    """Loop-based oracle: per-token top-k routing with per-expert capacity
    counted in token order — the semantics the dense dispatch must match."""
    p = {k: np.asarray(v, np.float64) for k, v in params.items()}
    x2 = np.asarray(x, np.float64).reshape(-1, cfg.d_model)
    t = x2.shape[0]
    logits = x2 @ p["w_gate"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    cap = cfg.capacity(t)
    fill = np.zeros(cfg.num_experts, int)
    out = np.zeros_like(x2)
    # choice-major fill order: all tokens' 1st choices, then 2nd choices —
    # matches _top_k_dispatch's per-choice cumsum + running counts
    chosen = np.zeros((t, cfg.top_k), int)
    gates = np.zeros((t, cfg.top_k))
    for i in range(t):
        masked = probs[i].copy()
        for k in range(cfg.top_k):
            e = int(np.argmax(masked))
            chosen[i, k] = e
            gates[i, k] = probs[i, e]
            masked[e] = -1.0
        gates[i] /= max(gates[i].sum(), 1e-9)
    for k in range(cfg.top_k):
        for i in range(t):
            e = chosen[i, k]
            if fill[e] < cap:
                fill[e] += 1
                h = x2[i] @ p["w1"][e]
                h = 0.5 * h * (1 + np.tanh(np.sqrt(2 / np.pi)
                                           * (h + 0.044715 * h**3)))
                out[i] += gates[i, k] * (h @ p["w2"][e])
    return out.reshape(x.shape)


@pytest.mark.smoke
def test_moe_ffn_vs_oracle(rng, params):
    x = rng.standard_normal((2, 16, CFG.d_model)).astype(np.float32)
    got = moe_out = models.moe_ffn(params, jnp.asarray(x), CFG)
    exp = _numpy_moe_oracle(params, x, CFG)
    assert moe_out.shape == x.shape
    assert_rel_l2(got, exp, tol=1e-3)


def test_moe_aux_loss_balanced_lower(params):
    # uniform router input -> near-balanced load -> aux close to 1
    x = jnp.zeros((64, CFG.d_model))
    _, aux = models.moe_ffn(params, x, CFG, return_aux=True)
    assert np.isfinite(float(aux))


def test_moe_capacity_drops(rng, params):
    # capacity_factor so small every expert overflows: output must stay
    # finite and tokens beyond the buffer contribute zero (not garbage)
    tight = models.MoEConfig(d_model=32, d_ff=64, num_experts=8, top_k=2,
                             capacity_factor=0.1)
    x = rng.standard_normal((1, 64, tight.d_model)).astype(np.float32)
    got = models.moe_ffn(params, jnp.asarray(x), tight)
    exp = _numpy_moe_oracle(params, x, tight)
    assert np.isfinite(np.asarray(got)).all()
    assert_rel_l2(got, exp, tol=1e-3)


def test_ep_moe_matches_single_device(rng, params):
    mesh = parallel.make_mesh({"expert": 8})
    x = rng.standard_normal((2, 16, CFG.d_model)).astype(np.float32)
    ep = models.make_ep_moe(mesh, CFG)
    got = ep(params, jnp.asarray(x))
    exp = models.moe_ffn(params, jnp.asarray(x), CFG)
    assert_rel_l2(got, np.asarray(exp), tol=1e-5)


def test_ep_moe_2d_mesh_with_data_axis(rng, params):
    mesh = parallel.make_mesh({"data": 2, "expert": 4})
    x = rng.standard_normal((4, 8, CFG.d_model)).astype(np.float32)
    ep = models.make_ep_moe(mesh, CFG, data_axis="data")
    got = np.asarray(ep(params, jnp.asarray(x)))
    # each data shard routes independently: oracle = moe_ffn per half
    for half in range(2):
        sl = slice(half * 2, half * 2 + 2)
        exp = models.moe_ffn(params, jnp.asarray(x[sl]), CFG)
        assert_rel_l2(got[sl], np.asarray(exp), tol=1e-5)


def test_ep_moe_grads_finite(rng, params):
    mesh = parallel.make_mesh({"expert": 8})
    x = jnp.asarray(rng.standard_normal((1, 16, CFG.d_model)), jnp.float32)
    ep = models.make_ep_moe(mesh, CFG)

    def loss(p):
        return jnp.mean(ep(p, x) ** 2)

    g = jax.grad(loss)(params)
    for k, v in g.items():
        assert np.isfinite(np.asarray(v)).all(), k


# -- MoE transformer (cfg.moe_experts > 0) -----------------------------------

# 8 KV heads + 8 experts so the TP-only exactness test can use the whole
# 8-device mesh on the model axis (hkv_local and e_local stay >= 1)
MOE_TFM_CFG = models.TransformerConfig(
    vocab_size=64, d_model=64, n_layers=2, n_heads=8, n_kv_heads=8,
    d_head=16, d_ff=128, dtype=jnp.float32,
    moe_experts=8, moe_top_k=2,
)


def test_moe_transformer_forward_and_loss(rng):
    params = models.init_params(MOE_TFM_CFG, jax.random.PRNGKey(0))
    assert "moe_w1" in params["layers"] and "w_gate" not in params["layers"]
    tokens = jnp.asarray(rng.integers(0, 64, (2, 32)), jnp.int32)
    logits = models.forward(MOE_TFM_CFG, params, tokens)
    assert logits.shape == (2, 32, 64)
    assert np.isfinite(np.asarray(logits)).all()
    loss = models.loss_fn(MOE_TFM_CFG, params, tokens)
    assert np.isfinite(float(loss))
    # aux weight participates: zeroing it changes the loss
    import dataclasses as dc
    cfg0 = dc.replace(MOE_TFM_CFG, moe_aux_weight=0.0)
    assert float(loss) != float(models.loss_fn(cfg0, params, tokens))


def test_moe_transformer_train_step_decreases_loss(rng):
    params = models.init_params(MOE_TFM_CFG, jax.random.PRNGKey(0))
    tokens = jnp.asarray(rng.integers(0, 64, (2, 32)), jnp.int32)
    loss0 = None
    for _ in range(3):
        params, loss = models.sgd_train_step(MOE_TFM_CFG, params, tokens, lr=0.1)
        loss0 = loss0 if loss0 is not None else float(loss)
    assert float(loss) < loss0


def test_moe_transformer_tp_mesh_matches_single_device(rng):
    # pure TP/EP (data axis 1): every chip sees all tokens, experts are
    # sharded — routing and drops are identical to single-device, so the
    # loss must match exactly (up to collective reduction order)
    params = models.init_params(MOE_TFM_CFG, jax.random.PRNGKey(0))
    tokens = jnp.asarray(rng.integers(0, 64, (4, 32)), jnp.int32)
    mesh = parallel.make_mesh({"data": 1, "model": 8})
    step, rules = parallel.make_train_step(MOE_TFM_CFG, mesh, lr=1e-2)
    assert "moe_w1" in rules["layers"]
    sharded = parallel.shard_params(params, mesh, rules)
    _, loss_tp = step(sharded, tokens)
    _, loss_single = models.sgd_train_step(MOE_TFM_CFG, params, tokens, lr=1e-2)
    np.testing.assert_allclose(float(loss_tp), float(loss_single), rtol=1e-4)


def test_moe_transformer_dp_tp_mesh_close(rng):
    # with a real data axis each DP shard routes its own tokens (per-shard
    # capacity) — standard MoE+DP semantics: drops and the aux estimate
    # differ from global routing at the margin, the loss only approximately
    params = models.init_params(MOE_TFM_CFG, jax.random.PRNGKey(0))
    tokens = jnp.asarray(rng.integers(0, 64, (4, 32)), jnp.int32)
    mesh = parallel.make_mesh({"data": 2, "model": 4})
    step, rules = parallel.make_train_step(MOE_TFM_CFG, mesh, lr=1e-2)
    sharded = parallel.shard_params(params, mesh, rules)
    _, loss_tp = step(sharded, tokens)
    _, loss_single = models.sgd_train_step(MOE_TFM_CFG, params, tokens, lr=1e-2)
    np.testing.assert_allclose(float(loss_tp), float(loss_single), rtol=5e-3)


def test_moe_sort_dispatch_matches_dense(rng, params):
    """Sort-based ragged dispatch must equal the
    dense one-hot dispatch (same routing and drops) on the same inputs — including
    capacity drops (tight capacity_factor forces them)."""
    tight = models.MoEConfig(d_model=32, d_ff=64, num_experts=8, top_k=2,
                             capacity_factor=0.5)
    for cfg in (CFG, tight):
        x = jnp.asarray(
            rng.standard_normal((2, 40, cfg.d_model)), jnp.float32
        )
        dense = models.moe_ffn(params, x, cfg, dispatch="dense")
        srt = models.moe_ffn(params, x, cfg, dispatch="sort")
        # identical routing/drops; f32 sum order differs (einsum vs
        # gather-sum), so equality is to f32 rounding
        np.testing.assert_allclose(
            np.asarray(dense), np.asarray(srt), rtol=2e-6, atol=2e-6
        )


def test_ep_moe_sort_dispatch_matches_dense(rng, params):
    """EP sort dispatch over the 8-device mesh == dense EP == single
    device."""
    mesh = parallel.make_mesh({"expert": 8})
    x = jnp.asarray(rng.standard_normal((2, 40, CFG.d_model)), jnp.float32)
    dense = models.moe_ffn(params, x, CFG, dispatch="dense")
    ep_sort = models.make_ep_moe(mesh, CFG, dispatch="sort")(params, x)
    np.testing.assert_allclose(
        np.asarray(dense), np.asarray(ep_sort), rtol=1e-6, atol=1e-6
    )


def test_moe_sort_dispatch_grads_finite(rng, params):
    """Training path through the sort dispatch (gathers + argsorts) must
    differentiate; grads stay finite."""
    x = jnp.asarray(rng.standard_normal((2, 24, CFG.d_model)), jnp.float32)

    def loss(p, x):
        o, aux = models.moe_ffn(p, x, CFG, return_aux=True,
                                dispatch="sort")
        return (o ** 2).sum() + 0.01 * aux

    g = jax.grad(loss)(params, x)
    for leaf in jax.tree.leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()
