"""The online softmax and the associativity property of the streaming merge.

The merge associativity is load-bearing for split-KV decode and ring
attention (SURVEY.md section 5.7) — and the reference hit rescale bugs twice
(5.4 flashattn_forward_fused.cu:180-188 and v12g header), so the disciplines
are tested explicitly against each other.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from flashattention_kernel_project_tpu import ops
from flashattention_kernel_project_tpu.utils import oracles
from flashattention_kernel_project_tpu.utils.testing import assert_max_abs


def test_online_softmax_reference_matches_dense(rng):
    x = rng.standard_normal((16, 1000), dtype=np.float32) * 5.0
    got = ops.online_softmax_reference(jnp.asarray(x), block_cols=256)
    assert_max_abs(got, oracles.softmax(x), tol=1e-5)


def _random_state(rng, rows, dv):
    scores = rng.standard_normal((rows, 64), dtype=np.float32) * 3.0
    values = rng.standard_normal((64, dv), dtype=np.float32)
    return ops.tile_state(jnp.asarray(scores), jnp.asarray(values))


@pytest.mark.smoke
def test_merge_associative_and_commutative(rng):
    rows, dv = 8, 32
    sa, sb, sc = (_random_state(rng, rows, dv) for _ in range(3))
    left = ops.merge(ops.merge(sa, sb), sc)
    right = ops.merge(sa, ops.merge(sb, sc))
    for x, y in zip(left, right):
        assert_max_abs(x, y, tol=1e-4)
    ab, ba = ops.merge(sa, sb), ops.merge(sb, sa)
    for x, y in zip(ab, ba):
        assert_max_abs(x, y, tol=1e-4)


def test_merge_equals_dense_softmax(rng):
    """Splitting the key axis arbitrarily and merging == one-shot softmax@V."""
    rows, cols, dv = 8, 96, 16
    scores = rng.standard_normal((rows, cols), dtype=np.float32) * 3.0
    values = rng.standard_normal((cols, dv), dtype=np.float32)
    expected = oracles.softmax(scores) @ values

    splits = [0, 17, 40, 96]
    state = ops.init_state((rows,), dv)
    for lo, hi in zip(splits[:-1], splits[1:]):
        tile = ops.tile_state(jnp.asarray(scores[:, lo:hi]), jnp.asarray(values[lo:hi]))
        state = ops.merge(state, tile)
    got = ops.finalize(state)
    assert_max_abs(got, expected, tol=1e-4)


def test_merge_matches_numpy_oracle(rng):
    rows, dv = 4, 8
    sa = _random_state(rng, rows, dv)
    sb = _random_state(rng, rows, dv)
    got = ops.merge(sa, sb)
    exp = oracles.online_softmax_merge(
        tuple(np.asarray(x) for x in sa), tuple(np.asarray(x) for x in sb)
    )
    for g, e in zip(got, exp):
        assert_max_abs(g, e, tol=1e-5)
