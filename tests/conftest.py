"""Test config: run everything on a virtual 8-device CPU mesh.

Pallas kernels run in the Pallas interpreter here: the session fixture
below turns interpret mode on for every kernel call that leaves it unset
(outside it, a kernel off the GPU raises). Multi-device sharding tests get
8 virtual devices so collectives are exercised without a cluster (SURVEY.md
section 4). Tests that need the card carry the `gpu` marker and take the
`gpu` fixture, which skips them here.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
if os.environ.get("FKP_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from flashattention_kernel_project_tpu.utils import platform  # noqa: E402


@pytest.fixture(scope="session", autouse=True)
def _interpret_kernels():
    """Pallas kernels run in the interpreter unless a test runs on the card."""
    with platform.interpret_kernels(jax.default_backend() != "gpu"):
        yield


@pytest.fixture
def gpu():
    """Skip unless JAX has a GPU (decided at run time, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `FKP_TEST_GPU=1 pytest -m gpu` on the card")
    return jax.devices()[0]


@pytest.fixture
def rng():
    return np.random.default_rng(42)


# One process compiles hundreds of interpreted kernels; releasing the
# jit/pallas caches every N tests keeps its memory bounded at the cost of
# some recompiles.
_TEST_COUNT = 0


@pytest.fixture(autouse=True)
def _periodic_jax_cache_clear():
    yield
    global _TEST_COUNT
    _TEST_COUNT += 1
    if _TEST_COUNT % 40 == 0:
        jax.clear_caches()
