"""Which attention implementation runs for which call, interpret-mode
policy, the peaks table and the compile cache; plus the card-only checks
(marked `gpu`, skipped off the card)."""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattention_kernel_project_tpu import ops
from flashattention_kernel_project_tpu.utils import platform
from flashattention_kernel_project_tpu.utils.testing import assert_rel_l2

BF16, F32 = jnp.bfloat16, jnp.float32


@pytest.mark.parametrize("dtype,n,s,d,causal,q_offset,window,sinks,interp,"
                         "plat,want", [
    (BF16, 4096, 4096, 128, True, 0, None, 0, None, "gpu", "cudnn"),
    (BF16, 4096, 4096, 64, False, 0, None, 0, None, "gpu", "cudnn"),
    (BF16, 4096, 4096, 128, True, 0, 1024, 0, None, "gpu", "cudnn"),
    (BF16, 512, 4096, 128, False, 0, None, 0, None, "gpu", "cudnn"),
    (BF16, 512, 4096, 128, True, 0, None, 0, None, "gpu", "pallas"),
    (BF16, 512, 4096, 128, True, 3584, None, 0, None, "gpu", "pallas"),
    (BF16, 4096, 4096, 128, True, 0, 1024, 4, None, "gpu", "pallas"),
    (F32, 4096, 4096, 128, True, 0, None, 0, None, "gpu", "pallas"),
    (BF16, 4096, 4096, 256, True, 0, None, 0, None, "gpu", "pallas"),
    (BF16, 4096, 4096, 128, True, 0, None, 0, True, "gpu", "pallas"),
    (BF16, 4096, 4096, 128, True, 0, None, 0, None, "cpu", "pallas"),
])
def test_select_impl(dtype, n, s, d, causal, q_offset, window, sinks, interp,
                     plat, want):
    got = ops.select_impl(dtype, n, s, d, causal=causal, q_offset=q_offset,
                          window=window, sinks=sinks, interpret=interp,
                          platform=plat)
    assert got == want


@pytest.mark.parametrize("call", ["flash_attention", "flash_decode",
                                  "paged_flash_decode"])
def test_kernel_off_gpu_without_interpret_raises(call):
    q = jnp.zeros((1, 2, 16, 16))
    k = jnp.zeros((1, 2, 16, 16))
    lens = jnp.full((1,), 16, jnp.int32)
    with pytest.raises(RuntimeError, match="GPU"):
        if call == "flash_attention":
            ops.flash_attention(q, k, k, interpret=False)
        elif call == "flash_decode":
            ops.flash_decode(q[:, :, 0], k, k, lens, interpret=False)
        else:
            ops.paged_flash_decode(q[:, :, 0], k[0][None], k[0][None],
                                   jnp.zeros((1, 1), jnp.int32), lens,
                                   interpret=False)


def test_interpret_context_sets_default():
    with platform.interpret_kernels(False):
        with pytest.raises(RuntimeError):
            platform.resolve_interpret(None)
        with platform.interpret_kernels(True):
            assert platform.resolve_interpret(None) is True
    assert platform.resolve_interpret(True) is True


def test_peaks_table_known_and_unknown():
    p = platform.peaks("NVIDIA H100 80GB HBM3")
    assert p.bf16_flops == 989e12 and p.hbm_bytes == 3.35e12
    assert platform.peak_flops("int8", "NVIDIA H100 80GB HBM3") == 1979e12
    with pytest.raises(KeyError, match="no published peaks"):
        platform.peaks("Imaginary Accelerator 9000")


@pytest.mark.parametrize("env", [None, "custom"])
def test_compile_cache_dir_follows_env(tmp_path, env):
    code = ("from flashattention_kernel_project_tpu.utils import platform;"
            "import jax;"
            "d = platform.enable_compile_cache();"
            "print(d); print(jax.config.jax_compilation_cache_dir)")
    e = dict(os.environ, JAX_PLATFORMS="cpu")
    e.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env:
        e["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env)
    out = subprocess.run([sys.executable, "-c", code], env=e, check=True,
                         capture_output=True, text=True,
                         cwd=str(platform.REPO_ROOT)).stdout.split()
    want = str(tmp_path / env) if env else str(platform.REPO_ROOT / ".jax_cache")
    assert out == [want, want]


# ---------------------------------------------------------------------------
# Card-only: the compiled kernels (no interpret mode) on the GPU
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["pallas", "cudnn"])
def test_compiled_forward_on_card(gpu, impl):
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.standard_normal((1, 8, 512, 128)), BF16)
    k = jnp.asarray(rng.standard_normal((1, 2, 512, 128)), BF16)
    got = ops.flash_attention(q, k, k, causal=True, implementation=impl,
                              interpret=False)
    with jax.default_matmul_precision("highest"):
        want = ops.reference_attention(q, k, k, causal=True)
    assert_rel_l2(np.asarray(got, np.float32), np.asarray(want), 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_compiled_backward_on_card(gpu, causal):
    rng = np.random.default_rng(1)
    q = jnp.asarray(rng.standard_normal((1, 8, 512, 128)), BF16)
    k = jnp.asarray(rng.standard_normal((1, 2, 512, 128)), BF16)
    w = jnp.asarray(rng.standard_normal(q.shape), F32)

    def loss(fn, q, k, v):
        return jnp.sum(fn(q, k, v, causal=causal).astype(F32) * w)

    kernel = functools.partial(ops.flash_attention, implementation="pallas",
                               interpret=False)
    got = jax.grad(functools.partial(loss, kernel), (0, 1, 2))(q, k, k)
    with jax.default_matmul_precision("highest"):
        want = jax.grad(functools.partial(loss, ops.reference_attention),
                        (0, 1, 2))(*(x.astype(F32) for x in (q, k, k)))
    for a, b in zip(got, want):
        assert_rel_l2(np.asarray(a, np.float32), np.asarray(b), 2e-2)


@pytest.mark.gpu
def test_compiled_decode_on_card(gpu):
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.standard_normal((4, 8, 128)), BF16)
    k = jnp.asarray(rng.standard_normal((4, 2, 1024, 128)), BF16)
    lens = jnp.asarray([1024, 700, 64, 1], jnp.int32)
    got = ops.flash_decode(q, k, k, lens, interpret=False)
    with jax.default_matmul_precision("highest"):
        want = ops.reference_attention(
            q[:, :, None], k, k, causal=True, q_offsets=lens - 1,
            kv_lens=lens)[:, :, 0]
    assert_rel_l2(np.asarray(got, np.float32), np.asarray(want), 1e-2)
