"""The Triton modules the kernels compile from, checked on the CPU.

Interpret mode never builds a Triton module, so a kernel can pass every
interpreted test and still be refused by the GPU compiler. Here each kernel
variant is lowered for CUDA (which needs no GPU) and every Triton module it
emits must pass the MLIR verifier, the first check the GPU compiler makes.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import pytest
from jax._src.pallas.triton import lowering as triton_lowering

from flashattention_kernel_project_tpu import ops

fa = importlib.import_module(
    "flashattention_kernel_project_tpu.ops.flash_attention"
)

S = jax.ShapeDtypeStruct
BF16, F32, I32, I8 = jnp.bfloat16, jnp.float32, jnp.int32, jnp.int8
N, D = 256, 128
Q, KV = S((2, 4, N, D), BF16), S((2, 1, N, D), BF16)
LENS = S((2,), I32)
QD = S((2, 4, D), BF16)


def _q8(dt=I8):
    return S((2, 1, N, D), dt), S((2, 1, N, 1), F32)


def _grad(causal, q_offset=0, window=None, sinks=0):
    def loss(q, k, v):
        o = fa._flash_attention(q, k, v, causal, None, q_offset, False,
                                window, sinks)
        return jnp.sum(o.astype(F32))

    return jax.grad(loss, (0, 1, 2)), (Q, KV, KV)


def _kv_quant(dt, causal):
    kq, ks = _q8(dt)
    return functools.partial(ops.flash_attention_kv_quant_with_lse,
                             causal=causal, interpret=False), (Q, kq, ks, kq, ks)


def _paged(quant, page):
    n_pages = 2 * (N // page) + 1
    tbl = S((2, N // page), I32)
    if quant:
        p, s = S((n_pages, 1, page, D), I8), S((n_pages, 1, page, 1), F32)
        return (functools.partial(ops.paged_flash_decode_quant,
                                  interpret=False),
                (QD, p, s, p, s, tbl, LENS))
    p = S((n_pages, 1, page, D), BF16)
    return (functools.partial(ops.paged_flash_decode, interpret=False),
            (QD, p, p, tbl, LENS))


CASES = {
    # forward + both backward kernels: 3 modules each
    "grad causal": lambda: _grad(True),
    "grad full": lambda: _grad(False),
    "grad q_offset": lambda: _grad(True, q_offset=64),
    "grad window": lambda: _grad(True, window=64),
    "grad window sinks": lambda: _grad(True, window=64, sinks=4),
    "fwd lse int8 full": lambda: _kv_quant(I8, False),
    "fwd lse fp8 causal": lambda: _kv_quant(jnp.float8_e4m3fn, True),
    "ragged": lambda: (functools.partial(
        ops.flash_attention_ragged, interpret=False, window=64, sinks=4),
        (S((2, 4, 64, D), BF16), KV, KV, LENS, LENS)),
    "ragged int8": lambda: (functools.partial(
        ops.flash_attention_ragged_kv_quant, interpret=False),
        (S((2, 4, 64, D), BF16), *_q8(), *_q8(), LENS, LENS)),
    "decode": lambda: (functools.partial(ops.flash_decode, interpret=False),
                       (QD, KV, KV, LENS)),
    "decode window sinks": lambda: (functools.partial(
        ops.flash_decode, interpret=False, window=64, sinks=4),
        (QD, KV, KV, LENS)),
    "decode int8": lambda: (functools.partial(
        ops.flash_decode_int8, interpret=False), (QD, *_q8(), *_q8(), LENS)),
    "paged": lambda: _paged(False, 64),
    "paged int8": lambda: _paged(True, 64),
    "paged small pages": lambda: _paged(False, 16),
}


@pytest.fixture
def verifier(monkeypatch):
    """Run the MLIR verifier on every Triton module lowered while the test
    runs; the list holds one entry per module (None when it verified).
    The backend reads as "gpu" so compiled (not interpreted) kernels lower.
    """
    results = []
    lower = triton_lowering.lower_jaxpr_to_triton_module

    def checked(*args, **kwargs):
        res = lower(*args, **kwargs)
        try:
            res.module.operation.verify()
            results.append(None)
        except Exception as e:  # the verifier's report is the test's output
            results.append(str(e))
        return res

    monkeypatch.setattr(triton_lowering, "lower_jaxpr_to_triton_module",
                        checked)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    jax.clear_caches()
    yield results
    jax.clear_caches()


@pytest.mark.parametrize("case", list(CASES))
def test_triton_modules_verify(verifier, case):
    fn, args = CASES[case]()
    jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",))
    assert verifier, "no Triton module was lowered"
    errors = [e for e in verifier if e is not None]
    assert not errors, errors[0][:2000]
    if case.startswith("grad"):
        assert len(verifier) == 3
