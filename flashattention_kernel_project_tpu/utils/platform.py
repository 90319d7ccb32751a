"""Device peaks, Pallas interpret-mode resolution and the compile cache.

Every benchmark reports against the attached card's published peaks, so a
roofline share is "fraction of speed-of-light". A device that is not in
the table is an error, never a default.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
from typing import NamedTuple

import jax

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]


class Peaks(NamedTuple):
    bf16_flops: float   # dense bf16/fp16 tensor-core FLOP/s
    int8_ops: float     # dense fp8 FLOP/s == int8 OP/s
    tf32_flops: float   # dense TF32 tensor-core FLOP/s
    hbm_bytes: float    # device-memory bytes/s


# Keyed by jax Device.device_kind. Source: NVIDIA H100 Tensor Core GPU data
# sheet, SXM5 part, dense rates without sparsity, at its 700 W limit.
_H100_SXM = Peaks(989e12, 1979e12, 495e12, 3.35e12)
PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
    "NVIDIA H100 SXM5 80GB": _H100_SXM,
}


def peaks(device_kind: str | None = None) -> Peaks:
    """Published peaks of `device_kind` (default: the first JAX device)."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            "utils.platform.PEAKS with its source"
        ) from None


def peak_flops(dtype: str = "bf16", device_kind: str | None = None) -> float:
    p = peaks(device_kind)
    if dtype in ("int8", "fp8"):
        return p.int8_ops
    if dtype in ("fp32", "f32", "float32", "tf32"):
        return p.tf32_flops
    return p.bf16_flops


def hbm_bandwidth(device_kind: str | None = None) -> float:
    return peaks(device_kind).hbm_bytes


def require_gpu() -> jax.Device:
    """A measurement runs on the card or not at all: exit with a message
    when JAX has no GPU."""
    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"no GPU found (JAX backend {jax.default_backend()!r}); this "
            "measurement runs only on the card"
        )
    return jax.devices()[0]


# ---------------------------------------------------------------------------
# Pallas interpret mode
# ---------------------------------------------------------------------------

_INTERPRET = False


@contextlib.contextmanager
def interpret_kernels(on: bool = True):
    """Within this context a kernel call that leaves `interpret` unset runs
    in the Pallas interpreter. The test suite enters it once (conftest);
    nothing else should."""
    global _INTERPRET
    prev, _INTERPRET = _INTERPRET, on
    try:
        yield
    finally:
        _INTERPRET = prev


def resolve_interpret(interpret: bool | None) -> bool:
    """The interpret flag a Pallas kernel runs with.

    interpret=None takes the `interpret_kernels` context's setting (off
    outside it). A kernel that would run compiled needs a GPU: on any other
    backend it raises instead of silently falling back to the interpreter.
    """
    if interpret is None:
        interpret = _INTERPRET
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "Pallas GPU kernels need a GPU backend (found "
            f"{jax.default_backend()!r}); pass interpret=True to run them "
            "in the Pallas interpreter"
        )
    return bool(interpret)


# ---------------------------------------------------------------------------
# Persistent compile cache
# ---------------------------------------------------------------------------

def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    JAX_COMPILATION_CACHE_DIR wins when set (JAX reads it itself; nothing
    else is set). Otherwise the cache lives at the fixed `.jax_cache/` of
    the checkout, so a second run of the same checkout hits it.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(REPO_ROOT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
