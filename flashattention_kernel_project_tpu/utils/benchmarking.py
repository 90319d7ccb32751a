"""Benchmark harness — the reference's uniform `main()` as a library.

Every reference binary follows the same skeleton (SURVEY.md section 3.1,
`GEMM/naive_GEMM/naive_gemm.cu:76-165`): fixed-seed init -> warmup launch ->
timed launch loop (cudaEvent) -> derived GFLOPS/GB/s -> CPU-oracle verify.
This module is that skeleton, once, for all kernels: `jax.block_until_ready`
timing with warmup, FLOP/byte-derived TFLOP/s and GB/s, roofline shares
against the attached card's published peaks, and the reduction of a
profiler trace to device time.
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import gzip
import json
import os
import time
from typing import Any, Callable

import jax

from flashattention_kernel_project_tpu.utils import platform


@dataclasses.dataclass
class BenchResult:
    name: str
    mean_ms: float
    min_ms: float
    iters: int
    flops: int | None = None
    bytes_accessed: int | None = None

    @property
    def tflops(self) -> float | None:
        if self.flops is None:
            return None
        return self.flops / (self.mean_ms * 1e-3) / 1e12

    @property
    def gbps(self) -> float | None:
        if self.bytes_accessed is None:
            return None
        return self.bytes_accessed / (self.mean_ms * 1e-3) / 1e9

    def roofline_fraction(self, dtype: str = "bf16") -> float | None:
        """Least possible time (the larger of flops/peak and bytes/peak)
        over the measured time."""
        bounds = []
        if self.flops is not None:
            bounds.append(self.flops / platform.peak_flops(dtype))
        if self.bytes_accessed is not None:
            bounds.append(self.bytes_accessed / platform.hbm_bandwidth())
        return max(bounds) / (self.mean_ms * 1e-3) if bounds else None

    def report(self, dtype: str = "bf16") -> str:
        parts = [f"{self.name}: {self.mean_ms:.4f} ms (min {self.min_ms:.4f})"]
        if self.flops is not None:
            parts.append(f"{self.tflops:.2f} TFLOP/s")
        if self.bytes_accessed is not None:
            parts.append(f"{self.gbps:.1f} GB/s")
        frac = self.roofline_fraction(dtype)
        if frac is not None:
            parts.append(f"{100.0 * frac:.1f}% of roofline")
        return " | ".join(parts)


def device_time_us(trace_dir: str) -> tuple[float, dict[str, float]]:
    """Reduce a jax.profiler trace dir to (busy device us, per-op us).

    Device events are those of the trace's GPU device processes
    ("/device:GPU:N"); busy time is the union of their intervals, so
    overlapping streams are not counted twice.
    """
    files = sorted(
        glob.glob(f"{trace_dir}/**/*.trace.json.gz", recursive=True),
        key=os.path.getmtime,
    )
    if not files:
        raise FileNotFoundError(f"no trace.json.gz under {trace_dir}")
    with gzip.open(files[-1]) as f:
        ev = json.load(f)["traceEvents"]
    pids = {
        e["pid"]: e["args"].get("name", "")
        for e in ev
        if e.get("ph") == "M" and e.get("name") == "process_name"
    }
    dev = {p for p, name in pids.items() if "/device:GPU" in name}
    if not dev:
        raise ValueError(f"no GPU device process in {files[-1]}")
    per_op: dict[str, float] = collections.defaultdict(float)
    spans = []
    for e in ev:
        if e.get("ph") == "X" and e.get("pid") in dev:
            per_op[e["name"]] += e.get("dur", 0.0)
            spans.append((e["ts"], e["ts"] + e.get("dur", 0.0)))
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        lo = max(lo, end)
        if hi > lo:
            busy += hi - lo
            end = hi
    return busy, dict(per_op)


def capture_trace(
    fn: Callable[..., Any],
    *args: Any,
    trace_dir: str,
    iters: int = 3,
) -> str:
    """Capture a jax.profiler trace of `fn(*args)` (compiled outside the
    trace) — the analog of the reference's per-file `ncu` recipes
    (SURVEY.md section 5.1). Returns the trace directory."""
    out = fn(*args)
    jax.block_until_ready(out)
    with jax.profiler.trace(trace_dir):
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
    return trace_dir


def benchmark(
    fn: Callable[..., Any],
    *args: Any,
    name: str = "kernel",
    warmup: int = 3,
    iters: int = 20,
    flops: int | None = None,
    bytes_accessed: int | None = None,
) -> BenchResult:
    """Time `fn(*args)` like the reference's cudaEvent loops.

    `fn` should already be jitted; the first call compiles (excluded via
    warmup, like the reference's warmup launch `naive_gemm.cu:119-121`).
    """
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)

    return BenchResult(
        name=name,
        mean_ms=1e3 * sum(times) / len(times),
        min_ms=1e3 * min(times),
        iters=iters,
        flops=flops,
        bytes_accessed=bytes_accessed,
    )
