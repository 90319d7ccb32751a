"""Failure detection + fail-fast recovery for the serving path.

Reference analog (SURVEY.md section 5.3): the reference has only a
CHECK_CUDA abort macro (`naive_gemm.cu:13-21`) and hand-rolled spin
timeouts with [STUCK] printf for hang hunting
(`flashattn_warp_spc_v2/..._v7_2_dbg_hanghunt.cu:54,163,231-234`).
The runtime detects device faults for us, but a long-lived serving
process still needs: (a) a cheap liveness probe, (b) classification of
transient vs fatal dispatch errors, and (c) bounded retry for transient
runtime faults (UNAVAILABLE and the like, after which the same program
re-runs fine).
"""

from __future__ import annotations

import time
from typing import Any, Callable

# error-message fragments that indicate a transient runtime fault (worker
# restart / preemption), safe to retry after a cooldown
_TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "worker process crashed or restarted",
    "socket closed",
    "connection reset",
    "DEADLINE_EXCEEDED",
)


def is_transient_error(err: BaseException) -> bool:
    msg = str(err)
    return any(marker.lower() in msg.lower() for marker in _TRANSIENT_MARKERS)


# a retry re-invoking a DONATED-argument program can find its input buffers
# already consumed by the failed attempt — that state is unrecoverable from
# inside the retry loop (the caller must rebuild the state, e.g. re-prefill
# a KV cache); classify it so the failure is explicit, not a crash loop
_DELETED_MARKERS = ("has been deleted", "buffer was donated")


def is_deleted_buffer_error(err: BaseException) -> bool:
    msg = str(err)
    return any(marker.lower() in msg.lower() for marker in _DELETED_MARKERS)


def device_healthcheck(timeout_s: float = 30.0) -> dict:
    """Cheap liveness probe: a tiny matmul, forced to completion.

    Returns {"ok": bool, "latency_s": float, "device": str, "error": str?}.
    The probe forces a host fetch (np.asarray), so it completes only once
    the device has run it."""
    import concurrent.futures
    import numpy as np

    t0 = time.perf_counter()

    def _probe():
        import jax
        import jax.numpy as jnp

        dev = jax.devices()[0]
        x = jnp.ones((128, 128), jnp.float32)
        got = float(np.asarray(jnp.dot(x, x).sum()))
        return abs(got - 128.0 * 128 * 128) < 1.0, str(dev)

    # a wedged device is exactly what we probe for — run the dispatch on a
    # worker thread so the deadline is enforced even if it never returns
    ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    try:
        ok, dev = ex.submit(_probe).result(timeout=timeout_s)
        return {"ok": ok, "latency_s": time.perf_counter() - t0, "device": dev}
    except concurrent.futures.TimeoutError:
        return {
            "ok": False,
            "latency_s": time.perf_counter() - t0,
            "device": "unknown",
            "error": f"healthcheck exceeded {timeout_s}s (device wedged?)",
        }
    except Exception as e:  # noqa: BLE001 - a probe must not raise
        return {
            "ok": False,
            "latency_s": time.perf_counter() - t0,
            "device": "unknown",
            "error": f"{type(e).__name__}: {e}",
        }
    finally:
        ex.shutdown(wait=False)


def with_retries(
    fn: Callable[..., Any],
    *args: Any,
    max_retries: int = 2,
    cooldown_s: float = 5.0,
    on_retry: Callable[[int, BaseException], None] | None = None,
    **kwargs: Any,
) -> Any:
    """Run `fn`, retrying transient runtime faults (worker restarts) with a
    cooldown; fatal errors (shape errors, OOM, kernel bugs) raise
    immediately — fail fast, like the reference's CHECK_CUDA.

    Donation-aware: if a RETRY attempt fails because an input
    buffer was already deleted (donated to the failed attempt — e.g. the
    paged cache in engine.extend_paged), that is NOT retryable: the state
    must be rebuilt by the caller. It raises a classified RuntimeError
    chained to the original transient fault instead of looping on a
    confusing 'Array has been deleted'."""
    attempt = 0
    first_err: BaseException | None = None
    while True:
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - classified below
            if attempt > 0 and is_deleted_buffer_error(e):
                raise RuntimeError(
                    "retry found its input buffers deleted (donated to the "
                    "failed attempt); state must be rebuilt by the caller "
                    f"— original fault: {first_err!r}"
                ) from e
            if not is_transient_error(e) or attempt >= max_retries:
                raise
            first_err = first_err or e
            attempt += 1
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(cooldown_s)
