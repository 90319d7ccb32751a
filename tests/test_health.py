"""Failure-detection utilities (SURVEY.md section 5.3 analog)."""

import pytest

from flashattention_kernel_project_tpu.utils import health


@pytest.mark.smoke
def test_healthcheck_ok():
    r = health.device_healthcheck()
    assert r["ok"], r
    assert r["latency_s"] < 30


def test_transient_classification():
    assert health.is_transient_error(
        RuntimeError("UNAVAILABLE: worker process crashed or restarted")
    )
    assert not health.is_transient_error(ValueError("shape mismatch"))


@pytest.mark.smoke
def test_with_retries_recovers_transient():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("UNAVAILABLE: socket closed")
        return 42

    assert health.with_retries(flaky, max_retries=3, cooldown_s=0.0) == 42
    assert len(calls) == 3


def test_with_retries_fails_fast_on_fatal():
    def fatal():
        raise ValueError("kernel bug")

    with pytest.raises(ValueError):
        health.with_retries(fatal, max_retries=5, cooldown_s=0.0)


def test_with_retries_classifies_donated_buffer_on_retry():
    """A retry hitting 'Array has been deleted' (its input was donated to
    the failed attempt, e.g. engine.extend_paged's cache) must raise a
    classified RuntimeError chained to the ORIGINAL transient fault, not
    loop or surface the bare deleted-buffer error (advisor r3)."""
    calls = []

    def donated_then_dead():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("UNAVAILABLE: worker process crashed or restarted")
        raise RuntimeError("Array has been deleted with shape=bfloat16[8]")

    with pytest.raises(RuntimeError, match="state must be rebuilt"):
        health.with_retries(donated_then_dead, max_retries=3, cooldown_s=0.0)
    assert len(calls) == 2  # no further retries after the deleted signal


def test_with_retries_deleted_on_first_attempt_is_fatal():
    """'has been deleted' on the FIRST attempt is a caller bug (stale
    handle), not a retry artifact — it propagates as-is (it is not a
    transient marker)."""
    def dead():
        raise RuntimeError("Array has been deleted")

    with pytest.raises(RuntimeError, match="has been deleted"):
        health.with_retries(dead, max_retries=3, cooldown_s=0.0)
