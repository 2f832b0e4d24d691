"""The one retry policy — classification, capped backoff with full
jitter, deadline-aware budgets.

Every retry loop in the repo derives from here (the transfer engine's
wire loop, peer scrapes/forwards). The shape all of them share:

* **Classify first.** Programming errors (bad shapes, real OOM,
  INVALID_ARGUMENT) re-raise immediately — burning a backoff schedule
  on a bug hides it for ~minutes (rtpulint RT002 exists because of
  this). Transient transport wobbles retry.
* **Capped exponential backoff with FULL jitter.** The classic
  ``base * 2**attempt`` makes every failed caller wake in lockstep and
  re-stampede whatever just fell over; drawing uniformly from
  ``[0, min(cap, base * 2**(attempt-1))]`` (AWS-style full jitter)
  decorrelates the herd. ``RTPU_RETRY_CAP_S`` bounds the ceiling.
* **Deadline-aware budgets.** A caller holding a scheduler
  ``deadline_ms`` passes the absolute deadline; the policy refuses to
  start a sleep that would overrun it and re-raises the last error
  instead — the jobs layer then degrades honestly rather than blowing
  the deadline inside a sleep.

Telemetry per decision (never on the zero-failure hot path):
``retry.attempt`` flight-recorder instants and
``raphtory_retry_attempts_total{site,outcome}`` with outcome one of
``retry`` / ``fatal`` / ``exhausted`` / ``deadline``.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass, field
from typing import Callable

# Shared failure-classification markers (the transfer engine's
# classifier reuses these; tests/test_transfer_pipeline.py pins them).
TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "CANCELLED",
    "Connection reset",
    "connection reset",
    "Socket closed",
    "socket closed",
)

PROGRAMMING_MARKERS = (
    "INVALID_ARGUMENT",
    "RESOURCE_EXHAUSTED",
    "UNIMPLEMENTED",
    "NOT_FOUND",
    "FAILED_PRECONDITION",
)


def is_transient_message(msg: str) -> bool | None:
    """Classify an error MESSAGE: True (transient marker), False
    (programming marker), None (no marker — caller decides by type)."""
    if any(m in msg for m in PROGRAMMING_MARKERS):
        return False
    if any(m in msg for m in TRANSIENT_MARKERS):
        return True
    return None


def default_classify(e: BaseException) -> bool:
    """Generic transient test for non-device sites: injected faults and
    marked/transport errors retry, everything else is a bug."""
    from .faults import FaultError

    if isinstance(e, FaultError):
        return True
    verdict = is_transient_message(str(e))
    if verdict is not None:
        return verdict
    return isinstance(e, (TimeoutError, ConnectionError, OSError))


def retry_cap_s() -> float:
    """``RTPU_RETRY_CAP_S`` — backoff ceiling shared by every policy."""
    try:
        return float(os.environ.get("RTPU_RETRY_CAP_S", "") or 60.0)
    except ValueError:
        return 60.0


_METRICS_SENTINEL = object()
_METRICS = _METRICS_SENTINEL


def _metrics():
    global _METRICS
    if _METRICS is _METRICS_SENTINEL:
        try:
            from ..obs.metrics import METRICS as _M

            _METRICS = _M
        except Exception:
            _METRICS = None
    return _METRICS


def note_attempt(site: str, outcome: str, attempt: int,
                 wait: float) -> None:
    """Record one retry decision (metric + instant, never raises) —
    public so loops that keep their own structure (the transfer
    engine's pipelined slice retry) report through the same channel."""
    m = _metrics()
    if m is not None:
        try:
            m.retry_attempts.labels(site, outcome).inc()
        except Exception:
            pass
    try:
        from ..obs.trace import TRACER

        TRACER.instant("retry.attempt", site=site, outcome=outcome,
                       attempt=attempt, wait_s=round(wait, 4))
    except Exception:
        pass


@dataclass
class RetryPolicy:
    """``attempts`` total tries (1 = no retries); ``base_s`` doubles per
    attempt, capped at ``cap_s`` (None = the ``RTPU_RETRY_CAP_S`` knob);
    ``classify(e)`` True means retryable; ``rng`` is injectable so tests
    replay jitter deterministically."""

    attempts: int = 4
    base_s: float = 1.0
    cap_s: float | None = None
    classify: Callable[[BaseException], bool] = field(
        default=default_classify)
    rng: random.Random = field(default_factory=lambda: random)  # type: ignore[assignment]

    def backoff_s(self, attempt: int) -> float:
        """Full-jitter wait before re-attempt ``attempt`` (1-based):
        uniform over [0, min(cap, base * 2**(attempt-1))]."""
        cap = self.cap_s if self.cap_s is not None else retry_cap_s()
        ceiling = min(cap, self.base_s * (2.0 ** (attempt - 1)))
        if ceiling <= 0.0:
            return 0.0
        return self.rng.uniform(0.0, ceiling)

    def run(self, fn, *, site: str = "generic",
            deadline: float | None = None,
            clock: Callable[[], float] = time.monotonic,
            on_retry: Callable[[int, BaseException, float], None]
            | None = None):
        """Call ``fn()`` under the policy. ``deadline`` is an absolute
        ``clock()`` timestamp: a backoff that would overrun it re-raises
        the last transient error instead of sleeping through it."""
        err: BaseException | None = None
        for attempt in range(1, max(1, self.attempts) + 1):
            try:
                return fn()
            except Exception as e:
                if not self.classify(e):
                    note_attempt(site, "fatal", attempt, 0.0)
                    raise
                err = e
                if attempt >= self.attempts:
                    note_attempt(site, "exhausted", attempt, 0.0)
                    raise
                wait = self.backoff_s(attempt)
                if deadline is not None and clock() + wait > deadline:
                    note_attempt(site, "deadline", attempt, wait)
                    raise
                note_attempt(site, "retry", attempt, wait)
                if on_retry is not None:
                    on_retry(attempt, e, wait)
                if wait > 0.0:
                    time.sleep(wait)
        raise err if err is not None else RuntimeError("unreachable")
