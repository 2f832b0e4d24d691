"""Resilience plane — deterministic fault injection, unified retry
policy, circuit breakers, degraded-result bookkeeping.

The package is stdlib-only (no jax import) so the failpoint checks can
live in every layer — ingestion, transfer, device dispatch, scheduler,
REST — without dragging runtime deps into lint-time imports. Telemetry
(flight-recorder instants, metrics) is reached lazily and never raises:
the resilience plane must not be a new way to fail.

* :mod:`.faults` — named failpoints armed via ``RTPU_FAULTS``
  (``site=error|hang|slow:prob[:count][:seed]``); seeded, so chaos runs
  replay exactly; a disarmed check is one global-bool load.
* :mod:`.policy` — the one :class:`RetryPolicy` (failure classification,
  capped exponential backoff with full jitter, deadline-aware budgets)
  that every retry loop in the repo derives from.
* :mod:`.breaker` — per-peer closed→open→half-open circuit breakers so a
  dead peer costs one probe per window, not one socket timeout per
  federation pass.
* :mod:`.degrade` — bounded ledger of degraded (partial) results served,
  graded into ``/healthz``.

Operator surface: ``/faultz`` (jobs/rest.py) renders :func:`faultz`;
``RTPU_FAULT_DUMP`` writes the same document at interpreter exit (the CI
failure artifact). Full story: docs/RESILIENCE.md.
"""

from __future__ import annotations

from .breaker import BREAKERS, CircuitBreaker
from .degrade import DEGRADED
from .faults import FaultError, faultz, fire
from .policy import RetryPolicy, is_transient_message

__all__ = [
    "BREAKERS",
    "CircuitBreaker",
    "DEGRADED",
    "FaultError",
    "RetryPolicy",
    "faultz",
    "fire",
    "is_transient_message",
]
