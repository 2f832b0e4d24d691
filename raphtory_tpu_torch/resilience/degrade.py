"""Degraded-result ledger — who got partial answers, and how recently.

The degraded-serving contract (docs/RESILIENCE.md): a query whose retry
budget or deadline expires MID-sweep returns the hops it finished,
marked ``degraded: true`` with a ``coveredTime`` watermark, instead of
hanging or 500ing. This module is the bounded process-wide record of
those serves: ``/healthz`` grades ``degraded`` while any landed inside
the fast budget window, and ``/faultz`` renders the tally.

Everything is O(ring); a chaos storm serving thousands of partial
results cannot grow this without bound (RT011).
"""

from __future__ import annotations

import threading
import time
from collections import deque


class DegradedLedger:
    def __init__(self, ring: int = 256, clock=time.monotonic):
        self._mu = threading.Lock()
        self._clock = clock
        self._total = 0
        self._recent: deque[tuple[float, str, str]] = deque(maxlen=ring)

    def note(self, job_id: str, reason: str,
             covered_time: int | None = None) -> None:
        with self._mu:
            self._total += 1
            self._recent.append((self._clock(), str(job_id), reason))
            total = self._total
        try:
            from ..obs.metrics import METRICS

            METRICS.degraded_results.labels(reason).inc()
        except Exception:
            pass
        try:
            from ..obs.trace import TRACER

            TRACER.instant("degrade.serve", job_id=str(job_id),
                           reason=reason, covered_time=covered_time,
                           total=total)
        except Exception:
            pass
        try:
            from ..obs import journal

            if journal.enabled():
                journal.emit("degrade", {
                    "job_id": str(job_id), "reason": reason,
                    "covered_time": covered_time, "total": total})
        except Exception:
            pass

    def recent(self, window_s: float) -> int:
        """Degraded results served inside the trailing window."""
        now = self._clock()
        with self._mu:
            return sum(1 for t, _, _ in self._recent
                       if now - t <= window_s)

    def total(self) -> int:
        with self._mu:
            return self._total

    def snapshot(self) -> dict:
        now = self._clock()
        with self._mu:
            last = [{"job_id": j, "reason": r,
                     "seconds_ago": round(now - t, 3)}
                    for t, j, r in list(self._recent)[-8:]]
            return {"total": self._total, "last": last}

    def reset(self) -> None:
        with self._mu:
            self._total = 0
            self._recent.clear()


DEGRADED = DegradedLedger()
