"""Per-peer circuit breakers — closed → open → half-open.

A dead ``/clusterz`` peer used to cost one full socket timeout per
federation pass (every snapshot, every advisor tick). Behind a breaker
it costs ``threshold`` timeouts ONCE, then one half-open probe per
``window_s`` until it answers again; every skipped pass renders
``reachable: false`` with the breaker as evidence instead of paying the
wire.

Transitions emit ``breaker.state`` flight-recorder instants and set the
``raphtory_breaker_state{peer}`` gauge (0 closed, 1 half-open, 2 open)
— both OUTSIDE the breaker lock, repo rule. The clock is injectable so
tests drive window expiry without sleeping.

Knobs: ``RTPU_BREAKER_THRESHOLD`` consecutive failures open the breaker
(default 3); ``RTPU_BREAKER_WINDOW_S`` seconds open before the next
half-open probe (default 10).
"""

from __future__ import annotations

import os
import threading
import time

_STATE_CODE = {"closed": 0, "half-open": 1, "open": 2}


def breaker_threshold() -> int:
    """``RTPU_BREAKER_THRESHOLD`` — consecutive failures that open."""
    try:
        return max(1, int(
            os.environ.get("RTPU_BREAKER_THRESHOLD", "") or 3))
    except ValueError:
        return 3


def breaker_window_s() -> float:
    """``RTPU_BREAKER_WINDOW_S`` — open dwell before a half-open probe."""
    try:
        return float(os.environ.get("RTPU_BREAKER_WINDOW_S", "") or 10.0)
    except ValueError:
        return 10.0


def _note_state(name: str, state: str, failures: int) -> None:
    try:
        from ..obs.metrics import METRICS

        METRICS.breaker_state.labels(name).set(_STATE_CODE[state])
    except Exception:
        pass
    try:
        from ..obs.trace import TRACER

        TRACER.instant("breaker.state", peer=name, state=state,
                       failures=failures)
    except Exception:
        pass
    try:
        from ..obs import journal

        if journal.enabled():
            journal.emit("breaker", {"peer": name, "state": state,
                                     "failures": failures})
    except Exception:
        pass


class CircuitBreaker:
    def __init__(self, name: str, threshold: int | None = None,
                 window_s: float | None = None, clock=time.monotonic):
        self.name = name
        self.threshold = threshold or breaker_threshold()
        self.window_s = (window_s if window_s is not None
                         else breaker_window_s())
        self._clock = clock
        self._mu = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self._last_ok: float | None = None
        self._last_error = ""

    # ---- the two calls every guarded site makes ----

    def allow(self) -> bool:
        """May this call go to the wire? Open breakers say no until the
        window elapses, then exactly ONE caller gets the half-open
        probe; the rest keep fast-failing until it resolves."""
        transition = None
        with self._mu:
            if self._state == "closed":
                allowed = True
            elif self._state == "open":
                if self._clock() - self._opened_at < self.window_s:
                    allowed = False
                else:
                    self._state = "half-open"
                    self._probing = True
                    transition = ("half-open", self._failures)
                    allowed = True
            elif self._probing:     # half-open, probe already in flight
                allowed = False
            else:                   # half-open, probe slot free
                self._probing = True
                allowed = True
        if transition is not None:
            _note_state(self.name, *transition)
        return allowed

    def record(self, ok: bool, error: str = "") -> None:
        """Report the call's outcome (every allowed call must)."""
        transition = None
        with self._mu:
            if ok:
                self._last_ok = self._clock()
                self._last_error = ""
                if self._state != "closed":
                    transition = ("closed", self._failures)
                self._state = "closed"
                self._failures = 0
                self._probing = False
            else:
                self._failures += 1
                self._last_error = error[:200]
                if self._state == "half-open":
                    self._probing = False
                    self._state = "open"
                    self._opened_at = self._clock()
                    transition = ("open", self._failures)
                elif (self._state == "closed"
                        and self._failures >= self.threshold):
                    self._state = "open"
                    self._opened_at = self._clock()
                    transition = ("open", self._failures)
            failures = self._failures
        if transition is not None:
            _note_state(self.name, transition[0], failures)

    # ---- observability ----

    def state(self) -> str:
        with self._mu:
            return self._state

    def snapshot(self) -> dict:
        with self._mu:
            now = self._clock()
            out = {
                "state": self._state,
                "failures": self._failures,
                "threshold": self.threshold,
                "window_s": self.window_s,
            }
            if self._state == "open":
                out["retry_in_s"] = round(
                    max(0.0, self.window_s - (now - self._opened_at)), 3)
            if self._last_ok is not None:
                out["seconds_since_last_ok"] = round(now - self._last_ok, 3)
            if self._last_error:
                out["last_error"] = self._last_error
            return out


class BreakerRegistry:
    """Bounded name → breaker map (cap 256: peer sets are small; a
    runaway name source must not grow this without bound — RT011)."""

    def __init__(self, cap: int = 256):
        self._mu = threading.Lock()
        self._cap = cap
        self._breakers: dict[str, CircuitBreaker] = {}

    def get(self, name: str, **kw) -> CircuitBreaker:
        with self._mu:
            br = self._breakers.get(name)
            if br is None:
                if len(self._breakers) >= self._cap:
                    # evict the oldest-inserted entry (dict order)
                    self._breakers.pop(next(iter(self._breakers)))
                br = self._breakers[name] = CircuitBreaker(name, **kw)
            return br

    def snapshot(self) -> dict:
        with self._mu:
            brs = list(self._breakers.values())
        return {br.name: br.snapshot() for br in brs}

    def reset(self) -> None:
        with self._mu:
            self._breakers.clear()


BREAKERS = BreakerRegistry()
