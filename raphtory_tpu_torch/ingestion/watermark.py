"""Watermarks — the snapshot fence.

The reference's correctness backbone (SURVEY §3.3): per-router message-id
epochs acked through the cross-partition sync dance, folded every 10s into
per-shard ``windowTime``/``safeWindowTime`` that gate analysis
(``IngestionWorker.scala:219-256``, ``ReaderWorker.scala:259-274``).

With an append-only log and immutable snapshots the protocol collapses: a
source's watermark is "no event with time <= w will ever be appended by this
source" (its max emitted event-time minus its declared disorder bound). The
global safe time is the min over live sources; a view at T is exact once
T <= safe_time. No acks — applying an event IS its acknowledgement.
"""

from __future__ import annotations

import threading
import time as _time

from ..obs import freshness as _fresh
from ..obs.metrics import METRICS
from ..obs.trace import TRACER
from ..resilience import faults as _faults

_NEG_INF = -(2**62)


class WatermarkRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._marks: dict[str, int] = {}
        self._done: set[str] = set()
        # sources that advanced at least once — what separates a live
        # source that is IDLE (registered, no traffic yet) from one that
        # is STALLED (was streaming, stopped): the freshness plane and
        # the watermark-stale advisor rule must not alarm on the former
        self._ever_advanced: set[str] = set()
        # freshness clock for raphtory_watermark_lag_seconds: when the
        # global safe time last MOVED (monotonic). A pull-time gauge —
        # the newest registry wires the callable, so the serving node's
        # graph wins over short-lived test registries.
        self._safe_seen = _NEG_INF
        self._advanced_at = _time.monotonic()
        METRICS.watermark_lag.set_function(self.lag_seconds)

    def register(self, source: str) -> None:
        with self._lock:
            self._marks.setdefault(source, _NEG_INF)

    def advance(self, source: str, watermark: int) -> None:
        # the watermark.advance failpoint fires BEFORE the lock: an
        # injected error/hang stalls this source's fence exactly like a
        # wedged feeder would, without poisoning registry state
        _faults.fire("watermark.advance")
        advanced = False
        with self._lock:
            cur = self._marks.get(source, _NEG_INF)
            if watermark > cur:
                self._marks[source] = watermark
                self._ever_advanced.add(source)
                advanced = True
            safe, changed = self._gauge_locked()
            self._cond.notify_all()
        if advanced and TRACER.enabled:   # instant marker, outside the lock
            TRACER.instant("watermark.advance", source=source,
                           watermark=int(watermark))
        if changed:
            # the fence moved: pending ingest batches it now covers
            # became queryable (obs/freshness.py) — called OUTSIDE our
            # lock, the freshness registry has its own; the drain is
            # idempotent, so a down-move (new source) is a cheap no-op
            _fresh.FRESH.note_safe(safe)

    def finish(self, source: str) -> None:
        """Source exhausted: it can never hold the fence back again."""
        with self._lock:
            self._done.add(source)
            safe, changed = self._gauge_locked()
            self._cond.notify_all()
        if TRACER.enabled:
            TRACER.instant("watermark.finish", source=source)
        if changed:
            _fresh.FRESH.note_safe(safe)

    def wait_for(self, time: int, timeout: float | None = None) -> bool:
        """Block until ``safe_time() >= time`` (True) or timeout (False) —
        the condition-variable fence wait that replaces the reference's
        10-second recheck loop (``AnalysisTask.scala:183-189``)."""
        with self._cond:
            return self._cond.wait_for(
                lambda: self._safe_locked() >= time, timeout)

    def _safe_locked(self) -> int:
        live = [w for s, w in self._marks.items() if s not in self._done]
        return min(live) if live else 2**62

    def _gauge_locked(self) -> tuple[int, bool]:
        # compute-and-set under _lock: a preempted thread must not clobber a
        # newer safe_time with a stale lower one. Returns (safe, changed) so
        # callers can notify the freshness plane OUTSIDE the lock.
        t = self._safe_locked()
        changed = t != self._safe_seen
        if t > self._safe_seen:
            # the fence ADVANCED — the lag clock resets
            self._advanced_at = _time.monotonic()
        if changed:
            # track DOWN-moves too (a new live source registering after
            # others advanced/finished legitimately lowers the fence —
            # including off the all-done 2^62 sentinel): if _safe_seen
            # stayed pinned high, every future advance would read
            # t < _safe_seen, "changed" would never fire again, and the
            # freshness plane's queryable drain plus this lag clock
            # would be frozen for the registry's remaining lifetime
            self._safe_seen = t
        if abs(t) < 2**62:  # only meaningful mid-stream values
            METRICS.watermark.set(t)
        return t, changed

    def lag_state(self) -> tuple[str, float]:
        """``(state, lag_seconds)`` — the explicit idle/active
        distinction ``lag_seconds`` alone could not make:

        * ``"done"``, 0.0 — no live sources (all finished, or none
          registered): nothing can be stalled.
        * ``"idle"``, 0.0 — live sources are registered but NONE has
          ever advanced: no traffic yet, not a stall. The freshness
          plane and the ``watermark-stale`` advisor rule stay quiet.
        * ``"active"``, lag — at least one live source has streamed;
          lag is seconds since the global safe time last advanced
          (0 while the fence is moving, growing when a source stalls).
        """
        with self._lock:
            live = [s for s in self._marks if s not in self._done]
            if not live:
                return "done", 0.0
            if not any(s in self._ever_advanced for s in live):
                return "idle", 0.0
            return "active", max(0.0, _time.monotonic() - self._advanced_at)

    def lag_seconds(self) -> float:
        """Seconds since this process's global safe time last advanced —
        0 while the fence is moving, while nothing is streaming, or
        while every live source is still idle (registered, no traffic —
        ``lag_state`` makes the distinction explicit); growing when a
        source that WAS streaming stalls. The per-process
        ``raphtory_watermark_lag_seconds`` gauge reads this at scrape
        time; /statusz and /clusterz embed it."""
        return self.lag_state()[1]

    def source_states(self) -> dict[str, str]:
        """Per-source lifecycle: ``idle`` (registered, never advanced),
        ``active`` (advancing or stalled — judged globally by
        ``lag_state``), ``done`` (finished)."""
        with self._lock:
            return {s: ("done" if s in self._done
                        else "active" if s in self._ever_advanced
                        else "idle")
                    for s in self._marks}

    def safe_time(self) -> int:
        """Largest T such that every live source has promised no more events
        at or before T. +inf (2^62) if all sources finished."""
        with self._lock:
            return self._safe_locked()

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._marks)
