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

_NEG_INF = -(2**62)


class WatermarkRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._marks: dict[str, int] = {}
        self._done: set[str] = set()

    def register(self, source: str) -> None:
        with self._lock:
            self._marks.setdefault(source, _NEG_INF)

    def advance(self, source: str, watermark: int) -> None:
        with self._lock:
            if watermark > self._marks.get(source, _NEG_INF):
                self._marks[source] = watermark
            self._cond.notify_all()

    def finish(self, source: str) -> None:
        """Source exhausted: it can never hold the fence back again."""
        with self._lock:
            self._done.add(source)
            self._cond.notify_all()

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

    def safe_time(self) -> int:
        """Largest T such that every live source has promised no more events
        at or before T. +inf (2^62) if all sources finished."""
        with self._lock:
            return self._safe_locked()

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._marks)
