"""TemporalGraph — the user-facing handle tying log, watermarks and device.

The single-process equivalent of the reference deployment
(``SingleNodeSetup.scala``): storage + ingestion fence + the device analysis
runs on, behind one object. The watermark fence reproduces the
``TimeCheck``/``TimeResponse`` gate (``AnalysisTask.scala:162-195``): a view
at T is only served as *exact* once every source's watermark has passed T.

Views are served two ways (``raphtory_tpu/core/service.py``): a small cache
of host ``GraphView`` folds (``view_at``, the cold route) and one shared
device-resident ``DeviceSweep`` (``resident_acquire``, the warm route).
"""

from __future__ import annotations

import collections
import threading
import time as _time

from ..ingestion.watermark import WatermarkRegistry
from ..obs.metrics import METRICS
from ..obs.trace import TRACER
from ..utils.device import resolve_device
from .events import EventLog
from .snapshot import GraphView, build_view


class StaleViewError(RuntimeError):
    """The watermark fence did not pass the view's time in time."""


class TemporalGraph:
    """``device`` is where this graph's analyses run: ``None`` means the CUDA
    card (and raises without one); the tests pass ``"cpu"``."""

    def __init__(self, log: EventLog | None = None,
                 watermarks: WatermarkRegistry | None = None,
                 device=None, cache_size: int = 8):
        self.device = resolve_device(device)
        self.log = log if log is not None else EventLog()
        self.watermarks = (watermarks if watermarks is not None
                           else WatermarkRegistry())
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self._cache_size = cache_size
        self._cache_lock = threading.Lock()  # jobs share one graph
        # warm View engine: one resident DeviceSweep shared by View
        # dispatches — a repeat view is a delta-advance + one dispatch, not
        # a full host fold + O(m) upload
        self._resident = None
        self._resident_lock = threading.Lock()
        self._resident_version = -1
        self._resident_n = 0            # rows scanned for post-pin events
        self._post_pin_min = 2**62      # min event time appended after pin
        self._resident_broken = False   # >= 2^31 vertices: stop retrying

    @property
    def earliest_time(self) -> int:
        return self.log.min_time

    @property
    def latest_time(self) -> int:
        return self.log.max_time

    def safe_time(self) -> int:
        """Largest timestamp no in-flight source can still mutate."""
        return min(self.watermarks.safe_time(), 2**62)

    # ---- views (the GraphLens surface) ----

    def view_at(self, time: int, *, exact: bool = True,
                wait_timeout: float = 0.0,
                include_occurrences: bool = False) -> GraphView:
        """Host snapshot at ``time``. ``exact=True`` enforces the watermark
        fence, polling up to ``wait_timeout`` seconds; ``exact=False``
        serves a best-effort live view. ``include_occurrences`` attaches
        the occurrence rows (part of the cache key)."""
        if exact and not self.watermarks.wait_for(time,
                                                  timeout=wait_timeout):
            raise StaleViewError(
                f"view at {time} not yet safe: watermark="
                f"{self.safe_time()} ({self.watermarks.snapshot()})")
        version = self.log.version
        key = (version, int(time), bool(include_occurrences))
        with self._cache_lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
                return hit
        t0 = _time.perf_counter()
        with TRACER.span("snapshot.fold", time=int(time),
                         occurrences=bool(include_occurrences)):
            view = build_view(self.log, int(time),
                              include_occurrences=include_occurrences)
        METRICS.snapshot_build_seconds.observe(_time.perf_counter() - t0)
        self.cache_put(int(time), view, include_occurrences, version=version)
        return view

    def cache_put(self, time: int, view: GraphView,
                  include_occurrences: bool = False, *,
                  version: int | None = None) -> None:
        """Insert an externally built view (e.g. a SweepBuilder hop) into the
        cache. ``version`` must be the log version the view was BUILT from
        (a sweep's pinned log), not the current one."""
        METRICS.view_vertices.set(view.n_active)
        METRICS.view_edges.set(view.m_active)
        if version is None:
            version = self.log.version
        key = (version, int(time), bool(include_occurrences))
        with self._cache_lock:
            self._cache[key] = view
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)

    def live_view(self, include_occurrences: bool = False) -> GraphView:
        """View at the current safe watermark (LiveAnalysisTask semantics:
        timestamp = min over the sources' watermarks,
        ``LiveAnalysisTask.scala:55-105``)."""
        t = min(self.safe_time(), self.latest_time)
        return self.view_at(t, exact=False,
                            include_occurrences=include_occurrences)

    def resident_acquire(self, time: int):
        """Acquire the shared resident ``DeviceSweep`` for a warm View
        dispatch at ``time``: ``(sweep, held_lock)`` — the caller MUST
        release the lock — or None when the resident route cannot serve:

        * ``time`` is behind the sweep's clock (it only ascends; the cold
          route serves out-of-order times), or
        * the log's id space overflows the packed-key engine.

        When events appended after the pin land at or before ``time`` (an
        exact incremental min over the post-pin rows), the sweep ADOPTS the
        appended suffix in place (``DeviceSweep.repin``), so the next
        advance folds exactly the new rows; only a rebuild condition
        (compaction, a new vertex or pair, a row at or before the sweep's
        clock, the time dtype's overflow) builds a new sweep from a fresh
        pin (``raphtory_tpu/core/service.py:152-167``).

        The caller owns the watermark fence (only ask for ``time`` <=
        ``safe_time()``)."""
        from ..engine.device_sweep import DeviceSweep, IdSpaceError

        if self._resident_broken:
            return None
        self._resident_lock.acquire()
        try:
            sweep = self._resident
            if sweep is not None:
                if self.log.version != self._resident_version:
                    pinned = self.log.pin()
                    if self._resident_n < pinned.n:
                        tcol = pinned.column("time")
                        self._post_pin_min = min(
                            self._post_pin_min,
                            int(tcol[self._resident_n:pinned.n].min()))
                        self._resident_n = pinned.n
                    self._resident_version = pinned.version
                # checked on EVERY acquire: an earlier small-time acquire
                # may have recorded the post-pin min already
                if int(time) >= self._post_pin_min:
                    if sweep.repin(self.log) == "extended":
                        # the sweep's new pin captured (n, version)
                        # atomically and covers every scanned row
                        self._resident_n = sweep.sw.log.n
                        self._resident_version = sweep.sw.log.version
                        self._post_pin_min = 2**62
                    else:
                        sweep = None   # re-pin from scratch below
            if sweep is None:
                pinned = self.log.pin()   # (n, version) atomic with rows
                sweep = DeviceSweep(pinned, device=self.device)
                self._resident = sweep
                self._resident_version = pinned.version
                self._resident_n = pinned.n
                self._post_pin_min = 2**62
            if sweep.t_now is not None and int(time) < sweep.t_now:
                self._resident_lock.release()
                return None
            return sweep, self._resident_lock
        except IdSpaceError:
            self._resident_broken = True
            self._resident_lock.release()
            return None
        except BaseException:
            self._resident_lock.release()
            raise

    def resident_discard(self) -> None:
        """Drop the resident sweep. Callers that hit trouble mid-dispatch
        MUST call this while still holding the acquired lock: a partially
        applied delta leaves the device buffers inconsistent with the host
        fold, and the next acquire must re-pin."""
        self._resident = None
        self._resident_version = -1
        self._resident_n = 0
        self._post_pin_min = 2**62
