"""Live epoch engine: incremental maintenance of a standing query.

The port of ``raphtory_tpu/jobs/live.py``. A Live subscription keeps ONE
columnar hop-batched engine (``engine/hopbatch``) alive, its
device-resident advanced base included, and serves each tick ("epoch") at
event time ``t`` by:

* adopting the log suffix appended since the last epoch in place
  (``_HopBatched.repin``: the same coordinate space, so the fold state,
  the device-resident advanced base and the host delta base stay valid);
* folding only the events in ``(t_prev, t]`` and shipping O(delta) bytes
  through the delta route (K1, then K2a/b/c, K5 or K6 / K6w);
* warm-starting the solve from the previous epoch's output: PageRank
  always (a contraction), CC and BFS by min-merge only on an add-only
  epoch delta without windows, SSSP never (a weight update can raise a
  distance).

Where the standing engine cannot serve, the epoch runs the full re-sweep
(``Job._run_at``, the View routes), the oracle: a program without a
columnar engine, an engine past the size guards, ``RTPU_LIVE=0``, and a
``t`` behind the engine's clock. Every ``RTPU_LIVE_RESYNC`` epochs the
engine drops its device residency and the warm seed ("resync"): the next
dispatch ships the base from the exact host fold state.

One difference from the reference, on purpose: **a failed dispatch fails
the job.** An exception from the standing engine (a kernel that does not
build or launch) propagates: the epoch does not fall back to ``resweep``,
as the port's resident route fails its job (``jobs/manager.py``,
``_try_view_resident``).

Every epoch reports as the reference's does (``_finish``): its staleness
into the freshness plane (``obs/freshness``), the bounded
``raphtory_live_epochs_total{algorithm, mode}`` counter, a journal record,
and its seconds into the scheduler's ``live:`` price book; ``next_wait``
follows the staleness budget's grade (burning: the floor; degraded: half
the repeat; ok: the repeat). Spans: ``live.epoch`` around each epoch's
solve (with the engine's ``sweep.columnar``, ``hop.fold`` and
``hop.compute`` inside), an instant for a skipped epoch, and — beyond the
reference — ``live.repin`` around the adoption of the appended suffix, so
an epoch's time splits into repin, fold and dispatch.

Epoch modes (closed set): ``incremental`` (suffix adopted, delta folded,
warm-seeded where the gate allows), ``rebase`` (a fresh engine: the first
epoch, or a repin that rebuilds), ``resync`` (the scheduled drop of
residency and seed), ``resweep`` (the full re-sweep) and ``skipped``
(wall-clock mode, neither the safe time nor the log moved).
"""

from __future__ import annotations

import collections
import logging
import os
import time as _time

import numpy as np

from ..core.events import EDGE_DELETE, VERTEX_DELETE
from ..obs import freshness as _fresh
from ..obs import journal as _journal
from ..obs.metrics import METRICS
from ..obs.trace import TRACER, block_steps as _block_steps

_log = logging.getLogger(__name__)

#: device / host admission guards of the standing engine: the bounds the
#: columnar Range route applies per request (``jobs/manager.py``
#: ``_columnar_range_prep``), held for the subscription's lifetime
MAX_DEVICE_MASK_BYTES = 1 << 32
MAX_HOST_COLUMN_BYTES = 1 << 29

#: the epochs a subscription keeps in ``LiveEpochState.epochs``
EPOCH_HISTORY = 1024


def live_enabled() -> bool:
    """``RTPU_LIVE=0`` serves every epoch with the full re-sweep. Read each
    epoch: flipping it mid-stream drops the standing engine."""
    return os.environ.get("RTPU_LIVE", "1") not in ("", "0", "false")


def epoch_floor_s() -> float:
    """The least wait between wall-clock epochs (``RTPU_LIVE_EPOCH_MS``,
    milliseconds, default 25); an unparseable value takes the default."""
    try:
        v = float(os.environ.get("RTPU_LIVE_EPOCH_MS", "") or 25.0)
    except ValueError:
        v = 25.0
    return max(0.0, v) / 1000.0


def resync_every() -> int:
    """The resync period in incremental epochs (``RTPU_LIVE_RESYNC``,
    default 64; 0 turns it off)."""
    try:
        v = int(os.environ.get("RTPU_LIVE_RESYNC", "") or 64)
    except ValueError:
        v = 64
    return max(0, v)


class LiveEpochState:
    """One subscription's epoch state: the standing engine, the previous
    epoch's output (the warm seed) and the skip gate's bookkeeping. Driven
    by ONE job thread (``Job._run_live``); the engine is job-private."""

    def __init__(self, job):
        self.job = job
        self.hb = None                  # the standing hop-batched engine
        self._builder_failed = False    # no columnar engine for the program
        self.last_t: int | None = None
        self.last_log_n = -1
        self.last_out = None            # [W, n_pad] previous output
        self.served = 0                 # epochs that emitted rows
        self.since_resync = 0
        self.mode_counts: dict[str, int] = {}
        #: the newest epochs: time, mode, seconds, delta rows, ship bytes,
        #: whether the solve was warm-seeded
        self.epochs: collections.deque = collections.deque(
            maxlen=EPOCH_HISTORY)

    # ---- the epoch ----

    def epoch(self, q, t: int) -> str:
        """Serve one epoch at event time ``t``; returns its mode. The rows
        are emitted here."""
        t = int(t)
        t0 = _time.perf_counter()
        alg = (self.job.ledger.algorithm
               or type(self.job.program).__name__)
        log_n = int(self.job.graph.log.n)

        if (not q.event_time and self.served > 0
                and self.last_t == t and self.last_log_n == log_n):
            # neither the safe time nor the log moved since the last
            # served epoch (the row count too: a direct append is legal
            # and unfenced): the previous result is the result at t;
            # staleness is still recorded (the data aged)
            TRACER.instant("live.epoch", mode="skipped", time=t,
                           algorithm=alg)
            self._finish("skipped", t, alg, 0, 0,
                         _time.perf_counter() - t0, priced=False)
            return "skipped"

        if not live_enabled():
            self.hb = None          # the knob drops the engine
            self.last_out = None
            return self._resweep(q, t, alg, t0)

        mode = "incremental"
        if self.hb is not None:
            with TRACER.span("live.repin", time=t, algorithm=alg) as rsp:
                status = self.hb.repin()
                rsp.set(status=status)
            if status == "rebuild":
                # the pin may be rebound past the decision point: discard
                # the engine (n_pad may change, so the seed too)
                self.hb = None
                self.last_out = None
        windows = list(q.windows) if q.windows is not None else [q.window]
        if self.hb is None:
            if self._builder_failed:
                return self._resweep(q, t, alg, t0)
            try:
                hb = self.job._columnar_builder()
            except (TypeError, ValueError, MemoryError) as e:
                _log.info("live epoch engine declined: %s: %s",
                          type(e).__name__, e)
                self._builder_failed = True
                return self._resweep(q, t, alg, t0)
            if (hb.device_mask_bytes(len(windows)) > MAX_DEVICE_MASK_BYTES
                    or hb.host_column_bytes(1) > MAX_HOST_COLUMN_BYTES):
                self._builder_failed = True   # a property of the graph
                return self._resweep(q, t, alg, t0)
            self.hb = hb
            mode = "rebase"
        hb = self.hb

        if hb.sw.t_prev is not None and t < int(hb.sw.t_prev):
            # time went backward (a watermark regression): the engine only
            # ascends, so re-sweep and rebuild on the next epoch
            self.hb = None
            self.last_out = None
            return self._resweep(q, t, alg, t0)

        if (mode == "incremental" and resync_every() > 0
                and self.since_resync >= resync_every()):
            # the drift bound: the next dispatch ships the base from the
            # exact host fold state and solves cold
            mode = "resync"
            hb._drop_residency()
            self.last_out = None
            self.since_resync = 0

        delta_rows, add_only = self._delta_stats(hb, t)
        warm = None
        if self.last_out is not None and mode == "incremental":
            if hb.supports_warm_start:
                warm = self.last_out        # a contraction: always valid
            elif (hb.supports_epoch_warm and add_only
                    and windows == [None]):
                # the min-merge seed holds only where the graph grew
                # monotonically and no window can drop an edge
                warm = self.last_out

        from .manager import _shell_from_fold

        shells = {}

        def grab_shell(T, sw):
            shells[int(T)] = _shell_from_fold(hb.tables, sw, int(T))

        # no fallback: a failed dispatch fails the job (module docstring)
        with TRACER.span("live.epoch", mode=mode, time=t, algorithm=alg,
                         delta_rows=int(delta_rows), warm=warm is not None):
            out, steps = hb.run([t], windows, chunks=1,
                                hop_callback=grab_shell, warm_state=warm)
            b0 = _time.perf_counter()
            ranks, steps = _block_steps(lambda: (out.cpu().numpy(), steps))
            self.job.ledger.add_phase("device_wait",
                                      _time.perf_counter() - b0)
        METRICS.snapshot_build_seconds.observe(hb.fold_seconds)
        METRICS.supersteps.inc(max(int(steps), 0))
        self.job.ledger.count_supersteps(int(steps))
        per_row = (_time.perf_counter() - t0) / max(len(windows), 1)
        for i, w in enumerate(windows):
            if self.job._kill.is_set():
                break
            self.job._emit(t, w, ranks[i], shells[t], int(steps),
                           _time.perf_counter() - per_row)
        self.last_out = out
        self.last_t = t
        self.last_log_n = log_n
        self.served += 1
        self.since_resync += 1
        self._finish(mode, t, alg, delta_rows, int(hb.ship_bytes),
                     _time.perf_counter() - t0, warm=warm is not None)
        return mode

    # ---- cadence ----

    def next_wait(self, q) -> float:
        """The wall-clock wait before the next epoch, adapted to the
        staleness budget (``raphtory_tpu/jobs/live.py:263-280``): a burning
        budget serves back to back at the ``RTPU_LIVE_EPOCH_MS`` floor, a
        degraded one halves the requested repeat, an ok one waits the
        repeat (never below the floor)."""
        floor = epoch_floor_s()
        alg = (self.job.ledger.algorithm
               or type(self.job.program).__name__)
        grade = _fresh.FRESH.live_grade(alg)
        if grade == "burning":
            return floor
        if grade == "degraded":
            return max(floor, float(q.repeat) / 2.0)
        return max(floor, float(q.repeat))

    # ---- internals ----

    def _delta_stats(self, hb, t: int):
        """(rows this epoch folds, add-only?), BY TIME over the whole
        pinned log: event-time mode may fold old pinned rows once t passes
        them, and the add-only gate must see every row in ``(t_prev, t]``."""
        sw = hb.sw
        tcol, kcol = sw._t, sw._k
        t_prev = sw.t_prev
        if not len(tcol):
            return 0, True
        if sw._t_sorted:
            lo = 0 if t_prev is None else int(
                np.searchsorted(tcol, t_prev, side="right"))
            hi = int(np.searchsorted(tcol, t, side="right"))
            kinds = kcol[lo:hi]
            n = hi - lo
        else:
            m = tcol <= t
            if t_prev is not None:
                m &= tcol > t_prev
            kinds = kcol[m]
            n = int(m.sum())
        add_only = not bool(((kinds == VERTEX_DELETE)
                             | (kinds == EDGE_DELETE)).any())
        return n, add_only

    def _resweep(self, q, t: int, alg: str, t0: float) -> str:
        """The full re-sweep: the View routes at ``t`` (``exact=False``, as
        the live loop before the epoch engine)."""
        with TRACER.span("live.epoch", mode="resweep", time=t,
                         algorithm=alg):
            self.job._run_at(t, q, exact=False)
        self.last_t = t
        self.last_log_n = int(self.job.graph.log.n)
        self.served += 1
        self._finish("resweep", t, alg, -1, -1, _time.perf_counter() - t0)
        return "resweep"

    def _finish(self, mode: str, t: int, alg: str, delta_rows: int,
                ship_bytes: int, seconds: float, warm: bool = False,
                priced: bool = True) -> None:
        """Per-epoch telemetry, the same in every mode
        (``raphtory_tpu/jobs/live.py:330-358``): the mode count (at most
        five keys), the epoch's record (``warm``: the solve started from
        the previous epoch's output), the result's staleness into the
        freshness plane, the epochs counter, a journal record and the
        ``live:`` admission price (a skipped epoch is free and never
        priced)."""
        self.mode_counts[mode] = self.mode_counts.get(mode, 0) + 1
        self.epochs.append({"time": t, "mode": mode, "seconds": seconds,
                            "delta_rows": int(delta_rows),
                            "ship_bytes": int(ship_bytes), "warm": warm})
        try:
            head = int(self.job.graph.latest_time)
        except Exception:       # an empty log has no latest time
            head = None
        staleness = _fresh.FRESH.note_live_result(
            alg, t, head_time=head, trace_id=self.job.trace_id)
        _fresh.FRESH.note_live_epoch(
            self.job.id, algorithm=alg, mode=mode,
            delta_rows=delta_rows, ship_bytes=ship_bytes,
            staleness_s=staleness, result_time=t)
        METRICS.live_epochs.labels(alg, mode).inc()
        if _journal.enabled():
            _journal.emit("epoch", {
                "job_id": self.job.id, "algorithm": alg, "mode": mode,
                "result_time": t, "delta_rows": delta_rows,
                "ship_bytes": ship_bytes,
                "staleness_s": (round(staleness, 6)
                                if staleness is not None else None),
                "seconds": round(seconds, 6), "served": self.served},
                trace_id=self.job.trace_id)
        if priced and self.job._sched is not None:
            try:
                self.job._sched.note_live_epoch(alg, seconds)
            except Exception:   # pricing never fails a live job
                pass
