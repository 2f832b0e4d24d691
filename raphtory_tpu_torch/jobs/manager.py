"""Job orchestration: View and Range analysis on the port's engines.

The reference spawns one ``AnalysisTask`` actor per request
(``AnalysisManager.scala:72-167``, ``Tasks/``), each driving the actor BSP
handshake per timestamp. Here a job is a host thread:

* a **View** query takes the warm route — the graph's shared resident
  ``DeviceSweep`` (``engine/device_sweep``): a delta-advance and one
  dispatch — unless the reference declines it (the time is behind the
  sweep's clock, the program needs properties or its reducer needs the
  full view, the fence has not passed, or the log has 2^31 ids or more);
  then the cold route folds a host view and runs ``engine/bsp.run``;
* a **Range** query tries the reference's routes in its order
  (``jobs/manager.py:316-340``): on a mesh the column-sharded sweep
  (``parallel/columns``) and the static-partition ``ShardedSweep``
  (``parallel/sweep``); then the columnar hop-batched sweep
  (``engine/hopbatch``) for PageRank, ConnectedComponents and SSSP/BFS;
  then a ``DeviceSweep`` hop by hop; then the View routes hop by hop,
  behind the watermark fence. Each route declines (the range is not
  behind the fence, past the columnar route's view cap or memory guards,
  a program it does not carry; the single-device routes under a mesh)
  and the next one runs.

With ``mesh=`` (``parallel/sharded.make_mesh``) every rank of the mesh
submits the same job: View queries run ``sharded.run`` (the resident
route declines, as the reference's does), Range queries try the two
mesh routes first. Every rank emits the same rows; rank 0's are the
job's answer.

An occurrence program (``needs_occurrences``: TaintTracking) takes the
cold route: a View folds ``build_view(..., include_occurrences=True)``, a
Range a ``SweepBuilder(include_occurrences=True)`` hop by hop; the
columnar, resident and static-partition routes decline it, as the
reference's do. A **Live** query repeats at the moving watermark
(``_run_live``): each epoch is served by the live epoch engine
(``jobs/live.LiveEpochState``) on a standing columnar engine that adopts
the appended suffix, or by the full re-sweep where that engine cannot
serve. A failed dispatch fails
the job (``status`` / ``error``): the resident route drops its sweep and
does NOT fall back to the cold route, a failed live epoch does not fall
back to the re-sweep, and a failed mesh dispatch fails the
job instead of falling to the next route (the reference falls back).

The serving layer (``raphtory_tpu/jobs/manager.py``): each job carries a
per-query ledger (``obs/ledger``; ``explain=1`` returns it), a trace
context adopted from the submitting thread (one trace id from the REST
handler to the engines' spans), its tenant, an optional deadline and a
result sink (``jobs/sink``). ``AnalysisManager.submit`` prices the request
through the serving scheduler (``jobs/scheduler``: admission control) and
offers it to a coalescing collect window: concurrent PageRank / CC /
BFS / SSSP View and Range requests over the same graph run as ONE columnar
dispatch, each member emitting its own columns on its own thread. A
declined or failed batch sends each member to its own route. A Range
sweep whose deadline passes (or whose transient failures exhaust their
retries) mid-sweep ships the hops it covered, marked ``degraded``.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time as _time
import traceback
from dataclasses import dataclass

import numpy as np

from ..algorithms import SSSP, ConnectedComponents, PageRank
from ..analysis.sanitizer import (note_shared as _san_note,
                                  track_shared as _san_track)
from ..core.service import TemporalGraph
from ..core.snapshot import INT64_MIN
from ..core.sweep import SweepBuilder
from ..engine import bsp
from ..engine.device_sweep import DeviceSweep, IdSpaceError, supported
from ..engine.hopbatch import (HopBatchedBFS, HopBatchedCC,
                               HopBatchedPageRank, HopBatchedSSSP)
from ..engine.program import VertexProgram
from ..obs import journal as _journal
from ..obs import ledger as _ledger
from ..obs import slo as _slo
from ..obs import workload as _workload
from ..obs.metrics import METRICS
from ..obs.trace import TRACER, block_steps as _block_steps
from ..ops.resident import ship
from ..parallel.sweep import _Shell
from ..resilience import degrade as _degrade
from ..resilience.policy import default_classify as _transient
from ..utils.device import resolve_device

_jobs_log = logging.getLogger(__name__)


@dataclass(frozen=True)
class ViewQuery:
    """One timestamp (ViewAnalysisTask)."""
    timestamp: int
    window: int | None = None
    windows: tuple | None = None


@dataclass(frozen=True)
class RangeQuery:
    """Timestamp sweep start..end step jump (RangeAnalysisTask.scala:18-35)."""
    start: int
    end: int
    jump: int
    window: int | None = None
    windows: tuple | None = None

    def __post_init__(self):
        if int(self.jump) <= 0:
            # jump=0 would spin the sweep forever — refuse at construction
            raise ValueError(f"jump must be positive, got {self.jump}")


@dataclass(frozen=True)
class LiveQuery:
    """Repeating analysis at the moving watermark (LiveAnalysisTask).
    ``event_time=False``: an epoch every ``repeat`` seconds of wall time at
    the safe time; ``event_time=True``: the target time advances by
    ``repeat`` event-time units, each epoch waiting for the watermark
    (``LiveAnalysisTask.scala:34-52``)."""
    repeat: float = 1.0
    event_time: bool = False
    max_runs: int | None = None
    window: int | None = None
    windows: tuple | None = None


Query = ViewQuery | RangeQuery | LiveQuery


def _shell_from_fold(tables, sw, T):
    """Reducer-facing vertex shell from a SweepBuilder's fold state at T
    (vertex-side fields only — gated by ``reduce_shell_safe``)."""
    n, n_pad = tables.n, tables.n_pad
    vm = np.zeros(n_pad, bool)
    vm[:n] = sw.v_alive
    vl = np.full(n_pad, INT64_MIN, np.int64)
    vl[:n] = sw.v_lat
    vf = np.full(n_pad, INT64_MIN, np.int64)
    vf[:n] = sw.v_first
    return _Shell(time=int(T), n_pad=n_pad, vids=tables.vids, v_mask=vm,
                  v_latest_time=vl, v_first_time=vf)


def _to_host(tree):
    """Result tensors → numpy (the reducers are host code)."""
    return bsp.tree_map(lambda a: a.cpu().numpy(), tree)


class _DeviceShell:
    """Reducer-facing view shells over a DeviceSweep's HOST fold state
    (the device buffers' twin lives in its SweepBuilder)."""

    def __init__(self, sweep):
        self.sweep = sweep

    def freeze(self):
        ds = self.sweep
        return _shell_from_fold(ds.tables, ds.sw, ds.t_now)


class Job:
    def __init__(self, job_id: str, program: VertexProgram, query: Query,
                 graph: TemporalGraph, device, wait_timeout: float = 30.0,
                 mesh=None, explain: bool = False, tenant: str | None = None,
                 deadline_ms=None, priority: int = 0,
                 no_batch: bool = False):
        self.id = job_id
        self.program = program
        self.query = query
        self.graph = graph
        self.device = device
        self.mesh = mesh
        self.wait_timeout = wait_timeout
        #: client deadline (jobs/scheduler.py): absolute monotonic seconds,
        #: or None; a job whose deadline passed before it dispatched fails
        #: fast with status "expired"
        self.deadline_ms = None if deadline_ms is None else float(deadline_ms)
        self.deadline = (None if deadline_ms is None
                         else _time.monotonic() + float(deadline_ms) / 1e3)
        if self.deadline_ms is not None and not self.deadline_ms > 0:
            raise ValueError(
                f"deadline_ms must be positive, got {deadline_ms!r}")
        #: >= scheduler.PRIORITY_BYPASS skips the coalescing collect window
        self.priority = int(priority or 0)
        #: per-request coalescing opt-out (REST ``batch: false``)
        self.no_batch = bool(no_batch)
        #: the scheduler's ``_Pending`` while waiting in a collect window
        self._coalesce = None
        #: the manager's ServingScheduler (admission and price hooks);
        #: None for a job constructed directly
        self._sched = None
        self._admitted_cost_s = None
        #: per-query resource ledger — always collected; ``explain``
        #: returns it with the results over REST (obs/ledger.py)
        self.explain = bool(explain)
        self.ledger = _ledger.Ledger(
            job_id, getattr(program, "cost_label", type(program).__name__))
        #: normalized tenant identity (obs/workload.py); never raises
        self.tenant = _workload.normalize_tenant(tenant)
        self.ledger.tenant = self.tenant
        # the submitting thread's trace context (the REST handler's span):
        # the job thread adopts it, so a request and its job share one
        # trace id end to end (None when tracing is off)
        self._trace_ctx = TRACER.capture()
        #: trace id of this job's ``job`` span once it runs (None untraced)
        self.trace_id: str | None = None
        self._submitted = _time.perf_counter()
        #: ResultSink | None — attached by AnalysisManager.submit
        self.sink = None
        self.results: list[dict] = []
        # oldest rows roll off past the cap (a Live job emits forever; the
        # sink keeps the full history); readers take results_snapshot()
        # under the same lock. 0 disables.
        self._results_cap = max(
            0, int(os.environ.get("RTPU_RESULT_ROWS", 10_000)))
        self._results_mu = threading.Lock()
        self.results_dropped = 0
        self.status = "pending"
        self.error: str | None = None
        #: degraded serving (resilience/degrade.py): a Range sweep whose
        #: deadline or retry budget expired MID-sweep ships the hops it
        #: covered, status "done", with these fields saying how much
        self.degraded = False
        self.covered_time: int | None = None
        self.degraded_reason: str | None = None
        self._kill = threading.Event()
        self._done = threading.Event()
        self._thread: threading.Thread | None = None
        #: a Live job's ``jobs/live.LiveEpochState`` (its ``mode_counts``
        #: and ``epochs``), set when the live loop starts
        self.live = None

    # ---- lifecycle ----

    def start(self) -> "Job":
        self._thread = threading.Thread(
            target=self._run, name=f"job-{self.id}", daemon=True)
        self.status = "running"
        self._thread.start()
        return self

    def kill(self) -> None:
        self._kill.set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def results_snapshot(self) -> list[dict]:
        """Stable copy of the result rows for readers on other threads."""
        with self._results_mu:
            return list(self.results)

    # ---- execution ----

    def _run(self) -> None:
        METRICS.jobs_started.labels(type(self.query).__name__).inc()
        # queue wait: submit until the job thread runs
        self.ledger.queue_wait_seconds = max(
            0.0, _time.perf_counter() - self._submitted)
        try:
            with TRACER.adopt(self._trace_ctx), \
                    TRACER.span("job", job_id=self.id,
                                kind=type(self.query).__name__,
                                program=type(self.program).__name__) as jsp, \
                    _ledger.activate(self.ledger):
                self.trace_id = jsp.trace or None
                self.ledger.trace_id = self.trace_id or ""
                self._run_query()
                jsp.set(status=self.status)
            # wall is submit -> done, so queue wait + phases == wall
            self._publish_ledger(_time.perf_counter() - self._submitted)
        finally:
            # _done fires LAST: a waiter must observe the published state
            self._done.set()

    def _publish_ledger(self, wall_seconds: float) -> None:
        """Close the job's ledger and fan it out
        (``raphtory_tpu/jobs/manager.py:216``): the SLO histograms, the
        queue-wait histogram, the tenant's workload account, the journal,
        the scheduler's completion hook, and — unless ``RTPU_LEDGER=0`` —
        the per-algorithm ``raphtory_query_cost_*`` metrics and the
        ``/costz`` ring. (The reference also feeds its advisor here; the
        port has no advisor yet.)"""
        led = self.ledger
        led.finish(wall_seconds, status=self.status)
        alg = led.algorithm or "unknown"
        if self.status == "done":
            # only successful jobs land in the latency SLI
            _slo.SLO.observe(alg, "e2e", led.wall_seconds,
                             trace_id=self.trace_id)
            for ph, sec in dict(led.phase_seconds).items():
                _slo.SLO.observe(alg, ph, sec, trace_id=self.trace_id)
        METRICS.job_queue_wait_seconds.observe(led.queue_wait_seconds)
        _workload.WORKLOAD.record(led, status=self.status)
        if _journal.enabled():
            snap_j = led.as_dict()
            snap_j["job_id"] = self.id
            snap_j["status"] = self.status
            _journal.emit("ledger", snap_j, trace_id=self.trace_id,
                          tenant=led.tenant or None)
        if self._sched is not None:
            self._sched.complete(self)
        if not _ledger.collection_enabled():
            return
        METRICS.query_cost_queries.labels(alg, led.bound()).inc()
        METRICS.query_cost_seconds.labels(alg, "queue_wait").observe(
            led.queue_wait_seconds)
        snap = led.as_dict()
        for ph, sec in snap["phase_seconds"].items():
            METRICS.query_cost_seconds.labels(alg, ph).observe(sec)
        METRICS.query_cost_est_flops.labels(alg).inc(
            snap["device"]["est_flops"])
        METRICS.query_cost_est_hbm_bytes.labels(alg).inc(
            snap["device"]["est_bytes_accessed"])
        METRICS.query_cost_h2d_bytes.labels(alg).inc(snap["h2d"]["bytes"])
        if snap["dcn"]["bytes"]:
            METRICS.query_cost_dcn_bytes.labels(alg).inc(
                snap["dcn"]["bytes"])
        _ledger.note_completed(led)

    def _run_query(self) -> None:
        try:
            q = self.query
            if self.deadline is not None \
                    and _time.monotonic() > self.deadline:
                # fail fast BEFORE any dispatch
                self.status = "expired"
                self.error = (f"DeadlineExpired: deadline_ms="
                              f"{self.deadline_ms:g} passed before the "
                              "job dispatched")
                if self._coalesce is None:
                    # a queued job's expiry is counted by the scheduler
                    from . import scheduler as _sched

                    _sched.note_deadline_expired(self)
                return
            if self._coalesce is not None and self._run_coalesced(q):
                return   # status set by the coalesced path
            self._coalesce = None   # declined / timed out: own route
            if isinstance(q, ViewQuery):
                self._run_at(q.timestamp, q)
            elif isinstance(q, LiveQuery):
                self._run_live(q)
            elif not (self._try_range_mesh_columns(q)
                      or self._try_range_mesh(q)
                      or self._try_range_hopbatch(q)
                      or self._try_range_device(q)):
                # hop by hop behind the watermark fence (the reference's
                # RangeAnalysisTask loop, jobs/manager.py:316-340): fold
                # incrementally when the whole range is already safe
                sweep = (SweepBuilder(
                    self.graph.log,
                    include_occurrences=self.program.needs_occurrences)
                    if self.graph.safe_time() >= q.end else None)
                t = q.start
                while t <= q.end and not self._kill.is_set():
                    self._run_at(t, q, sweep=sweep)
                    t += q.jump
            self.status = "done" if not self._kill.is_set() else "killed"
        except Exception as e:  # job errors surface via status, like the
            self.status = "failed"  # reference's per-phase catches
            self.error = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
        finally:
            if self.sink is not None:
                self.sink.close()   # flush partial output on kill/failure
            METRICS.jobs_completed.labels(self.status).inc()

    # ---- coalesced batches (jobs/scheduler.py) ----

    def _run_coalesced(self, q) -> bool:
        """Wait on this job's collect-window handle and, when the batch
        dispatched, emit THIS job's columns on THIS thread
        (``raphtory_tpu/jobs/manager.py:408``). False when the scheduler
        declined (a solo window, a failed or over-guard batch): the job
        then takes its own route."""
        pend = self._coalesce
        limit = max(float(self.wait_timeout), 600.0)
        w0 = _time.monotonic()
        while not pend.done.wait(0.05):
            if self._kill.is_set():
                self.status = "killed"
                return True
            if _time.monotonic() - w0 > limit:
                _jobs_log.warning(
                    "coalesced wait timed out for %s after %.0fs — "
                    "taking its own route", self.id, limit)
                return False
        if pend.outcome == "declined":
            return False
        if pend.outcome == "killed":
            self.status = "killed"
            return True
        if pend.outcome == "expired":
            self.status = "expired"
            self.error = (f"DeadlineExpired: deadline_ms="
                          f"{self.deadline_ms:g} expired in the "
                          "scheduler queue (never dispatched)")
            return True
        pay = pend.payload
        # the collect-window wait the scheduler added, from this thread's
        # wait start; the dispatch is attributed by column share
        self.ledger.add_phase("sched_wait", max(
            0.0, pay["dispatch_started"] - w0))
        self.ledger.absorb_share(pay["snap"], pay["share"],
                                 coalesced=pay["batch"])
        self._emit_coalesced(pend.grid, pay)
        self.status = "done" if not self._kill.is_set() else "killed"
        return True

    def _emit_coalesced(self, grid, pay) -> None:
        """This job's rows from a shared batch dispatch: ``grid`` is the
        (hops, windows) the scheduler packed its columns from, in serial
        emission order; ``viewTime`` is the amortised per-column share of
        the batch dispatch (``raphtory_tpu/jobs/manager.py:455``)."""
        hops, windows = grid
        ranks, steps = pay["ranks"], int(pay["steps"])
        shells, cols = pay["shells"], pay["cols"]
        per_row = pay["elapsed"] / max(pay["total_cols"], 1)
        for _ in hops:
            METRICS.snapshot_build_seconds.observe(
                pay["fold_seconds"] * pay["share"] / max(len(hops), 1))
        self.ledger.count_supersteps(steps)
        i = 0
        for T in sorted({int(t) for t in hops}):
            for w in windows:
                if self._kill.is_set():
                    return
                self._emit(T, w, ranks[cols[i]], shells[int(T)], steps,
                           _time.perf_counter() - per_row)
                i += 1

    # ---- Live queries ----

    def _run_live(self, q: LiveQuery) -> None:
        """The live loop (``raphtory_tpu/jobs/manager.py:355-407``): each
        iteration computes the target time, and the epoch engine decides
        how to serve it. Event-time mode waits for the watermark in chunks
        of at most 0.5 s, so a kill interrupts the wait, and gives up
        waiting after ``wait_timeout``; once every source has finished and
        the target has passed the end of history it ends (unless
        ``max_runs`` asks for an exact count). Wall-clock mode waits
        ``next_wait`` between epochs."""
        from .live import LiveEpochState

        live = self.live = LiveEpochState(self)
        runs = 0
        t_target = None
        while not self._kill.is_set():
            if q.event_time:
                if t_target is None:
                    t_target = min(self.graph.safe_time(),
                                   self.graph.latest_time)
                else:
                    # advance in event time, never clamped back; a repeat
                    # under 1 still advances
                    t_target += max(1, int(q.repeat))
                deadline = _time.monotonic() + self.wait_timeout
                while (not self._kill.is_set()
                       and _time.monotonic() < deadline
                       and not self.graph.watermarks.wait_for(
                           t_target,
                           timeout=min(0.5, max(
                               0.0, deadline - _time.monotonic())))):
                    pass
                t = t_target
            else:
                t = min(self.graph.safe_time(), self.graph.latest_time)
            live.epoch(q, int(t))
            runs += 1
            if q.max_runs is not None and runs >= q.max_runs:
                break
            if q.event_time:
                if (q.max_runs is None
                        and self.graph.watermarks.safe_time() >= 2**62
                        and t_target >= self.graph.latest_time):
                    break
            else:
                self._kill.wait(live.next_wait(q))

    # ---- the generic engine: View queries and non-columnar Ranges ----

    def _device_engine_ok(self) -> bool:
        """Eligibility of the device-resident engines (warm View, resident
        Range, the mesh's static partition): no occurrences or property
        joins (``supported``), and a reducer that accepts the vertex-side
        shell view. Read before any of them builds anything."""
        if not supported(self.program):
            return False
        return (type(self.program).reduce is VertexProgram.reduce
                or self.program.reduce_shell_safe)

    def _try_view_resident(self, t: int, q) -> bool:
        """Warm View dispatch through the graph's shared resident
        DeviceSweep: delta-advance + one dispatch. Returns False only on
        the reference's declines (a mesh, fence, program, clock, id
        space); a failure DURING the dispatch drops the sweep and fails the
        job — it never falls back to the cold route."""
        if self.mesh is not None or self.graph.safe_time() < int(t):
            return False   # the cold route owns the fence wait
        if not self._device_engine_ok():
            return False
        acq = self.graph.resident_acquire(int(t))
        if acq is None:
            return False
        sweep, lock = acq
        t0 = _time.perf_counter()
        try:
            s0 = _time.perf_counter()
            sweep.advance(int(t))
            METRICS.snapshot_build_seconds.observe(_time.perf_counter() - s0)
            self.ledger.add_phase("fold", _time.perf_counter() - s0)
            windows = list(q.windows) if q.windows is not None else None
            result, steps = sweep.run(self.program, window=q.window,
                                      windows=windows)
            rv = _DeviceShell(sweep).freeze()
            b0 = _time.perf_counter()
            result, steps = _block_steps(lambda: (_to_host(result), steps))
            self.ledger.add_phase("device_wait",
                                  _time.perf_counter() - b0)
        except BaseException:
            # a partially applied delta leaves the device state
            # inconsistent with the host fold: drop the sweep while the
            # lock is still held, then fail the job
            self.graph.resident_discard()
            raise
        finally:
            lock.release()
        METRICS.supersteps.inc(max(steps, 0))
        self.ledger.count_supersteps(steps)
        if windows is not None:
            for i, w in enumerate(windows):
                self._emit(t, w, bsp.tree_map(lambda a: a[i], result), rv,
                           steps, t0)
        else:
            self._emit(t, q.window, result, rv, steps, t0)
        return True

    def _run_at(self, t: int, q, exact: bool = True, sweep=None) -> None:
        """One view at ``t``: the warm route, else the cold one (a host
        view — from ``sweep`` when the Range loop folds incrementally — and
        ``bsp.run``)."""
        if sweep is None and self._try_view_resident(t, q):
            return
        t0 = _time.perf_counter()
        occ = self.program.needs_occurrences
        s0 = _time.perf_counter()
        if sweep is not None:
            view = sweep.view_at(int(t))
            METRICS.snapshot_build_seconds.observe(_time.perf_counter() - s0)
            self.graph.cache_put(int(t), view, occ,
                                 version=sweep.log.version)
        else:
            view = self.graph.view_at(int(t), exact=exact,
                                      wait_timeout=self.wait_timeout,
                                      include_occurrences=occ)
        self.ledger.add_phase("fold", _time.perf_counter() - s0)
        c0 = _time.perf_counter()
        if q.windows is not None:
            result, steps = self._execute(view, windows=list(q.windows))
            result, steps = _to_host(result), int(steps)
        else:
            result, steps = self._execute(view, window=q.window)
            result, steps = _to_host(result), int(steps)
        self.ledger.add_phase("compute", _time.perf_counter() - c0)
        METRICS.supersteps.inc(max(steps, 0))
        self.ledger.count_supersteps(steps)
        if q.windows is not None:
            for i, w in enumerate(q.windows):
                self._emit(t, w, bsp.tree_map(lambda a: a[i], result), view,
                           steps, t0)
        else:
            self._emit(t, q.window, result, view, steps, t0)

    def _execute(self, view, window=None, windows=None):
        if self.mesh is not None:
            from ..parallel import sharded

            return sharded.run(self.program, view, self.mesh,
                               window=window, windows=windows)
        return bsp.run(self.program, view, window=window, windows=windows,
                       device=self.device)

    def _try_range_device(self, q: RangeQuery) -> bool:
        """Range sweep on a DeviceSweep: device-resident fold state, O(delta)
        per-hop uploads, one dispatch per hop. Declines (False) when the
        range is not yet behind the fence, the program is not eligible, or
        the log's id space overflows, or under a mesh."""
        if (self.mesh is not None or self.graph.safe_time() < q.end
                or not self._device_engine_ok()):
            return False
        try:
            sweep = DeviceSweep(self.graph.log, device=self.device)
        except IdSpaceError:
            return False
        shell = _DeviceShell(sweep)

        def run(windows):
            return sweep.run(self.program, window=q.window, windows=windows)

        self._range_amortised(q, sweep.advance, run, shell.freeze)
        return True

    def _try_range_mesh(self, q: RangeQuery) -> bool:
        """Amortised mesh Range sweep (``jobs/manager.py:491``): one static
        partition for the whole range (``parallel/sweep.ShardedSweep``),
        per-hop O(delta) updates, K11 a hop. Declines without a mesh,
        before the fence, for a program the device engines do not carry,
        or when the vertex shards do not divide the global pad."""
        if self.mesh is None or self.graph.safe_time() < q.end:
            return False
        if not self._device_engine_ok():
            return False
        from ..parallel.sharded import V_AXIS
        from ..parallel.sweep import ShardedSweep

        try:
            sweep = ShardedSweep(self.graph.log, self.mesh.shape[V_AXIS])
        except ValueError:
            return False   # shard count does not divide the global pad

        def run(windows):
            return sweep.run(self.program, mesh=self.mesh, window=q.window,
                             windows=windows)

        self._range_amortised(q, sweep.advance, run, sweep.reduce_view)
        return True

    def _range_amortised(self, q: RangeQuery, advance, run,
                         freeze_rv) -> None:
        """The amortised-sweep hop loop: advance the fold, dispatch, emit
        the PREVIOUS hop's rows after this hop's dispatch.

        Degraded serving (``raphtory_tpu/jobs/manager.py:740-791``): a
        deadline that passes, or a transient failure
        (``resilience.policy.default_classify``), MID-sweep stops the loop
        but ships every hop already covered — the job ends "done" with
        ``degraded`` and ``covered_time``. Expiry before any hop still
        fails fast in ``_run_query``, and any other error fails the job."""
        pending = None
        covered = None
        reason = None
        t = q.start
        windows = list(q.windows) if q.windows is not None else None
        while t <= q.end and not self._kill.is_set():
            if (self.deadline is not None
                    and _time.monotonic() > self.deadline
                    and (pending is not None or covered is not None)):
                reason = "deadline"
                break
            t0 = _time.perf_counter()
            try:
                advance(int(t))
                METRICS.snapshot_build_seconds.observe(
                    _time.perf_counter() - t0)
                self.ledger.add_phase("fold", _time.perf_counter() - t0)
                result, steps = run(windows)
                rv = freeze_rv()
            except Exception as e:
                if (_transient(e)
                        and (pending is not None or covered is not None)):
                    reason = "retry_budget"
                    break
                raise
            t_disp = _time.perf_counter()
            if pending is not None:
                self._emit_mesh(*pending)
                covered = pending[0]
            pending = (t, q, rv, result, steps, t0, t_disp)
            t += q.jump
        if pending is not None:
            try:
                self._emit_mesh(*pending)
                covered = pending[0]
            except Exception as e:
                # the tail hop may be poisoned by the failure that stopped
                # the loop: a degraded answer keeps the covered hops
                if reason is None or not _transient(e):
                    raise
        if reason is not None:
            self._mark_degraded(reason, covered)

    def _mark_degraded(self, reason: str, covered) -> None:
        """Record a partial answer: the job's fields the REST payload
        shows, and the process-wide degraded ledger ``/healthz`` and
        ``/faultz`` read. Never fails the job it marks."""
        self.degraded = True
        self.covered_time = None if covered is None else int(covered)
        self.degraded_reason = reason
        try:
            _degrade.DEGRADED.note(self.id, reason,
                                   covered_time=self.covered_time)
        except Exception:   # telemetry must not fail a served answer
            pass

    def _emit_mesh(self, t, q, rv, result, steps, t0, t_disp) -> None:
        # viewTime means this hop's fold + dispatch + reduce — not the next
        # hop's host work that ran between its dispatch and now
        t0 = t0 + (_time.perf_counter() - t_disp)
        b0 = _time.perf_counter()
        result, steps = _block_steps(lambda: (_to_host(result), steps))
        self.ledger.add_phase("device_wait", _time.perf_counter() - b0)
        METRICS.supersteps.inc(max(steps, 0))
        self.ledger.count_supersteps(steps)
        if q.windows is not None:
            for i, w in enumerate(q.windows):
                self._emit(t, w, bsp.tree_map(lambda a: a[i], result), rv,
                           steps, t0)
        else:
            self._emit(t, q.window, result, rv, steps, t0)

    # ---- the columnar engines: Range queries of PageRank, CC, SSSP ----

    def _columnar_builder(self):
        """The hop-batched columnar engine for this job's program
        (reference ``jobs/manager.py:516-541``). PageRank: finalize is the
        raw rank vector and the power iteration warm-starts safely. CC:
        labels are global padded indices. SSSP/BFS: the columnar distances
        are finalize's output; weighted traversal folds per-hop weight
        deltas (immutable weight keys raise)."""
        p, log, dev = self.program, self.graph.log, self.device
        if type(p) is PageRank:
            return HopBatchedPageRank(log, damping=p.damping, tol=p.tol,
                                      max_steps=p.max_steps, device=dev)
        if type(p) is ConnectedComponents:
            return HopBatchedCC(log, max_steps=p.max_steps, device=dev)
        if type(p) is SSSP:
            if p.weight_prop:
                return HopBatchedSSSP(log, p.seeds, p.weight_prop,
                                      directed=p.directed,
                                      max_steps=p.max_steps, device=dev)
            return HopBatchedBFS(log, p.seeds, directed=p.directed,
                                 max_steps=p.max_steps, device=dev)
        raise TypeError(f"no columnar engine for {type(p).__name__}")

    def _columnar_range_prep(self, q: RangeQuery):
        """``(hops, windows, engine)`` for the whole-range columnar sweep,
        or None where the reference declines the route
        (``jobs/manager.py:546-572``): no hops or more than 1024 views, a
        program without a columnar engine or an engine that cannot be
        built (TypeError, ValueError, MemoryError: an immutable SSSP
        weight key, the id space), or a range past either memory guard.
        The job then takes the next route."""
        hops = list(range(int(q.start), int(q.end) + 1, int(q.jump)))
        windows = list(q.windows) if q.windows is not None else [q.window]
        if not hops or len(hops) * len(windows) > 1024:
            return None   # the cheap guard, before paying for tables
        try:
            hb = self._columnar_builder()
        except (TypeError, ValueError, MemoryError):
            return None
        if hb.device_mask_bytes(len(hops) * len(windows)) > 1 << 32 \
                or hb.host_column_bytes(len(hops)) > 1 << 29:
            return None
        return hops, windows, hb

    def _try_range_hopbatch(self, q: RangeQuery) -> bool:
        """Whole-range columnar sweep: every (hop, window) view is a column
        of one pass (``engine/hopbatch``), pipelined in equal hop chunks
        (warm-started where the engine's iteration is a contraction).
        Declines (False) under a mesh, while the range is not behind the
        fence, or where ``_columnar_range_prep`` declines
        (``jobs/manager.py:575-588``)."""
        if self.mesh is not None or self.graph.safe_time() < q.end:
            return False
        prep = self._columnar_range_prep(q)
        if prep is None:
            return False
        hops, windows, hb = prep
        if self._kill.is_set():
            return True
        shells = {}

        def grab_shell(T, sw):
            shells[int(T)] = _shell_from_fold(hb.tables, sw, int(T))

        chunks = next((k for k in (4, 3, 2)
                       if len(hops) >= 2 * k and len(hops) % k == 0), 1)
        t0 = _time.perf_counter()
        ranks, steps = hb.run(hops, windows, chunks=chunks,
                              warm_start=chunks > 1
                              and hb.supports_warm_start,
                              hop_callback=grab_shell)
        b0 = _time.perf_counter()
        ranks, steps = _block_steps(lambda: (ranks.cpu().numpy(), steps))
        self.ledger.add_phase("device_wait", _time.perf_counter() - b0)
        self._emit_columnar(hops, windows, ranks, shells, steps,
                            _time.perf_counter() - t0, hb.fold_seconds)
        return True

    def _try_range_mesh_columns(self, q: RangeQuery) -> bool:
        """View-axis mesh parallelism (``jobs/manager.py:652``): the (hop,
        window) columns spread over every rank (``parallel/columns``), the
        tables replicated. Declines without a mesh, before the fence, or
        where ``_columnar_range_prep`` declines."""
        if self.mesh is None or self.graph.safe_time() < q.end:
            return False
        prep = self._columnar_range_prep(q)
        if prep is None:
            return False
        hops, windows, hb = prep
        if self._kill.is_set():
            return True
        from ..parallel.columns import run_columns_sharded

        if isinstance(hb, HopBatchedPageRank):
            kw = dict(kind="pagerank", damping=hb.damping, tol=hb.tol,
                      max_steps=hb.max_steps)
        elif isinstance(hb, HopBatchedCC):
            kw = dict(kind="cc", max_steps=hb.max_steps)
        else:
            kw = dict(kind="bfs", seeds=hb.seeds, directed=hb.directed,
                      max_steps=hb.max_steps)
        shells = {}

        def grab_shell(T, sw):
            shells[int(T)] = _shell_from_fold(hb.tables, sw, int(T))

        t0 = _time.perf_counter()
        _, cols = hb._fold_columns(hops, grab_shell)
        self.ledger.add_phase("fold", hb.fold_seconds)
        if isinstance(hb, HopBatchedSSSP):
            # the weights stay on the host: a rank ships only its hops' rows
            kw["weight_cols"] = cols[4]
        # the four fold columns in one copy of the bytes they span
        ranks, steps = run_columns_sharded(
            hb.tables, *ship(cols, self.mesh.device, 4), hops, windows,
            self.mesh, **kw)
        b0 = _time.perf_counter()
        ranks, steps = _block_steps(lambda: (ranks.cpu().numpy(), steps))
        self.ledger.add_phase("device_wait", _time.perf_counter() - b0)
        self._emit_columnar(hops, windows, ranks, shells, steps,
                            _time.perf_counter() - t0, hb.fold_seconds)
        return True

    def _emit_columnar(self, hops, windows, ranks, shells, steps,
                       elapsed, fold_seconds) -> None:
        """One result row per (hop, window) column: viewTime is the
        AMORTISED share of the sweep plus that row's own reduce, and the
        snapshot-build histogram gets the per-hop share of the fold."""
        W = len(windows)
        per_row = elapsed / max(len(hops) * W, 1)
        for _ in hops:
            METRICS.snapshot_build_seconds.observe(
                fold_seconds / max(len(hops), 1))
        METRICS.supersteps.inc(max(steps, 0))
        self.ledger.count_supersteps(steps)
        for j, T in enumerate(hops):
            if self._kill.is_set():
                return
            for i, w in enumerate(windows):
                self._emit(T, w, ranks[j * W + i], shells[int(T)], steps,
                           _time.perf_counter() - per_row)

    def _emit(self, t, window, result, view, steps, t0) -> None:
        e0 = _time.perf_counter()
        reduced = self.program.reduce(result, view, window=window)
        # counted after the host reduce: viewTime is end to end, and a
        # failed reduce is not a computed view
        METRICS.views_computed.inc()
        METRICS.view_seconds.observe(_time.perf_counter() - t0)
        self.ledger.add_phase("emit", _time.perf_counter() - e0)
        self.ledger.count_views()
        row = {
            "time": int(t),
            "windowsize": int(window) if window is not None else None,
            "viewTime": round((_time.perf_counter() - t0) * 1000.0, 3),
            "steps": int(steps),
            "result": reduced,
        }
        with self._results_mu:
            self.results.append(row)
            if self._results_cap and len(self.results) > self._results_cap:
                drop = len(self.results) - self._results_cap
                del self.results[:drop]
                self.results_dropped += drop
        if self.sink is not None:
            self.sink.write(row)


class AnalysisManager:
    """Job registry + submission surface (``AnalysisManager.scala:49-70``
    job tracking for RequestResults/KillTask). ``device=None`` means the
    CUDA card (and raises without one), or the mesh's device when a
    ``mesh`` is given; ``mesh`` (``parallel/sharded.make_mesh``) is every
    job's default mesh. ``sink_dir`` ("" disables) holds the jobs' result
    files (``jobs/sink``), ``sink_format`` their default format. Every
    submission passes the serving scheduler (``self.scheduler``):
    admission, then its coalescing collect window."""

    def __init__(self, graph: TemporalGraph, device=None, mesh=None,
                 sink_dir: str = "", sink_format: str = "jsonl"):
        from .scheduler import ServingScheduler

        self.graph = graph
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None and device is None
                       else resolve_device(device))
        self.sink_dir = sink_dir
        self.sink_format = sink_format
        #: the serving scheduler: coalescing collect windows, priced
        #: admission and deadlines (RTPU_BATCH_WINDOW_MS=0 and
        #: RTPU_ADMISSION=0 leave every request on its own route)
        self.scheduler = ServingScheduler(graph)
        self._jobs: dict[str, Job] = {}
        self._counter = itertools.count()
        self._lock = threading.Lock()
        # finished jobs stay for /AnalysisResults but are evicted oldest
        # first past the cap; 0 disables
        self._table_cap = max(
            0, int(os.environ.get("RTPU_JOB_TABLE_CAP", 4096)))
        self._san_tracker = _san_track("job_table")

    def _note_table(self, write: bool = False) -> None:
        _san_note(self._san_tracker, write)

    def _evict_done_locked(self) -> None:
        """Drop the oldest FINISHED jobs past the table cap (the caller
        holds ``_lock``); running jobs are never evicted."""
        if not self._table_cap or len(self._jobs) <= self._table_cap:
            return
        excess = len(self._jobs) - self._table_cap
        for jid in [jid for jid, j in self._jobs.items()
                    if j._done.is_set()][:excess]:
            del self._jobs[jid]

    def submit(self, program: VertexProgram, query: Query,
               job_id: str | None = None, mesh=None,
               wait_timeout: float = 30.0, sink_name: str | None = None,
               sink_format: str | None = None, explain: bool = False,
               tenant: str | None = None, deadline_ms=None,
               priority: int = 0, batch=None) -> Job:
        """Admit, register and start a job
        (``raphtory_tpu/jobs/manager.py:1046-1143``). A malformed
        ``deadline_ms`` raises ValueError before admission; an over-budget
        request raises ``scheduler.AdmissionDenied``; ``sink_name`` is a
        file name inside ``sink_dir`` (ignored without one); ``batch=False``
        keeps the job out of the coalescing window."""
        from .sink import ResultSink, resolve_sink_path

        if not isinstance(query, (ViewQuery, RangeQuery, LiveQuery)):
            raise TypeError(f"unknown query type {type(query).__name__}")
        bsp.check_program(program)
        if deadline_ms is not None and not float(deadline_ms) > 0:
            raise ValueError(
                f"deadline_ms must be positive, got {deadline_ms!r}")
        est = self.scheduler.admit(program, query, tenant,
                                   deadline_ms=deadline_ms)
        with self._lock:
            if job_id is None:
                job_id = f"{type(program).__name__}_{next(self._counter)}"
            if job_id in self._jobs:
                self.scheduler.cancel(est, tenant)
                raise KeyError(f"job {job_id!r} already exists")
            try:
                job = Job(job_id, program, query, self.graph, self.device,
                          wait_timeout=wait_timeout,
                          mesh=mesh if mesh is not None else self.mesh,
                          explain=explain, tenant=tenant,
                          deadline_ms=deadline_ms, priority=priority,
                          no_batch=batch is False)
            except BaseException:
                self.scheduler.cancel(est, tenant)
                raise
            job._sched = self.scheduler
            job._admitted_cost_s = est
            self._jobs[job_id] = job
            self._note_table(write=True)
            self._evict_done_locked()
        sink = None
        try:
            # disk I/O stays outside the registry lock; the job is not
            # started yet, so the sink attaches before any emit
            path = resolve_sink_path(self.sink_dir, job_id,
                                     requested=sink_name,
                                     fmt=sink_format or self.sink_format)
            if path is not None:
                sink = ResultSink(path)
                with self._lock:
                    # no two LIVE jobs share one file
                    for other in self._jobs.values():
                        if (other is not job and other.sink is not None
                                and other.sink.path == sink.path
                                and not other._done.is_set()):
                            raise ValueError(
                                f"sink path in use by job {other.id!r}")
                    job.sink = sink
        except BaseException:
            if sink is not None:
                sink.close()
            with self._lock:
                del self._jobs[job_id]
            self.scheduler.cancel(est, tenant)
            raise
        # an eligible job joins its family's collect window BEFORE its
        # thread starts (the thread's first act is to wait on it)
        try:
            self.scheduler.offer(job)
            return job.start()
        except BaseException:
            job.kill()
            if sink is not None:
                sink.close()
            with self._lock:
                self._jobs.pop(job_id, None)
            self.scheduler.cancel(est, tenant)
            raise

    def get(self, job_id: str) -> Job:
        with self._lock:
            job = self._jobs.get(job_id)
            self._note_table()
        if job is None:
            raise KeyError(f"unknown job {job_id!r}")
        return job

    def results(self, job_id: str) -> list[dict]:
        return self.get(job_id).results_snapshot()

    def kill(self, job_id: str) -> None:
        self.get(job_id).kill()

    def jobs(self) -> dict[str, str]:
        with self._lock:
            self._note_table()
            return {jid: j.status for jid, j in self._jobs.items()}
