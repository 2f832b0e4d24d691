"""Job orchestration: Range analysis over the hop-batched columnar engine.

The reference spawns one ``AnalysisTask`` actor per request
(``AnalysisManager.scala:72-167``, ``Tasks/``), each driving the actor BSP
handshake per timestamp. Here a job is a host thread that runs a whole
Range query as columns of one columnar sweep (``engine/hopbatch``) and
emits one result row per (hop, window) view.

Range queries of PageRank, ConnectedComponents and SSSP/BFS run on the
columnar engines. A View query, a Live query or another program raises
``NotImplementedError`` at submit, naming the ROADMAP item that brings it.
A failed dispatch fails the job (``status`` / ``error``); there is no
per-hop fallback route.
"""

from __future__ import annotations

import itertools
import threading
import time as _time
import traceback
from dataclasses import dataclass

import numpy as np

from ..algorithms import SSSP, ConnectedComponents, PageRank
from ..core.service import TemporalGraph
from ..core.snapshot import INT64_MIN
from ..engine.hopbatch import (HopBatchedBFS, HopBatchedCC,
                               HopBatchedPageRank, HopBatchedSSSP)
from ..engine.program import VertexProgram
from ..utils.device import resolve_device


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


class StaleRangeError(RuntimeError):
    """The watermark fence did not pass the range's end in time."""


class _Shell:
    """The reducer-facing slice of a GraphView over the global dense space:
    enough for host reducers (vids / v_mask / window_masks)."""

    def __init__(self, time, n_pad, vids, v_mask, v_latest_time,
                 v_first_time):
        self.time = time
        self.n_pad = n_pad
        self.vids = vids
        self.v_mask = v_mask
        self.v_latest_time = v_latest_time
        self.v_first_time = v_first_time

    def window_masks(self, windows):
        w = np.asarray(windows, np.int64).reshape(-1, 1)
        lo = self.time - w
        v = self.v_mask[None, :] & (self.v_latest_time[None, :] >= lo)
        return v, None  # the shell carries no edge masks


#: the programs a Range job runs on a columnar engine
_COLUMNAR = (PageRank, ConnectedComponents, SSSP)


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


class Job:
    def __init__(self, job_id: str, program: VertexProgram, query: RangeQuery,
                 graph: TemporalGraph, device, wait_timeout: float = 30.0):
        self.id = job_id
        self.program = program
        self.query = query
        self.graph = graph
        self.device = device
        self.wait_timeout = wait_timeout
        self.results: list[dict] = []
        self._results_mu = threading.Lock()
        self.status = "pending"
        self.error: str | None = None
        self._kill = threading.Event()
        self._done = threading.Event()
        self._thread: threading.Thread | None = None

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
        try:
            self._run_range(self.query)
            self.status = "done" if not self._kill.is_set() else "killed"
        except Exception as e:  # job errors surface via status, like the
            self.status = "failed"  # reference's per-phase catches
            self.error = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
        finally:
            self._done.set()

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
        with the reference's size guards (``jobs/manager.py:546``). A range
        past them would need the per-hop engines, which this slice does not
        carry."""
        hops = list(range(int(q.start), int(q.end) + 1, int(q.jump)))
        windows = list(q.windows) if q.windows is not None else [q.window]
        if not hops or len(hops) * len(windows) > 1024:
            raise NotImplementedError(
                f"{len(hops)} hops x {len(windows)} windows is outside the "
                "columnar route (1 to 1024 views); the per-hop engines are "
                "ROADMAP queue 1 items 4-5")
        hb = self._columnar_builder()
        if hb.device_mask_bytes(len(hops) * len(windows)) > 1 << 32 \
                or hb.host_column_bytes(len(hops)) > 1 << 29:
            raise NotImplementedError(
                "range too large for the columnar route's memory guards; "
                "the per-hop engines are ROADMAP queue 1 items 4-5")
        return hops, windows, hb

    def _run_range(self, q: RangeQuery) -> None:
        """Whole-range columnar sweep: every (hop, window) view is a column
        of one pass (``engine/hopbatch``), pipelined in equal hop chunks
        (warm-started where the engine's iteration is a contraction),
        behind the watermark fence at ``q.end``."""
        if not self.graph.watermarks.wait_for(int(q.end),
                                              timeout=self.wait_timeout):
            raise StaleRangeError(
                f"range end {q.end} not yet safe: watermark="
                f"{self.graph.safe_time()} ({self.graph.watermarks.snapshot()})")
        hops, windows, hb = self._columnar_range_prep(q)
        if self._kill.is_set():
            return
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
        ranks = ranks.cpu().numpy()
        self._emit_columnar(hops, windows, ranks, shells, steps,
                            _time.perf_counter() - t0)

    def _emit_columnar(self, hops, windows, ranks, shells, steps,
                       elapsed) -> None:
        """One result row per (hop, window) column: viewTime is the
        AMORTISED share of the sweep plus that row's own reduce."""
        W = len(windows)
        per_row = elapsed / max(len(hops) * W, 1)
        for j, T in enumerate(hops):
            if self._kill.is_set():
                return
            for i, w in enumerate(windows):
                self._emit(T, w, ranks[j * W + i], shells[int(T)], steps,
                           _time.perf_counter() - per_row)

    def _emit(self, t, window, result, view, steps, t0) -> None:
        reduced = self.program.reduce(result, view, window=window)
        row = {
            "time": int(t),
            "windowsize": int(window) if window is not None else None,
            "viewTime": round((_time.perf_counter() - t0) * 1000.0, 3),
            "steps": int(steps),
            "result": reduced,
        }
        with self._results_mu:
            self.results.append(row)


class AnalysisManager:
    """Job registry + submission surface (``AnalysisManager.scala:49-70``
    job tracking for RequestResults/KillTask). ``device=None`` means the
    CUDA card (and raises without one)."""

    def __init__(self, graph: TemporalGraph, device=None):
        self.graph = graph
        self.device = resolve_device(device)
        self._jobs: dict[str, Job] = {}
        self._counter = itertools.count()
        self._lock = threading.Lock()

    def submit(self, program: VertexProgram, query,
               job_id: str | None = None,
               wait_timeout: float = 30.0) -> Job:
        if isinstance(query, ViewQuery):
            raise NotImplementedError(
                "View queries run on the generic vertex-program engine and "
                "the resident sweep: ROADMAP queue 1 items 4-5")
        if not isinstance(query, RangeQuery):
            raise NotImplementedError(
                f"{type(query).__name__} is not carried yet: Live queries "
                "come with the jobs/serving slice, ROADMAP queue 1 item 7")
        if type(program) not in _COLUMNAR:
            raise NotImplementedError(
                f"{type(program).__name__} Range queries run on the generic "
                "vertex-program engine: ROADMAP queue 1 item 4")
        with self._lock:
            if job_id is None:
                job_id = f"{type(program).__name__}_{next(self._counter)}"
            if job_id in self._jobs:
                raise KeyError(f"job {job_id!r} already exists")
            job = Job(job_id, program, query, self.graph, self.device,
                      wait_timeout=wait_timeout)
            self._jobs[job_id] = job
        return job.start()

    def get(self, job_id: str) -> Job:
        with self._lock:
            job = self._jobs.get(job_id)
        if job is None:
            raise KeyError(f"unknown job {job_id!r}")
        return job

    def results(self, job_id: str) -> list[dict]:
        return self.get(job_id).results_snapshot()

    def kill(self, job_id: str) -> None:
        self.get(job_id).kill()

    def jobs(self) -> dict[str, str]:
        with self._lock:
            return {jid: j.status for jid, j in self._jobs.items()}
