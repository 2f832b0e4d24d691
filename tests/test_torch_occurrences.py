"""The occurrence route of the port (TaintTracking over the multigraph of
edge-add events) against the JAX package, on the same seeded logs:

* the occurrence rows of ``build_view(..., include_occurrences=True)`` and
  of ``SweepBuilder(include_occurrences=True)`` at each hop (``occ_src``,
  ``occ_dst``, ``occ_time``, ``occ_mask``, the log rows and ``occ_prop``)
  bitwise the reference's;
* the int64 twins of K7 (``segment_combine_plain``) and K7-P
  (``partition_segment_reduce`` over ``partition_reduce_plain``) against
  ``raphtory_tpu/ops/segment.py:35, 116``: sum, min and max, masked rows,
  empty segments, INT64_MIN / INT64_MAX payloads, bitwise;
* ``bsp.run(TaintTracking(...))`` against the reference's ``bsp.run``:
  plain, one window and batched windows, with a stop-list and with a
  value gate, on the unbinned (``RTPU_PCPM=0``) and binned (``=1``)
  routes; bitwise with equal supersteps; and the reference's hand logs;
* View and Range jobs through both managers, row for row;
* the degenerate 1 x 1 mesh in this process (the 4-rank meshes are cases
  of ``test_torch_sharded.py``'s rank group);
* ``program_from_params`` round-trips the reference's dataclass.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sweep import random_log

from raphtory_tpu.algorithms import TaintTracking as JTaint
from raphtory_tpu.core.events import EventLog as JEventLog
from raphtory_tpu.core.service import TemporalGraph as JTemporalGraph
from raphtory_tpu.core.snapshot import build_view as jbuild_view
from raphtory_tpu.core.sweep import SweepBuilder as JSweepBuilder
from raphtory_tpu.engine import bsp as jbsp
from raphtory_tpu.jobs.manager import AnalysisManager as JAnalysisManager
from raphtory_tpu.jobs.manager import RangeQuery as JRangeQuery
from raphtory_tpu.jobs.manager import ViewQuery as JViewQuery
from raphtory_tpu.ops import segment as jseg
from raphtory_tpu_torch.algorithms import TaintTracking
from raphtory_tpu_torch.core.service import TemporalGraph
from raphtory_tpu_torch.core.snapshot import _indptr, build_view
from raphtory_tpu_torch.core.sweep import SweepBuilder
from raphtory_tpu_torch.engine import bsp
from raphtory_tpu_torch.interop import (event_log_from_arrays,
                                        numeric_prop_payloads,
                                        program_from_params)
from raphtory_tpu_torch.jobs.manager import (AnalysisManager, RangeQuery,
                                             ViewQuery)
from raphtory_tpu_torch.ops import segment
from raphtory_tpu_torch.parallel import sharded

OCC_FIELDS = ("occ_src", "occ_dst", "occ_time", "occ_mask", "_occ_rows")
I64 = np.iinfo(np.int64)
IMAX = int(I64.max)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def indptr(ids, n):
    """int64 CSR row pointers of sorted ``ids`` over ``n`` rows."""
    return _indptr(ids, n).astype(np.int64)


def logs(seed, n_events=900, n_ids=40):
    """(reference log, port log): the adversarial random log with
    deletes, duplicate times and numeric props (``w``)."""
    jlog = random_log(np.random.default_rng(seed), n_events=n_events,
                      n_ids=n_ids, t_span=100, props=True)
    return jlog, event_log_from_arrays(
        jlog.arrays(), props=numeric_prop_payloads(jlog.props))


def assert_occurrences_equal(got, want):
    assert got.n_pad == want.n_pad and got.m_pad == want.m_pad
    for f in OCC_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    for key in ("w", "kind", "absent"):
        np.testing.assert_array_equal(got.occ_prop(key), want.occ_prop(key))


# ------------------------------------------------------------ the rows

@pytest.mark.parametrize("builder", ["build_view", "sweep"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_occurrence_rows_match_reference(seed, builder):
    """Every hop's occurrence rows and per-event props, bitwise: only the
    edge-add events of edges alive at T, (dst, src)-sorted, pads at
    n_pad-1 with INT64_MIN times and no mask."""
    jlog, log = logs(seed)
    times = [0, 12, 40, 41, 77, 99, 150]
    if builder == "sweep":
        sw, jsw = (SweepBuilder(log, include_occurrences=True),
                   JSweepBuilder(jlog, include_occurrences=True))
        views = [(sw.view_at(t), jsw.view_at(t)) for t in times]
    else:
        views = [(build_view(log, t, include_occurrences=True),
                  jbuild_view(jlog, t, include_occurrences=True))
                 for t in times]
    for got, want in views:
        assert_occurrences_equal(got, want)
        o = int((got._occ_rows >= 0).sum())
        assert got.occ_mask[:o].all() and not got.occ_mask[o:].any()
        assert (got.occ_src[o:] == got.n_pad - 1).all()
        assert (got.occ_time[o:] == I64.min).all()
    plain = build_view(log, 99)
    assert plain.occ_src is None
    with pytest.raises(ValueError, match="include_occurrences"):
        plain.occ_prop("w")
    with pytest.raises(ValueError, match="add-row lists"):
        SweepBuilder(log, include_occurrences=True, track_rows=False)


def test_service_keys_its_cache_by_occurrences():
    jlog, log = logs(4)
    jg, g = JTemporalGraph(jlog), TemporalGraph(log, device="cpu")
    plain, occ = g.view_at(60), g.view_at(60, include_occurrences=True)
    assert plain.occ_src is None and occ is not plain
    assert g.view_at(60, include_occurrences=True) is occ
    assert_occurrences_equal(occ, jg.view_at(60, include_occurrences=True))
    assert_occurrences_equal(g.live_view(include_occurrences=True),
                             jg.live_view(include_occurrences=True))


# ------------------------------------------------- K7 / K7-P on int64

def _int64_payload(rng, shape):
    """int64 taint-like payloads: times, the dtype's extremes and IMAX."""
    x = rng.integers(-10**12, 10**12, shape).astype(np.int64)
    edge = np.array([I64.min, I64.min + 1, -1, 0, 1, I64.max - 1, I64.max])
    pick = rng.random(shape) < 0.3
    x[pick] = rng.choice(edge, int(pick.sum()))
    return x


@pytest.mark.parametrize("F", [0, 2])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("direction", ["dst", "src"])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_segment_combine_int64_twin_matches_jax(op, direction, k, F):
    """K7's int64 twin: an unaligned edge count (m 45 of m_pad 64), rows
    that get no edge, a window fully masked, extremes in the payload."""
    rng = np.random.default_rng(5)
    n, n_real, m_pad, m_real = 16, 13, 64, 45
    src = rng.integers(0, n_real, m_real)
    dst = rng.integers(0, n_real - 3, m_real)
    order = np.lexsort((src, dst))
    e_src = np.full(m_pad, n - 1, np.int32)
    e_dst = np.full(m_pad, n - 1, np.int32)
    e_src[:m_real], e_dst[:m_real] = src[order], dst[order]
    if direction == "dst":
        ids = e_dst
        csr = segment.SegmentCSR(T(e_dst), T(indptr(e_dst[:m_real], n)),
                                 None)
    else:
        ids = e_src
        csr = segment.SegmentCSR(T(e_src), T(indptr(e_src[:m_real], n)),
                                 T(np.argsort(e_src[:m_real], kind="stable")
                                   .astype(np.int32)))
    x = _int64_payload(rng, (k * m_pad,) + ((F,) if F else ()))
    mask = rng.random(k * m_pad) < 0.7
    mask.reshape(k, m_pad)[:, m_real:] = False
    if k > 1:
        mask.reshape(k, m_pad)[k - 1] = False     # an all-masked window
    flat = (ids.astype(np.int64)[None, :]
            + np.arange(k)[:, None] * n).reshape(-1)
    want = np.asarray(jseg.segment_combine(
        jnp.asarray(x), jnp.asarray(flat, jnp.int32), k * n, op,
        jnp.asarray(mask), indices_are_sorted=direction == "dst"))
    got = segment.segment_combine(T(x), csr, op, T(mask), k).numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert segment.neutral(op, torch.int64) == \
        {"sum": 0, "min": IMAX, "max": int(I64.min)}[op]


@pytest.mark.parametrize("F", [0, 2])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_partition_segment_reduce_int64_matches_jax(op, F):
    """K7-P's int64 twin with the reference's operands: P*n_per 80 > n 77
    (the overhang sliced away), masked slots, empty rows, extremes."""
    rng = np.random.default_rng(6)
    P, cap, n_per, n = 5, 48, 16, 77
    loc = rng.integers(0, n_per - 2, (P, cap)).astype(np.int32)
    mask = rng.random((P, cap)) < 0.75
    mask[2] = False                      # a partition with nothing live
    data = _int64_payload(rng, (P, cap) + ((F,) if F else ()))
    want = np.asarray(jseg.partition_segment_reduce(
        jnp.asarray(data), jnp.asarray(loc), n_per, n, op,
        jnp.asarray(mask)))
    got = segment.partition_segment_reduce(T(data), T(loc), n_per, n, op,
                                           T(mask)).numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 3])
def test_partition_reduce_int64_through_the_view_layout(k):
    """The engine's form: the taint exchange read through a view's
    occurrence layout (``perm`` / ``valid``) equals K7's flat min over
    the same rows, and the reference's gather-then-reduce."""
    from raphtory_tpu_torch.ops import partition

    _, log = logs(7)
    view = build_view(log, 90, include_occurrences=True)
    lay = partition.build_layout(view.occ_src, view.occ_dst, view.n_pad,
                                 bsp._occ_count(view), 3)
    rng = np.random.default_rng(k)
    o_pad = len(view.occ_src)
    x = _int64_payload(rng, k * o_pad)
    em = rng.random(k * o_pad) < 0.6
    em.reshape(k, o_pad)[:] &= view.occ_mask
    be = lay.device_edges("cpu")
    walk = segment.PartitionWalk(be.in_indptr, be.in_order, be.perm,
                                 be.valid)
    got = segment.partition_reduce(T(x), walk, "min", T(em), k)
    e = bsp.view_edges(view, "cpu", occurrences=True)
    flat = segment.segment_combine(
        T(x), segment.SegmentCSR(e.e_dst, e.in_indptr, None), "min", T(em),
        k)
    assert torch.equal(got, flat)
    spec = lay.spec
    b_local = (lay.b_dst.reshape(spec.partitions, spec.cap)
               - np.arange(spec.partitions)[:, None] * spec.n_per)
    for w in range(k):
        xb = x.reshape(k, o_pad)[w][lay.perm]
        mb = em.reshape(k, o_pad)[w][lay.perm] & lay.valid
        want = np.asarray(jseg.partition_segment_reduce(
            jnp.asarray(xb.reshape(spec.partitions, spec.cap)),
            jnp.asarray(b_local), spec.n_per, view.n_pad, "min",
            jnp.asarray(mb.reshape(spec.partitions, spec.cap))))
        np.testing.assert_array_equal(
            got.numpy()[w * view.n_pad:(w + 1) * view.n_pad], want)


# ---------------------------------------------------------- the engine

def _programs(view, variant):
    """(reference, port) TaintTracking on a view's own ids: 3 seeds and,
    by variant, a stop-list or a value gate on the per-event ``w``."""
    ids = [int(v) for v in view.vids[:view.n_active]]
    kw = dict(seeds=tuple(ids[:3]), start_time=10, max_steps=30)
    if variant == "stop":
        kw["stop_list"] = tuple(ids[3:6])
    elif variant == "value":
        kw.update(value_prop="w", min_value=2.0)
    jprog = JTaint(**kw)
    return jprog, program_from_params("TaintTracking",
                                      **dataclasses.asdict(jprog))


@pytest.mark.parametrize("pcpm", ["0", "1"])
@pytest.mark.parametrize("query", ["plain", "window", "windows"])
@pytest.mark.parametrize("variant", ["stop", "value"])
@pytest.mark.parametrize("seed", [0, 3])
def test_taint_matches_reference(seed, variant, query, pcpm, monkeypatch):
    """Bitwise taint times and equal supersteps on both routes; with
    ``RTPU_PCPM=1`` the exchange is the binned one (its layout built over
    the REAL occurrence rows, tag ``occ``)."""
    monkeypatch.setenv("RTPU_PCPM", pcpm)
    built = []
    real = bsp._view_layout
    monkeypatch.setattr(bsp, "_view_layout", lambda v, occ=False: built.append(
        occ) or real(v, occ))
    jlog, log = logs(seed)
    view = build_view(log, 90, include_occurrences=True)
    jview = jbuild_view(jlog, 90, include_occurrences=True)
    jprog, prog = _programs(jview, variant)
    kw = {"plain": {}, "window": {"window": 30},
          "windows": {"windows": [100, 40, 7]}}[query]
    want, wsteps = jbsp.run(jprog, jview, **kw)
    got, steps = bsp.run(prog, view, device="cpu", **kw)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == int(wsteps) > 0
    assert built == [True]
    lay = real(view, True)
    assert (lay is not None) == (pcpm == "1")
    if lay is not None:     # the real rows binned, the pads not
        assert int(lay.valid.sum()) == bsp._occ_count(view)
    assert (got.numpy() < IMAX).any()


def _hand_log(make):
    """The same small hand log in both packages (``make(log)`` adds the
    events through the ``EventLog`` verbs)."""
    jlog = JEventLog()
    make(jlog)
    return jlog, event_log_from_arrays(
        jlog.arrays(), props=numeric_prop_payloads(jlog.props))


def _chain(log):
    # tests/test_algorithms_extended.py:37-49: a later re-use carries taint
    log.add_edge(10, 1, 2)
    log.add_edge(15, 2, 3)
    log.add_edge(12, 3, 4)
    log.add_edge(30, 3, 4)


def _stop(log):
    # tests/test_algorithms_extended.py:62-72: 2 absorbs, never re-emits
    log.add_edge(10, 1, 2)
    log.add_edge(20, 2, 3)


def _dust(log):
    # tests/test_sharded.py:214-235: taint gated on each event's value
    log.add_edge(10, 1, 2, props={"value": 100.0})
    log.add_edge(20, 2, 3, props={"value": 0.5})
    log.add_edge(30, 2, 3, props={"value": 50.0})
    log.add_edge(5, 3, 4, props={"value": 99.0})
    log.add_edge(40, 3, 4, props={"value": 99.0})


HAND = {
    "chain": (_chain, 50, dict(seeds=(1,), start_time=5),
              {1: 5, 2: 10, 3: 15, 4: 30}),
    "stop": (_stop, 50, dict(seeds=(1,), start_time=0, stop_list=(2,)),
             {1: 0, 2: 10}),
    "dust": (_dust, 50, dict(seeds=(1,), start_time=0, max_steps=10,
                             value_prop="value", min_value=1.0),
             {1: 0, 2: 10, 3: 30, 4: 40}),
}


@pytest.mark.parametrize("case", sorted(HAND))
def test_hand_logs_match_reference(case):
    """The reference's own hand-made cases: the port's infections equal
    the reference's and the expected ones; a 1 x 1 mesh (all_gather and
    halo) gives the same taint times."""
    make, t, kw, expect = HAND[case]
    jlog, log = _hand_log(make)
    view = build_view(log, t, include_occurrences=True)
    jview = jbuild_view(jlog, t, include_occurrences=True)
    prog, jprog = TaintTracking(**kw), JTaint(**kw)
    got, steps = bsp.run(prog, view, device="cpu")
    want, wsteps = jbsp.run(jprog, jview)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == int(wsteps)
    out = prog.reduce(got, view)
    assert out == jprog.reduce(np.asarray(want), jview)
    assert {r["id"]: r["taintedAt"] for r in out["infections"]} == expect
    mesh = sharded.make_mesh(1, 1, device="cpu")
    for comm in ("all_gather", "halo"):
        res, msteps = sharded.run(prog, view, mesh, comm=comm)
        assert torch.equal(res, got) and msteps == steps


def test_views_without_occurrences_raise_as_the_reference():
    jlog, log = logs(1)
    view, jview = build_view(log, 50), jbuild_view(jlog, 50)
    prog, jprog = TaintTracking(seeds=(1,)), JTaint(seeds=(1,))
    for run, p, v, kw in ((jbsp.run, jprog, jview, {}),
                          (bsp.run, prog, view, {"device": "cpu"})):
        with pytest.raises(ValueError, match="include_occurrences"):
            run(p, v, **kw)
    mesh = sharded.make_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="include_occurrences"):
        sharded.run(prog, view, mesh)


def test_program_from_params_round_trips_the_reference():
    jprog = JTaint(seeds=(3, 1, 2), start_time=7, stop_list=(9,),
                   max_steps=12, value_prop="value", min_value=0.25)
    prog = program_from_params("TaintTracking", **dataclasses.asdict(jprog))
    assert isinstance(prog, TaintTracking)
    assert dataclasses.asdict(prog) == dataclasses.asdict(jprog)
    assert prog.edge_props == jprog.edge_props == ("value",)
    for flag in ("combiner", "direction", "needs_occurrences",
                 "needs_vids", "needs_vertex_times", "needs_edge_times",
                 "monotone_min"):
        assert getattr(prog, flag) == getattr(jprog, flag), flag


# ----------------------------------------------------------- the jobs

@pytest.mark.parametrize("mesh", [False, True])
@pytest.mark.parametrize("pcpm", ["0", "1"])
@pytest.mark.parametrize("kind", ["view", "range"])
def test_taint_jobs_match_reference(kind, pcpm, mesh, monkeypatch):
    """A View job (cold route, ``include_occurrences``) and a Range job
    (hop by hop over ``SweepBuilder(include_occurrences=True)``), row for
    row; the columnar, resident and static-partition routes decline. With
    a 1 x 1 mesh the jobs run ``sharded.run`` over the occurrence
    partition, with the same rows."""
    monkeypatch.setenv("RTPU_PCPM", pcpm)
    monkeypatch.setenv("RTPU_BATCH_WINDOW_MS", "0")
    jlog, log = logs(2, n_events=1_500, n_ids=60)
    jview = jbuild_view(jlog, 99)
    ids = [int(v) for v in jview.vids[:jview.n_active]]
    jprog = JTaint(seeds=tuple(ids[:2]), start_time=20,
                   stop_list=(ids[4],), max_steps=25)
    prog = program_from_params("TaintTracking", **dataclasses.asdict(jprog))
    if kind == "view":
        q, jq = (ViewQuery(timestamp=95, windows=(100, 30, 5)),
                 JViewQuery(timestamp=95, windows=(100, 30, 5)))
    else:
        q, jq = (RangeQuery(start=40, end=99, jump=20, windows=(60, 15)),
                 JRangeQuery(start=40, end=99, jump=20, windows=(60, 15)))
    jmgr = JAnalysisManager(JTemporalGraph(jlog))
    jjob = jmgr.submit(jprog, jq)
    assert jjob.wait(300) and jjob.status == "done", jjob.error
    calls = []
    real_run = sharded.run
    monkeypatch.setattr(sharded, "run", lambda *a, **k: calls.append(1)
                        or real_run(*a, **k))
    g = TemporalGraph(log, device="cpu")
    mgr = AnalysisManager(g, device="cpu", mesh=sharded.make_mesh(
        1, 1, device="cpu") if mesh else None)
    job = mgr.submit(prog, q)
    assert job.wait(300) and job.status == "done", job.error
    got, want = mgr.results(job.id), jmgr.results(jjob.id)
    assert len(got) == len(want) == (3 if kind == "view" else 6)
    for gr, wr in zip(got, want):
        for key in ("time", "windowsize", "steps", "result"):
            assert gr[key] == wr[key], (key, gr, wr)
    assert g._resident is None    # the warm route declined, built nothing
    assert len(calls) == (len(got) // len(q.windows) if mesh else 0)
    assert any(r["result"]["tainted"] for r in got)
