"""K7-mode ``segment_mode`` and ``LabelPropagation`` in the port against the
JAX package, on the same numpy inputs:

* ``segment_mode_plain`` (the twin of ``rtpu_segment_mode``) against
  ``raphtory_tpu.ops.segment.segment_mode``, BITWISE: the reference's own
  cases (basic, ties to the smallest value, mask and default, values
  outside [0, 2^31)), randomised inboxes, k > 1 flat windows, and the
  source direction through ``out_perm``. The CSR walk the kernel does is
  checked by a plain walk of it that picks what the kernel picks.
* ``LabelPropagation`` through ``bsp.run`` (plain, ``window=``, batched
  ``windows=``) and ``DeviceSweep.run`` against the JAX package's, labels
  bitwise with equal supersteps; its View and Range jobs row for row
  against the JAX package's jobs; the custom combiner with direction
  'both' raising ``ValueError``; and the shape of ``reduce``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sweep import random_log

from raphtory_tpu.algorithms import LabelPropagation as JLPA
from raphtory_tpu.core.service import TemporalGraph as JTemporalGraph
from raphtory_tpu.core.snapshot import build_view as jbuild_view
from raphtory_tpu.engine import bsp as jbsp
from raphtory_tpu.engine import device_sweep as jds
from raphtory_tpu.jobs.manager import AnalysisManager as JAnalysisManager
from raphtory_tpu.jobs.manager import RangeQuery as JRangeQuery
from raphtory_tpu.jobs.manager import ViewQuery as JViewQuery
from raphtory_tpu.ops import segment as jseg
from raphtory_tpu.utils.synth import ldbc_like_log
from raphtory_tpu_torch.algorithms import LabelPropagation
from raphtory_tpu_torch.core.service import TemporalGraph
from raphtory_tpu_torch.core.snapshot import build_view
from raphtory_tpu_torch.engine import bsp
from raphtory_tpu_torch.engine import device_sweep as tds
from raphtory_tpu_torch.interop import event_log_from_arrays, \
    program_from_params
from raphtory_tpu_torch.jobs.manager import (AnalysisManager, RangeQuery,
                                             ViewQuery)
from raphtory_tpu_torch.ops import segment


@pytest.fixture(autouse=True)
def _reference_routes(monkeypatch):
    monkeypatch.setenv("RTPU_PCPM", "0")
    monkeypatch.setenv("RTPU_PREFETCH", "0")
    monkeypatch.setenv("RTPU_BATCH_WINDOW_MS", "0")


def _flat_csr(ids, n):
    """A destination-style ``SegmentCSR`` over flat segment ids: the rows
    of segment r found through ``perm`` (a stable sort by id)."""
    ids = np.asarray(ids, np.int32)
    perm = np.argsort(ids, kind="stable").astype(np.int32)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(ids, minlength=n), out=indptr[1:])
    return segment.SegmentCSR(torch.from_numpy(ids),
                              torch.from_numpy(indptr),
                              torch.from_numpy(perm))


def _kernel_walk(vals, csr, k, mask, default):
    """What ``rtpu_segment_mode`` does, in plain Python: each (window, row)
    CSR run, its valid values counted, largest count then smallest
    value."""
    m, n = csr.ids.shape[0], csr.n
    indptr, perm = csr.indptr.numpy(), csr.perm
    out = np.full(k * n, default, np.int64)
    for w in range(k):
        for r in range(n):
            js = np.arange(indptr[r], indptr[r + 1])
            e = w * m + (js if perm is None else perm.numpy()[js])
            v = vals[e][mask[e] & (vals[e] >= 0) & (vals[e] < 2**31)]
            if len(v):
                u, c = np.unique(v, return_counts=True)
                out[w * n + r] = u[np.flatnonzero(c == c.max())[0]]
    return out


def _both(vals, ids, n, mask=None, default=-1, k=1, csr=None):
    """(port twin, JAX) of the same mode over flat window-major rows."""
    csr = _flat_csr(ids, n) if csr is None else csr
    ids_flat = (csr.ids.numpy().astype(np.int64)[None, :]
                + np.arange(k)[:, None] * n).reshape(-1)
    got = segment.segment_mode_plain(
        torch.from_numpy(np.asarray(vals)), csr, k * n,
        None if mask is None else torch.from_numpy(np.asarray(mask)),
        default, k)
    want = np.asarray(jseg.segment_mode(
        jnp.asarray(vals), jnp.asarray(ids_flat), k * n,
        None if mask is None else jnp.asarray(mask), default=default))
    return got.numpy(), want


def test_segment_mode_basic_and_ties():
    got, want = _both(np.array([5, 5, 7, 7, 7, 2], np.int32),
                      [0, 0, 0, 1, 1, 1], 3)
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [5, 7, -1] and got.dtype == np.int32
    got, want = _both(np.array([9, 3, 3, 9], np.int32), [0, 0, 0, 0], 1)
    assert got.tolist() == want.tolist() == [3]


def test_segment_mode_mask_and_default():
    got, want = _both(np.array([1, 1, 8], np.int32), [0, 0, 1], 2,
                      mask=np.array([False, True, False]), default=-7)
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [1, -7]


def test_segment_mode_out_of_range_values_are_no_message():
    vals = np.array([5, -3, 2**31 + 1, 5, 2**31 - 1], np.int64)
    got, want = _both(vals, [0, 1, 1, 2, 3], 4)
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [5, -1, 5, 2**31 - 1] and got.dtype == np.int64
    got, want = _both(np.array([-1, -5, 4], np.int32), [0, 0, 0], 1)
    assert got.tolist() == want.tolist() == [4]


@pytest.mark.parametrize("seed", range(6))
def test_segment_mode_randomised_windows_and_directions(seed):
    """Random inboxes with ties, masked and negative rows, empty segments
    and k windows; the destination walk (perm None over sorted ids) and
    the source walk through a permutation."""
    rng = np.random.default_rng(seed)
    n, m, k = 37, 400, 1 + seed % 3
    for direction in ("dst", "src"):
        ids = rng.integers(0, n - 3, m).astype(np.int32)
        if direction == "dst":
            ids = np.sort(ids)
            indptr = np.zeros(n + 1, np.int64)
            np.cumsum(np.bincount(ids, minlength=n), out=indptr[1:])
            csr = segment.SegmentCSR(torch.from_numpy(ids),
                                     torch.from_numpy(indptr), None)
        else:
            csr = _flat_csr(ids, n)
        vals = rng.integers(0, 9, k * m).astype(np.int32)
        vals[rng.random(k * m) < 0.05] = -2
        mask = rng.random(k * m) < 0.8
        got, want = _both(vals, ids, n, mask, -1, k, csr)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, _kernel_walk(vals, csr, k, mask, -1))


def test_segment_mode_engine_directions_on_a_view():
    """The CSRs the superstep runner hands the exchange: the destination
    CSR over the (dst, src)-sorted edges and the source walk through
    ``out_perm`` (pad edges masked in every window)."""
    log = event_log_from_arrays(random_log(np.random.default_rng(3),
                                           n_events=600, n_ids=40,
                                           t_span=80).arrays())
    view = build_view(log, 70)
    e = bsp.view_edges(view, "cpu")
    rng = np.random.default_rng(0)
    k, m, n = 2, view.m_pad, view.n_pad
    vals = rng.integers(0, 6, k * m).astype(np.int32)
    mask = np.tile(view.e_mask, k) & (rng.random(k * m) < 0.9)
    for ids, csr in ((view.e_dst, segment.SegmentCSR(e.e_dst, e.in_indptr,
                                                     None)),
                     (view.e_src, segment.SegmentCSR(e.e_src, e.out_indptr,
                                                     e.out_perm))):
        got, want = _both(vals, ids, n, mask, -1, k, csr)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, _kernel_walk(vals, csr, k, mask, -1))


def test_segment_mode_wrapper_checks():
    csr = _flat_csr([0, 1, 1], 2)
    vals = torch.tensor([1, 2, 2], dtype=torch.int32)
    assert segment.segment_mode(vals, csr, 2).tolist() == [1, 2]
    with pytest.raises(ValueError, match="num_segments"):
        segment.segment_mode(vals, csr, 3)
    with pytest.raises(ValueError, match="values"):
        segment.segment_mode(vals[:2], csr, 2)


# ------------------------------------------------------------------ LPA

def _lpa_logs(seed):
    jlog = random_log(np.random.default_rng(seed), n_events=700, n_ids=45,
                      t_span=100)
    return jlog, event_log_from_arrays(jlog.arrays())


QUERIES = {"plain": {}, "window": {"window": 30},
           "windows": {"windows": [100, 30, 7]}}


@pytest.mark.parametrize("query", sorted(QUERIES))
@pytest.mark.parametrize("seed", [0, 2, 5])
def test_lpa_bsp_run_matches_reference(seed, query):
    jlog, log = _lpa_logs(seed)
    jprog = JLPA(max_steps=12)
    prog = program_from_params("LabelPropagation",
                               **dataclasses.asdict(jprog))
    assert isinstance(prog, LabelPropagation)
    for T in (45, 99):
        want, wsteps = jbsp.run(jprog, jbuild_view(jlog, T),
                                **QUERIES[query])
        got, steps = bsp.run(prog, build_view(log, T), device="cpu",
                             **QUERIES[query])
        assert steps == int(wsteps) and steps > 0
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [1, 4])
def test_lpa_device_sweep_matches_reference(seed):
    jlog, log = _lpa_logs(seed)
    jsw = jds.DeviceSweep(jlog)
    tsw = tds.DeviceSweep(log, device="cpu")
    jprog = JLPA(max_steps=10)
    prog = program_from_params("LabelPropagation",
                               **dataclasses.asdict(jprog))
    for T, kw in ((30, {}), (60, {"window": 25}),
                  (99, {"windows": [100, 20]})):
        want, wsteps = jsw.run(jprog, T, **kw)
        got, steps = tsw.run(prog, T, **kw)
        assert steps == int(wsteps)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lpa_binned_view_keeps_the_flat_exchange(monkeypatch):
    """A custom exchange never takes the binned route: with ``RTPU_PCPM=1``
    the cold View builds no layout and gives the same labels."""
    monkeypatch.setenv("RTPU_PCPM", "1")
    calls = []
    real = bsp._view_layout
    monkeypatch.setattr(bsp, "_view_layout",
                        lambda v: calls.append(1) or real(v))
    jlog, log = _lpa_logs(3)
    want, wsteps = jbsp.run(JLPA(max_steps=8), jbuild_view(jlog, 80),
                            windows=[100, 30])
    got, steps = bsp.run(LabelPropagation(max_steps=8), build_view(log, 80),
                         windows=[100, 30], device="cpu")
    assert not calls and steps == int(wsteps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jobs(log_port, jlog, prog, jprog, q, jq):
    rows = []
    for mgr, p, qq in (
            (JAnalysisManager(JTemporalGraph(jlog)), jprog, jq),
            (AnalysisManager(TemporalGraph(log_port, device="cpu"),
                             device="cpu"), prog, q)):
        job = mgr.submit(p, qq)
        assert job.wait(300) and job.status == "done", job.error
        rows.append(mgr.results(job.id))
    return rows


def _same_rows(got, want, n_rows):
    assert len(got) == len(want) == n_rows
    for g, w in zip(got, want):
        for key in ("time", "windowsize", "steps", "result"):
            assert g[key] == w[key], (key, g, w)


def test_lpa_view_and_range_jobs_match_reference():
    """An LPA View job (cold route: ``build_view`` + ``bsp.run``) and a
    Range job (hop by hop over a ``SweepBuilder``), windowed, row for
    row."""
    jlog = ldbc_like_log(n_persons=300, n_knows=2_000, t_span=1_000)
    log = event_log_from_arrays(jlog.arrays())
    jprog = JLPA(max_steps=15)
    prog = program_from_params("LabelPropagation",
                               **dataclasses.asdict(jprog))
    want, got = _jobs(log, jlog, prog, jprog,
                      ViewQuery(timestamp=900, windows=(1_000, 300, 100)),
                      JViewQuery(timestamp=900, windows=(1_000, 300, 100)))
    _same_rows(got, want, 3)
    assert got[0]["result"]["communities"] >= 1
    want, got = _jobs(log, jlog, prog, jprog,
                      RangeQuery(start=400, end=1_000, jump=150,
                                 windows=(1_000, 200)),
                      JRangeQuery(start=400, end=1_000, jump=150,
                                  windows=(1_000, 200)))
    _same_rows(got, want, 5 * 2)


def test_lpa_jobs_take_the_cold_route():
    """LabelPropagation is not ``reduce_shell_safe`` (nor is the
    reference's): a View job never touches the resident sweep, and a Range
    job never builds a DeviceSweep."""
    log = event_log_from_arrays(ldbc_like_log(n_persons=100, n_knows=500,
                                              t_span=100).arrays())
    g = TemporalGraph(log, device="cpu")
    mgr = AnalysisManager(g, device="cpu")
    assert not LabelPropagation.reduce_shell_safe
    job = mgr.submit(LabelPropagation(max_steps=5), ViewQuery(timestamp=90))
    assert job.wait(120) and job.status == "done", job.error
    assert g._resident is None
    job = mgr.submit(LabelPropagation(max_steps=5),
                     RangeQuery(start=50, end=90, jump=20))
    assert job.wait(120) and job.status == "done", job.error
    assert g._resident is None and len(mgr.results(job.id)) == 3


def test_custom_combiner_rejects_direction_both():
    class Bad(LabelPropagation):
        direction = "both"

    class JBad(JLPA):
        direction = "both"

    jlog, log = _lpa_logs(5)
    with pytest.raises(ValueError, match="custom"):
        jbsp.run(JBad(), jbuild_view(jlog, 90))
    with pytest.raises(ValueError, match="custom"):
        bsp.run(Bad(), build_view(log, 90), device="cpu")
    with pytest.raises(ValueError, match="custom"):
        tds.DeviceSweep(log, device="cpu").run(Bad(), 90)


def test_lpa_reduce_shape():
    jlog, log = _lpa_logs(6)
    view = build_view(log, 90)
    prog = LabelPropagation(max_steps=8)
    got, _ = bsp.run(prog, view, device="cpu")
    out = prog.reduce(got.numpy(), view)
    jgot, _ = jbsp.run(JLPA(max_steps=8), jbuild_view(jlog, 90))
    assert out == JLPA(max_steps=8).reduce(np.asarray(jgot),
                                           jbuild_view(jlog, 90))
    assert out["vertices"] > 0 and out["communities"] >= 1
    assert sum(out["top5"]) <= out["vertices"]
    assert set(out) == {"vertices", "communities", "biggest", "top5"}
    win = prog.reduce(bsp.run(prog, view, window=20, device="cpu")[0]
                      .numpy(), view, window=20)
    assert win["vertices"] <= out["vertices"]
