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

import ctypes
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
from raphtory_tpu_torch.ops import columns, segment


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


def _view(addr, dtype, n):
    """``n`` elements of ``dtype`` at a host address, as numpy."""
    if not n:
        return np.zeros(0, dtype)
    nbytes = n * np.dtype(dtype).itemsize
    return np.ctypeslib.as_array((ctypes.c_uint8 * nbytes).from_address(
        addr)).view(dtype)


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


# K7-mode's inbox lengths at the kernel's edges: empty, one, the widths of
# lane groups of 8 and 16 around them, a warp (31 / 32 / 33: the last short
# run and the first long one), and the long runs sorted in shared memory
# (4,096) or in the call's scratch (4,097)
EDGE_RUNS = [0, 1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 4096, 4097]


def _edge_inboxes(rng, k, permuted, runs=EDGE_RUNS, copies=3):
    """(values, ids, SegmentCSR, mask) over rows of every length in
    ``runs`` (each ``copies`` times, rows shuffled) plus pad rows (outside
    the CSR: masked, and negative so that they carry no message without
    the mask either): values with ties, masked and negative rows; the
    source-style CSR through a permutation when ``permuted``."""
    lens = rng.permutation(np.repeat(runs, copies))
    n, m_real = len(lens), int(lens.sum())
    m = m_real + 5                                  # pad rows, masked
    ids = np.concatenate([np.repeat(np.arange(n), lens),
                          np.full(m - m_real, n - 1)]).astype(np.int32)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    perm = None
    if permuted:
        perm = rng.permutation(m_real).astype(np.int32)
        pid = np.full(m, n - 1, np.int32)
        pid[perm] = ids[:m_real]
        ids = pid
    vals = rng.integers(0, 6, k * m).astype(np.int32)
    vals[rng.random(k * m) < 0.05] = -3
    vals.reshape(k, m)[:, m_real:] = -1     # no message even unmasked
    mask = rng.random(k * m) < 0.85
    mask.reshape(k, m)[:, m_real:] = False
    csr = segment.SegmentCSR(torch.from_numpy(ids), torch.from_numpy(indptr),
                             None if perm is None else torch.from_numpy(perm))
    return vals, ids, csr, mask


@pytest.mark.parametrize("permuted", [False, True], ids=["dst", "src"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_segment_mode_edge_runs_match_jax(k, permuted):
    """The twin against the JAX ``segment_mode`` (and the plain walk of the
    kernel's pick) on inboxes of every length in ``EDGE_RUNS``, k windows,
    both CSR forms."""
    rng = np.random.default_rng(10 * k + permuted)
    vals, ids, csr, mask = _edge_inboxes(rng, k, permuted)
    got, want = _both(vals, ids, csr.n, mask, -1, k, csr)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _kernel_walk(vals, csr, k, mask, -1))


#: the C entry's launch groups: at most this many windows a launch
MODE_GRID_ROWS = 65_535


def _model_mode(calls):
    """``rtpu_segment_mode`` as numpy over the wrapper's raw host addresses,
    step by step as the C entry and the kernel take it: the k windows in
    launches of at most 65,535 (counted in ``launched``), each launch's
    windows side by side; the listed long rows by a sort and a count; the
    short rows a warp of 32 lanes 16 rows at a time — their runs packed end
    to end over the lanes (long rows taking none, empty rows ``dflt`` at
    once), a round per fill of the lanes, each lane's row found by binary
    lifting over the running sums, its value counted among equal values of
    its row's lanes, and the shuffle-down max bounded by the row's last
    lane. Refuses a long-row list that is not exactly the runs past 32
    entries, and a missing scratch where a run exceeds 4,096."""
    def model(k, n, m, dflt, nl, indptr, perm, x, mask, long_rows, scratch,
              out, stream, launched):
        groups = [np.arange(y0, min(k, y0 + MODE_GRID_ROWS))
                  for y0 in range(0, k, MODE_GRID_ROWS)]
        calls.append(dict(nl=nl, mask=mask, scratch=scratch,
                          launches=len(groups)))
        ip = _view(indptr, np.int64, n + 1)
        lens = np.diff(ip)
        pm = None if perm is None else _view(perm, np.int32, int(ip[-1]))
        xs = _view(x, np.int32, k * m)
        mk = None if mask is None else _view(mask, np.uint8, k * m)
        lr = _view(long_rows, np.int32, nl)
        assert lr.tolist() == np.flatnonzero(lens > 32).tolist()
        assert scratch is not None or lens.max(initial=0) <= 4096
        o = _view(out, np.int32, k * n).reshape(k, n)
        lane = np.arange(32)

        def entries(ws, j):
            """The values of entries ``j`` (an int array) in windows
            ``ws``: ``[len(ws), len(j)]``, -1 where masked or negative."""
            e = ws[:, None] * m + (j if pm is None
                                   else pm[j].astype(np.int64))[None, :]
            v = xs[e]
            on = v >= 0 if mk is None else (mk[e] != 0) & (v >= 0)
            return np.where(on, v, -1).astype(np.int64)

        def key(v, c):
            return np.where(v < 0, 0, (c << 32) | (0x7FFFFFFF - v))

        def value(kk):
            return np.where(kk != 0, 0x7FFFFFFF - (kk & 0xFFFFFFFF), dflt)

        for ws in groups:
            launched._obj.value += 1
            for r in lr:
                vs = entries(ws, np.arange(ip[r], ip[r + 1]))
                for i, w in enumerate(ws):
                    v = vs[i][vs[i] >= 0]
                    u, c = np.unique(v, return_counts=True)
                    o[w, r] = value(max(
                        (int(key(np.int64(a), np.int64(b)))
                         for a, b in zip(u, c)), default=0))
            for r0 in range(0, n, 16):
                a = np.zeros(32, np.int64)
                eff = np.zeros(32, np.int64)
                for l in range(16):
                    if r0 + l < n:
                        a[l] = ip[r0 + l]
                        if lens[r0 + l] == 0:
                            o[ws, r0 + l] = dflt
                        eff[l] = lens[r0 + l] if lens[r0 + l] <= 32 else 0
                P = np.cumsum(eff)
                total = int(P[31])
                Pk = np.where(lane < 16, P, 2**31 - 1)
                base = 0
                while base < total:
                    q = base + lane
                    i = np.zeros(32, np.int64)
                    for s in (16, 8, 4, 2, 1):
                        i = np.where(Pk[i + s - 1] <= q, i + s, i)
                    Pi, Li, ai = Pk[i], eff[i], a[i]
                    inn = (q < total) & (Pi <= base + 32)
                    start = np.where(inn, Pi - Li - base, lane)
                    end = np.where(inn, Pi - base, lane + 1)
                    j = np.where(inn, ai + q - (Pi - Li), 0)
                    v = np.where(inn[None, :], entries(ws, j), -1)
                    cnt = np.stack([(v[:, start[l]:end[l]]
                                     == v[:, l:l + 1]).sum(1)
                                    for l in range(32)], 1)
                    keys = key(v, cnt)
                    for off in (1, 2, 4, 8, 16):
                        nxt = keys.copy()
                        for l in range(32):
                            if l + off < end[l]:
                                nxt[:, l] = np.maximum(keys[:, l],
                                                       keys[:, l + off])
                        keys = nxt
                    for l in range(32):
                        if inn[l] and l == start[l]:
                            o[ws, r0 + i[l]] = value(keys[:, l])
                    base = int(max(P[l] for l in range(16)
                                   if P[l] <= base + 32))
        return 0
    return model


@pytest.fixture
def mode_card(monkeypatch):
    """K7-mode's card branch on CPU tensors through the numpy model, with
    a fresh signature cache."""
    calls = []
    monkeypatch.setattr(segment, "_on_cuda", lambda name, *ts: True)
    monkeypatch.setattr(columns, "_on_cuda", lambda name, *ts: True)
    monkeypatch.setattr(segment, "_stream", lambda t: 0)
    monkeypatch.setattr(segment, "_fn", lambda lib, fn: _model_mode(calls))
    monkeypatch.setattr(columns, "_K2_SIGS", {})
    columns.reset_launches()
    yield calls
    columns.reset_launches()


@pytest.mark.parametrize("permuted", [False, True], ids=["dst", "src"])
@pytest.mark.parametrize("k", [1, 3])
def test_segment_mode_card_branch_packs_short_rows(mode_card, k, permuted):
    """The card branch through the model of the kernel's steps on every
    ``EDGE_RUNS`` length (rows of 4,097 entries: the scratch allocated) and
    on short rows only (no long row, no scratch, no mask): the twin's modes
    bit for bit, one launch a call."""
    rng = np.random.default_rng(3 + k + permuted)
    for runs, copies in ((EDGE_RUNS, 2), (list(range(0, 33)), 3)):
        vals, ids, csr, mask = _edge_inboxes(rng, k, permuted, runs, copies)
        v = torch.from_numpy(vals)
        for mk in (torch.from_numpy(mask), None):
            want = segment.segment_mode_plain(v, csr, k * csr.n, mk, -1, k)
            got = segment.segment_mode(v, csr, k * csr.n, mk, -1, k)
            assert torch.equal(got, want)
            long = max(runs) > 4096
            assert (mode_card[-1]["scratch"] is not None) == long
            assert (mode_card[-1]["mask"] is None) == (mk is None)
    assert columns.LAUNCHES["segment_mode"] == len(mode_card) == 4


def test_segment_mode_lists_long_rows_again_after_an_in_place_change(
        mode_card):
    """The long-row list is derived once per CSR signature: a second call
    with the same CSR reuses it, and a CSR changed in place (a short row
    made long) is checked and listed again; a CSR that is not one
    raises."""
    rng = np.random.default_rng(1)
    vals, ids, csr, mask = _edge_inboxes(rng, 2, False, [3, 40, 10], 4)
    v, mk = torch.from_numpy(vals), torch.from_numpy(mask)
    plans = []
    mode_plan = segment.mode_plan
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(segment, "mode_plan", lambda seg, m: plans.append(
            seg) or mode_plan(seg, m))
        for _ in range(2):
            got = segment.segment_mode(v, csr, 2 * csr.n, mk, -1, 2)
        assert len(plans) == 1
        # a long row and its short neighbour swap lengths in place: the
        # CSR's version changes, and so does its long-row list
        ip = csr.indptr
        lens = np.diff(ip.numpy())
        r = int(np.flatnonzero((lens[:-1] > 32) != (lens[1:] > 32))[0])
        ip[r + 1] = ip[r] + int(lens[r + 1])
        ids = np.repeat(np.arange(csr.n), np.diff(ip.numpy()))
        csr.ids[: len(ids)] = torch.from_numpy(ids.astype(np.int32))
        got = segment.segment_mode(v, csr, 2 * csr.n, mk, -1, 2)
        assert len(plans) == 2
    want = segment.segment_mode_plain(v, csr, 2 * csr.n, mk, -1, 2)
    assert torch.equal(got, want)
    bad = segment.SegmentCSR(csr.ids, csr.indptr.flip(0).contiguous(), None)
    with pytest.raises(ValueError, match="not a CSR"):
        segment.segment_mode(v, bad, 2 * csr.n, mk, -1, 2)


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
