"""The port's bulk loader (``raphtory_tpu_torch/core/bulk.py``) and its
stable radix argsort against the JAX package's on the same numpy arrays,
bitwise: the ``BulkGraph`` tables, the ``bulk_hop_columns`` columns, the
``bulk_hop_deltas`` base and update lists, the validation errors; and the
destination CSR the port adds, which ends at the m real edges."""

import numpy as np
import pytest

from raphtory_tpu.core import bulk as jbulk
from raphtory_tpu.native import lib as jnative
from raphtory_tpu_torch.core import bulk as tbulk
from raphtory_tpu_torch.native import lib as tnative


def _stream(seed, n_events=2000, n_ids=50, t_span=300):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_ids, n_events).astype(np.int64)
    dst = rng.integers(0, n_ids, n_events).astype(np.int64)
    times = np.sort(rng.integers(0, t_span, n_events)).astype(np.int64)
    return src, dst, times


#: (seed, n_events, n_ids, hop times, n_vertices); the last case pads past
#: 2^16 pairs (the 2^16-multiple buckets of ``_pad_large``)
CASES = [(0, 2000, 50, [60, 150, 151, 299], None),
         (7, 2000, 50, [0, 299], 80),
         (3, 1, 5, [10], None),
         (5, 90_000, 2_000, [100, 200, 299], None)]


def _tables_equal(j, t):
    for f in ("n", "m", "n_pad", "m_pad", "tmin"):
        assert getattr(j, f) == getattr(t, f), f
    assert j.tdtype == t.tdtype
    for f in ("uv", "eng_of_rank", "e_src", "e_dst"):
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c[0]}")
def test_bulk_hop_columns_match_reference(case):
    seed, n_events, n_ids, hops, n_v = case
    src, dst, times = _stream(seed, n_events, n_ids)
    want = jbulk.bulk_hop_columns(src, dst, times, hops, n_vertices=n_v)
    got = tbulk.bulk_hop_columns(src, dst, times, hops, n_vertices=n_v)
    _tables_equal(want[0], got[0])
    for w, g in zip(want[1:], got[1:]):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(w, g)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c[0]}")
def test_bulk_hop_deltas_match_reference(case):
    seed, n_events, n_ids, hops, n_v = case
    src, dst, times = _stream(seed, n_events, n_ids)
    want = jbulk.bulk_hop_deltas(src, dst, times, hops, n_vertices=n_v)
    got = tbulk.bulk_hop_deltas(src, dst, times, hops, n_vertices=n_v)
    _tables_equal(want[0], got[0])
    for w, g in zip(want[1:3], got[1:3]):            # the base rows
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(w, g)
    for wd, gd in zip(want[3:], got[3:]):            # edge, vertex deltas
        assert len(wd) == len(gd) == len(hops)
        for (wp, wt), (gp, gt) in zip(wd, gd):
            assert wp.dtype == gp.dtype and wt.dtype == gt.dtype
            np.testing.assert_array_equal(wp, gp)
            np.testing.assert_array_equal(wt, gt)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c[0]}")
def test_in_indptr_ends_at_the_real_edges(case):
    """Row d of the destination CSR owns the real edges with dst d; the
    pad edges (dst = src = n_pad-1) lie past ``in_indptr[n_pad] = m``."""
    seed, n_events, n_ids, hops, n_v = case
    bulk = tbulk.bulk_hop_columns(*_stream(seed, n_events, n_ids), hops,
                                  n_vertices=n_v)[0]
    ip = bulk.in_indptr
    assert ip.dtype == np.int64 and ip.shape == (bulk.n_pad + 1,)
    assert ip[0] == 0 and ip[-1] == bulk.m and np.all(np.diff(ip) >= 0)
    rows = np.repeat(np.arange(bulk.n_pad), np.diff(ip))
    np.testing.assert_array_equal(rows, bulk.e_dst[: bulk.m])
    assert np.all(bulk.e_dst[bulk.m:] == bulk.n_pad - 1)
    assert np.all(bulk.e_src[bulk.m:] == bulk.n_pad - 1)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_radix_argsort_matches_numpy_stable(native, monkeypatch):
    if not native:
        monkeypatch.setattr(tnative, "_load", lambda: None)
    else:
        assert tnative.available()
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 2**63, 70_000, dtype=np.uint64)
    keys[::7] = keys[3]                       # ties among random keys
    dup = rng.integers(0, 7, 20_000).astype(np.uint64) << np.uint64(32)
    for k in (keys, dup, np.zeros(0, np.uint64), keys[:1]):
        got = tnative.radix_argsort_u64(k)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, np.argsort(k, kind="stable"))
        np.testing.assert_array_equal(got, jnative.radix_argsort_u64(k))


@pytest.mark.parametrize("bad, match", [
    (lambda s, d, t: (s, d, t, [50, 10], None), "ascend"),
    (lambda s, d, t: (s, d, t[::-1].copy(), [50], None), "time-sorted"),
    (lambda s, d, t: (s - 5, d, t, [50], None), "dense ids"),
    (lambda s, d, t: (s, d, t - 1000, [50], None), r"\[0, 2\^31\)"),
    (lambda s, d, t: (s, d, t, [50], 10), ">= n_vertices"),
], ids=["hops", "unsorted", "negative-id", "negative-time", "n_vertices"])
@pytest.mark.parametrize("loader", ["bulk_hop_columns", "bulk_hop_deltas"])
def test_bulk_loader_input_validation(loader, bad, match):
    src, dst, times, hops, n_v = bad(*_stream(1, n_events=100))
    for mod in (jbulk, tbulk):
        with pytest.raises(ValueError, match=match):
            getattr(mod, loader)(src, dst, times, hops, n_vertices=n_v)
