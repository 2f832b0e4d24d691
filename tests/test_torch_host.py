"""The port's host layers against the JAX package's, bitwise: snapshot
folds, the incremental sweep's per-hop deltas, the global engine tables and
the synthetic generators — fed from the same numpy arrays."""

import numpy as np
import pytest
from test_sweep import VIEW_FIELDS, random_log

from raphtory_tpu.core.snapshot import build_view as j_build_view
from raphtory_tpu.core.sweep import SweepBuilder as JSweepBuilder
from raphtory_tpu.engine.device_sweep import GlobalTables as JGlobalTables
from raphtory_tpu.utils import synth as jsynth
from raphtory_tpu_torch.core.snapshot import build_view
from raphtory_tpu_torch.core.sweep import SweepBuilder
from raphtory_tpu_torch.engine.device_sweep import GlobalTables
from raphtory_tpu_torch.interop import event_log_from_arrays
from raphtory_tpu_torch.utils import synth

FOLD_STATE = ("v_lat", "v_alive", "v_first", "e_enc", "e_lat", "e_alive",
              "e_first")


def carried(jlog, with_props=False):
    """The port's log from a JAX log's arrays (and its property rows)."""
    props = None
    if with_props:
        p = jlog.props
        rows = {}
        for ev, kid, tag, num, sref in zip(
                *(p.column(c) for c in ("event", "key", "tag", "num",
                                        "sref"))):
            name = p.key_name(int(kid))
            if p.is_immutable(int(kid)):
                name = "!" + name
            rows.setdefault(int(ev), {})[name] = (
                p.string(int(sref)) if tag == p.STR_TAG else float(num))
        props = sorted(rows.items())
    return event_log_from_arrays(jlog.arrays(), props=props)


def _logs():
    out = [(f"random{s}", random_log(np.random.default_rng(s), n_events=500,
                                     n_ids=25, t_span=60))
           for s in range(4)]
    out.append(("gab", jsynth.gab_like_log(2_000, 12_000, t_span=10_000)))
    return out


LOGS = _logs()


def assert_views_equal(got, want):
    for f in VIEW_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, (int, np.integer)):
            assert g == w, f"{f}: {g} != {w}"
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"field {f}")
            assert g.dtype == w.dtype, f


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_build_view_bitwise(seed):
    rng = np.random.default_rng(seed)
    jlog = random_log(rng, props=True)
    log = carried(jlog, with_props=True)
    for T in sorted(rng.choice(55, size=6, replace=False).tolist()):
        got, want = build_view(log, int(T)), j_build_view(jlog, int(T))
        assert_views_equal(got, want)
        for name in ("w", "kind"):
            np.testing.assert_array_equal(got.vertex_prop(name),
                                          want.vertex_prop(name))
            np.testing.assert_array_equal(got.edge_prop(name),
                                          want.edge_prop(name))


@pytest.mark.parametrize("seed", [0, 1])
def test_sweep_view_at_matches_jax_build_view(seed):
    rng = np.random.default_rng(seed)
    jlog = random_log(rng)
    sweep = SweepBuilder(carried(jlog))
    for T in sorted(rng.choice(55, size=8, replace=False).tolist()):
        assert_views_equal(sweep.view_at(int(T)), j_build_view(jlog, int(T)))


@pytest.mark.parametrize("name,jlog", LOGS, ids=[n for n, _ in LOGS])
@pytest.mark.parametrize("preseed", [False, True])
def test_sweep_deltas_bitwise(name, jlog, preseed):
    """Fold state and ``last_delta`` after every hop — deletes, revivals
    and tombstone joins included."""
    t_max = int(jlog.column("time").max())
    hops = sorted({int(x) for x in np.linspace(0, t_max, 9)})
    js = JSweepBuilder(jlog, track_rows=False, preseed_pairs=preseed)
    ts = SweepBuilder(carried(jlog), track_rows=False, preseed_pairs=preseed)
    for T in hops:
        js._advance(T)
        ts._advance(T)
        assert ts.t_prev == js.t_prev
        for f in FOLD_STATE:
            np.testing.assert_array_equal(getattr(ts, f), getattr(js, f),
                                          err_msg=f"{f} at T={T}")
        assert set(ts.last_delta) == set(js.last_delta)
        for k, v in js.last_delta.items():
            np.testing.assert_array_equal(ts.last_delta[k], v,
                                          err_msg=f"last_delta[{k}] at {T}")
            assert ts.last_delta[k].dtype == v.dtype


@pytest.mark.parametrize("name,jlog", LOGS, ids=[n for n, _ in LOGS])
def test_global_tables_bitwise(name, jlog):
    jt = JGlobalTables(JSweepBuilder(jlog, track_rows=False,
                                     preseed_pairs=True))
    t = GlobalTables(SweepBuilder(carried(jlog), track_rows=False,
                                  preseed_pairs=True))
    assert (t.n, t.m, t.n_pad, t.m_pad) == (jt.n, jt.m, jt.n_pad, jt.m_pad)
    assert t.tdtype == jt.tdtype and t.tmin == jt.tmin
    for f in ("uv", "all_enc", "eng_of_rank", "e_src", "e_dst", "vids"):
        np.testing.assert_array_equal(getattr(t, f), getattr(jt, f),
                                      err_msg=f)
        assert getattr(t, f).dtype == getattr(jt, f).dtype, f
    # the destination CSR: row d owns exactly the real edges with
    # e_dst == d; the pad edges lie past its end
    assert t.in_indptr[0] == 0 and t.in_indptr[-1] == t.m
    rows = np.repeat(np.arange(t.n_pad), np.diff(t.in_indptr))
    np.testing.assert_array_equal(rows, t.e_dst[: t.m])
    np.testing.assert_array_equal(t.eng_pos(t.all_enc), jt.eng_pos(jt.all_enc))


def test_time_dtype_widens_past_int32():
    """Times outside the int32 half-range keep the int64 resident dtype in
    both packages (the K1 kernel's second instantiation)."""
    jlog = random_log(np.random.default_rng(5))
    cols = jlog.arrays()
    cols = dict(cols, time=cols["time"] + (1 << 40))
    from raphtory_tpu.core.events import EventLog as JEventLog

    jwide = JEventLog()
    jwide.append_batch(cols["time"], cols["kind"], cols["src"], cols["dst"])
    t = GlobalTables(SweepBuilder(event_log_from_arrays(cols),
                                  track_rows=False, preseed_pairs=True))
    jt = JGlobalTables(JSweepBuilder(jwide, track_rows=False,
                                     preseed_pairs=True))
    assert t.tdtype == jt.tdtype == np.int64


def test_synth_generators_bitwise():
    for got, want in zip(synth.gab_like_arrays(500, 4_000, seed=3),
                         jsynth.gab_like_arrays(500, 4_000, seed=3)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(
            synth.random_update_stream(3_000, id_pool=100, seed=4,
                                       mix=(0.3, 0.4, 0.1, 0.2)),
            jsynth.random_update_stream(3_000, id_pool=100, seed=4,
                                        mix=(0.3, 0.4, 0.1, 0.2))):
        np.testing.assert_array_equal(got, want)
    for k, v in jsynth.gab_like_log(300, 2_000).arrays().items():
        np.testing.assert_array_equal(synth.gab_like_log(300, 2_000)
                                      .arrays()[k], v)
