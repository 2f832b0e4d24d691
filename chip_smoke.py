#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``raphtory_tpu_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvidia-smi`` and the CUDA toolkit (``nvcc``); builds
the kernels from ``raphtory_tpu_torch/csrc`` on first use. Phases, each
printing one JSON line:

1. device   — card name and power limit (nvidia-smi).
2. build    — nvcc build of every kernel library, one process per source.
3. kernels  — each kernel against its plain PyTorch twin on the card, at
              the headline's shapes: K1 and K2a bitwise; K2b, and K2c's
              ranks, pull-sum input and dangling mass, within rtol 1e-5 /
              atol 1e-7; K2c's halting flags exact. CUDA-event times,
              bounds, twin times.
4. headline — the north-star windowed PageRank Range query (GAB-like log,
              30k vertices / 300k edge events, 12 hops x 3 windows,
              chunks=3, warm start, tol 1e-7, 20 supersteps) through
              ``HopBatchedPageRank`` on the card, held against the same
              port run on the CPU (plain twins): rtol 1e-5 / atol 1e-7 and
              equal steps; every column's ranks sum to 1 +- 1e-4.
5. job      — ``TemporalGraph`` + ``AnalysisManager`` PageRank Range job.
6. scale    — the same engine on a 5.3M-vertex / 2^25-edge-event log,
              4 hops x 3 windows, chunks=2.

Then one line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device":
...}``. Exits non-zero, with no result line, when any phase fails or no
card is present. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
GAB_SPAN = 2_600_000
WINDOWS = [2_600_000, 604_800, 86_400]   # month / week / day


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def bound(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    """Least time the card could take: bytes over HBM bandwidth or ops over
    the f32 rate, whichever is larger (ms, and which one)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(torch, fn, iters: int = 20) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``iters`` calls,
    CUDA events around the batch, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def headline_grid():
    import numpy as np

    hops = [int(T) for T in
            np.linspace(0.45 * GAB_SPAN, GAB_SPAN, 12).astype(np.int64)]
    return hops, WINDOWS


def phase_kernels(torch, np, columns, tables, dev):
    """Each kernel against its twin on the same card tensors."""
    rng = np.random.default_rng(0)
    n_pad, m_pad = tables.n_pad, tables.m_pad
    H, W = 4, 3                     # one headline chunk: 4 hops x 3 windows
    C = H * W
    out = {}

    # ---- K1: int32 and int64 times near the dtype bounds, pad rows, h0
    k1_ms = k1_plain = k1_bytes = None
    k1_err = 0.0
    for tdt in (np.int32, np.int64):
        info = np.iinfo(tdt)
        edge = np.array([info.min, info.min + 1, info.max - 1, info.max],
                        np.int64)
        for h0 in (False, True):
            for length in (m_pad, n_pad):
                if tdt == np.int32:
                    T = np.array([info.max - 3, 0, info.min + 3, 1000],
                                 np.int64)
                    w = np.array([-1, 0, 1 << 40, 5], np.int64)
                else:
                    T = np.array([1 << 61, 0, -(1 << 61), 1000], np.int64)
                    w = np.array([-1, 0, 1 << 40, 5], np.int64)
                T_col = np.repeat(T, W)
                w_col = np.tile(w[:W], H)
                lo = np.clip(T_col - w_col, info.min, info.max).astype(tdt)
                base_lat = rng.choice(
                    np.concatenate([edge, rng.integers(-5000, 5000, 60)]),
                    length).astype(tdt)
                base_alive = rng.random(length) < 0.7
                U = 16384
                pos = np.full((H, U), 2**31 - 1, np.int32)
                lat = np.zeros((H, U), tdt)
                alive = np.zeros((H, U), bool)
                for h in range(H):
                    k = int(rng.integers(U // 4, U))
                    pos[h, :k] = rng.choice(length, k, replace=False)
                    lat[h, :k] = rng.choice(edge, k).astype(tdt)
                    alive[h, :k] = rng.random(k) < 0.5
                args = [torch.from_numpy(a).to(dev) for a in
                        (base_lat, base_alive, pos, lat, alive, lo,
                         w_col < 0)]
                got = columns.masks_from_deltas(*args, H, W, h0)
                want = columns.masks_from_deltas_plain(*args, H, W, h0)
                for g, x in zip(got, want):
                    k1_err = max(k1_err, float(
                        (g.double() - x.double()).abs().max()))
                    if not torch.equal(g, x):
                        raise AssertionError(
                            f"K1 differs from its twin (tdt={tdt.__name__},"
                            f" h0={h0}, len={length})")
                if tdt == np.int32 and h0 and length == m_pad:
                    k1_ms = cuda_ms(torch, lambda: columns.masks_from_deltas(
                        *args, H, W, h0))
                    k1_plain = cuda_ms(
                        torch, lambda: columns.masks_from_deltas_plain(
                            *args, H, W, h0), iters=3)
                    valid = int((pos < length).sum())
                    k1_bytes = (length * 5            # base lat i32 + alive
                                + valid * (4 + 4 + 1)  # live delta rows
                                + C * 5                # lo + nowin
                                + length * C           # mask out
                                + length * 5)          # advanced base out
    out["masks_from_deltas"] = dict(
        source="raphtory_tpu_torch/csrc/masks.cu",
        replaces="raphtory_tpu/engine/hopbatch.py:66",
        max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain, library_ms=None,
        shape=f"edges len={m_pad} H={H} W={W} U=16384 int32 h0",
        **dict(zip(("bound_ms", "bound_by"), bound(k1_bytes))))

    # ---- K2: the headline's real (dst, src)-sorted edge tables
    e_src, e_dst, indptr = (torch.from_numpy(a).to(dev) for a in
                            (tables.e_src, tables.e_dst, tables.in_indptr))
    me_np = rng.random((m_pad, C)) < 0.6
    me_np[:, 0] = False                     # an all-masked column
    me_np[tables.m:] = False                # pad edges carry no mask
    me = torch.from_numpy(me_np).to(dev)
    deg = columns.column_out_degree(me, e_src, n_pad)
    want = columns.column_out_degree_plain(me, e_src, n_pad)
    a_err = float((deg - want).abs().max())
    if not torch.equal(deg, want):
        raise AssertionError(f"K2a differs from its twin: max abs err "
                             f"{a_err}")
    mef = me.to(torch.float32)
    a_ms = cuda_ms(torch, lambda: columns.column_out_degree(me, e_src, n_pad))
    a_plain = cuda_ms(torch, lambda: columns.column_out_degree_plain(
        me, e_src, n_pad))
    a_lib = cuda_ms(torch, lambda: torch.zeros(
        (n_pad, C), dtype=torch.float32, device=dev).index_add_(0, e_src, mef))
    out["column_out_degree"] = dict(
        source="raphtory_tpu_torch/csrc/pagerank_columns.cu",
        replaces="raphtory_tpu/engine/hopbatch.py:154",
        max_abs_err=a_err, ms=a_ms, plain_ms=a_plain, library_ms=a_lib,
        shape=f"m_pad={m_pad} n_pad={n_pad} C={C}",
        **dict(zip(("bound_ms", "bound_by"),
                   bound(m_pad * C + m_pad * 4 + n_pad * C * 4))))

    rd = torch.from_numpy(
        (rng.random((n_pad, C)) * 1e-4).astype(np.float32)).to(dev)
    got = columns.column_pull_sum(me, rd, e_src, e_dst, indptr)
    want = columns.column_pull_sum_plain(me, rd, e_src, e_dst)
    err = (got - want).abs()
    if bool((err > 1e-7 + 1e-5 * want.abs()).any()):
        raise AssertionError(f"K2b differs from its twin: max abs err "
                             f"{float(err.max())}")
    b_ms = cuda_ms(torch, lambda: columns.column_pull_sum(
        me, rd, e_src, e_dst, indptr))
    b_plain = cuda_ms(torch, lambda: columns.column_pull_sum_plain(
        me, rd, e_src, e_dst))
    # the kernel walks the m real edges of the CSR (the pads lie past it)
    m = tables.m
    out["column_pull_sum"] = dict(
        source="raphtory_tpu_torch/csrc/pagerank_columns.cu",
        replaces="raphtory_tpu/engine/hopbatch.py:154",
        max_abs_err=float(err.max()), ms=b_ms, plain_ms=b_plain,
        library_ms=None, shape=f"m_pad={m_pad} n_pad={n_pad} C={C}",
        **dict(zip(("bound_ms", "bound_by"),
                   bound(m * C + m * 4 + (n_pad + 1) * 8
                         + 2 * n_pad * C * 4, int(me_np.sum())))))

    # ---- K2c: the superstep update, on the real out-degrees; column 1
    # has no alive vertex (halts at once), column 2 is already frozen; a
    # second case has every live column frozen (the all-halted flag)
    mv = torch.from_numpy(rng.random((n_pad, C)) < 0.8).to(dev)
    mv[:, 1] = False
    mv[tables.n:] = False
    n_act = torch.clamp(mv.to(torch.float32).sum(0), min=1.0)
    r0 = torch.from_numpy(rng.random((n_pad, C)).astype(np.float32)).to(dev)
    r0 = torch.where(mv, r0, 0.0)
    r0 = (r0 / r0.sum(0).clamp(min=1e-30)).contiguous()
    agg = columns.column_pull_sum(me, r0 / deg.clamp(min=1.0), e_src, e_dst,
                                  indptr)
    c_err = 0.0
    for frozen in ([2], [c for c in range(C) if c != 1]):
        pair = []
        for update in (columns.pagerank_update,
                       columns.pagerank_update_plain):
            st = columns.rank_state(r0.clone())
            update(st, None, deg, mv, n_act, 0.85, 1e-7, prime=True)
            primed = (st.rd.clone(), st.dangling.clone())
            st.halted[frozen] = True
            update(st, agg, deg, mv, n_act, 0.85, 1e-7)
            pair.append((primed, st))
        (p_got, got), (p_want, want) = pair
        for g, x, what in ((p_got[0], p_want[0], "primed rd"),
                           (p_got[1], p_want[1], "primed dangling"),
                           (got.r, want.r, "r"), (got.rd, want.rd, "rd"),
                           (got.dangling, want.dangling, "dangling")):
            err = (g - x).abs()
            c_err = max(c_err, float(err.max()))
            if bool((err > 1e-7 + 1e-5 * x.abs()).any()):
                raise AssertionError(f"K2c {what} differs from its twin: max "
                                     f"abs err {float(err.max())}")
        if not (torch.equal(got.halted, want.halted)
                and torch.equal(got.done, want.done)):
            raise AssertionError(f"K2c halting differs from its twin: "
                                 f"{got.halted.tolist()} {got.done.item()} "
                                 f"vs {want.halted.tolist()} "
                                 f"{want.done.item()}")
        if frozen != [2] and not bool(got.done):
            raise AssertionError("K2c: every column halted, flag unset")
    st_k = columns.rank_state(r0.clone())
    columns.pagerank_update(st_k, None, deg, mv, n_act, 0.85, 1e-7,
                            prime=True)
    st_p = columns.rank_state(r0.clone())
    columns.pagerank_update_plain(st_p, None, deg, mv, n_act, 0.85, 1e-7,
                                  prime=True)
    c_ms = cuda_ms(torch, lambda: columns.pagerank_update(
        st_k, agg, deg, mv, n_act, 0.85, 1e-7))
    c_plain = cuda_ms(torch, lambda: columns.pagerank_update_plain(
        st_p, agg, deg, mv, n_act, 0.85, 1e-7))
    out["pagerank_update"] = dict(
        source="raphtory_tpu_torch/csrc/pagerank_columns.cu",
        replaces="raphtory_tpu/engine/hopbatch.py:259",
        max_abs_err=c_err, ms=c_ms, plain_ms=c_plain, library_ms=None,
        shape=f"n_pad={n_pad} C={C}",
        # reads agg, deg, r (f32) and mv (bool); writes r and rd (f32);
        # ~10 f32 operations per (v, c)
        **dict(zip(("bound_ms", "bound_by"),
                   bound(n_pad * C * (4 * 3 + 1 + 4 * 2),
                         10 * n_pad * C))))
    emit("kernels", kernels={k: {kk: vv for kk, vv in v.items()
                                 if kk in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "max_abs_err",
                                           "shape")}
                             for k, v in out.items()})
    return out


def phase_headline(torch, np, columns, HopBatchedPageRank, log, dev):
    hops, windows = headline_grid()
    n_views = len(hops) * len(windows)
    kw = dict(tol=1e-7, max_steps=20)
    HopBatchedPageRank(log, device=dev, **kw).run(
        hops, windows, chunks=3, warm_start=True)      # warm-up
    torch.cuda.synchronize()
    reps = []
    for _ in range(3):
        hb = HopBatchedPageRank(log, device=dev, **kw)
        # the counts of this sweep alone: zeroed just before it, read
        # just after it
        columns.reset_launches()
        t0 = time.perf_counter()
        ranks, steps = hb.run(hops, windows, chunks=3, warm_start=True)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0, hb.fold_seconds,
                     hb.dispatch_seconds, hb.ship_bytes))
        launches = dict(columns.LAUNCHES)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    ranks = ranks.cpu()
    ref, ref_steps = HopBatchedPageRank(log, device="cpu", **kw).run(
        hops, windows, chunks=3, warm_start=True)
    err = (ranks - ref).abs()
    if bool((err > 1e-7 + 1e-5 * ref.abs()).any()) or steps != ref_steps:
        raise AssertionError(f"headline differs from the CPU run: max abs "
                             f"err {float(err.max())}, steps {steps} vs "
                             f"{ref_steps}")
    if not bool(torch.isfinite(ranks).all()):
        raise AssertionError("non-finite ranks")
    sums = ranks.double().sum(1)
    if bool(((sums - 1.0).abs() > 1e-4).any()):
        raise AssertionError(f"column rank sums off 1: {sums.tolist()}")
    best = min(reps, key=lambda r: r[0])
    emit("headline", n=hb.tables.n, m=hb.tables.m, n_pad=hb.tables.n_pad,
         m_pad=hb.tables.m_pad, views=n_views, views_per_s=n_views / best[0],
         sweep_s=best[0], fold_s=best[1], dispatch_s=best[2],
         device_s=best[0] - best[1], repeat_sweep_s=[r[0] for r in reps],
         ship_bytes=best[3], supersteps=steps, launches=launches,
         max_abs_err_vs_cpu=float(err.max()))
    return launches


def phase_job(torch, np, columns, dev):
    from raphtory_tpu_torch.algorithms import PageRank
    from raphtory_tpu_torch.core.service import TemporalGraph
    from raphtory_tpu_torch.jobs.manager import AnalysisManager, RangeQuery
    from raphtory_tpu_torch.utils.synth import gab_like_log

    g = TemporalGraph(gab_like_log(3_000, 30_000, seed=3, t_span=100_000),
                      device=dev)
    mgr = AnalysisManager(g, device=dev)
    windows = (100_000, 20_000, 5_000)
    q = RangeQuery(start=40_000, end=100_000, jump=10_000, windows=windows)
    columns.reset_launches()
    job = mgr.submit(PageRank(tol=1e-7, max_steps=20), q)
    if not job.wait(600):
        raise AssertionError("job did not finish in 600 s")
    launches = dict(columns.LAUNCHES)
    rows = mgr.results(job.id)
    n_hops = len(range(q.start, q.end + 1, q.jump))
    if job.status != "done" or len(rows) != n_hops * len(windows):
        raise AssertionError(f"job {job.status}: {len(rows)} rows, "
                             f"error {job.error}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"job launched no kernel: {launches}")
    if any(abs(r["result"]["sum"] - 1.0) > 1e-4 for r in rows):
        raise AssertionError("job rank sums off 1")
    emit("job", status=job.status, rows=len(rows), steps=rows[0]["steps"],
         launches=launches)


def phase_scale(torch, np, columns, HopBatchedPageRank, dev):
    from raphtory_tpu_torch.utils.synth import gab_like_log

    t0 = time.perf_counter()
    log = gab_like_log(5_300_000, 1 << 25, seed=11, t_span=GAB_SPAN)
    gen_s = time.perf_counter() - t0
    hops = [int(T) for T in
            np.linspace(0.45 * GAB_SPAN, GAB_SPAN, 4).astype(np.int64)]
    torch.cuda.reset_peak_memory_stats()
    columns.reset_launches()
    t0 = time.perf_counter()
    hb = HopBatchedPageRank(log, tol=1e-7, max_steps=20, device=dev)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks, steps = hb.run(hops, WINDOWS, chunks=2, warm_start=True)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = dict(columns.LAUNCHES)
    if min(launches.values()) <= 0:
        raise AssertionError(f"scale run launched no kernel: {launches}")
    if not bool(torch.isfinite(ranks).all()):
        raise AssertionError("non-finite ranks at scale")
    sums = ranks.double().sum(1).cpu()
    if bool(((sums - 1.0).abs() > 1e-4).any()):
        raise AssertionError(f"scale rank sums off 1: {sums.tolist()}")
    n_views = len(hops) * len(WINDOWS)
    emit("scale", n_edge_events=1 << 25, n=hb.tables.n, m=hb.tables.m,
         n_pad=hb.tables.n_pad, m_pad=hb.tables.m_pad, views=n_views,
         gen_s=gen_s, setup_s=setup_s, sweep_s=sweep_s,
         fold_s=hb.fold_seconds, dispatch_s=hb.dispatch_seconds,
         device_s=sweep_s - hb.fold_seconds,
         views_per_s=n_views / sweep_s, supersteps=steps,
         peak_device_bytes=torch.cuda.max_memory_allocated(),
         launches=launches)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from raphtory_tpu_torch.engine.hopbatch import HopBatchedPageRank
    from raphtory_tpu_torch.ops import columns
    from raphtory_tpu_torch.utils.synth import gab_like_log

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    build_s = columns.build()
    emit("build", seconds=build_s, ptxas={
        k: [ln.strip() for ln in v.splitlines()
            if "registers" in ln or "error" in ln.lower()]
        for k, v in columns.BUILD_LOG.items()})

    log = gab_like_log(n_vertices=30_000, n_edges=300_000, t_span=GAB_SPAN)
    tables = HopBatchedPageRank(log, device=dev).tables
    kernels = phase_kernels(torch, np, columns, tables, dev)
    launches = phase_headline(torch, np, columns, HopBatchedPageRank, log,
                              dev)
    phase_job(torch, np, columns, dev)
    phase_scale(torch, np, columns, HopBatchedPageRank, dev)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": launches[name],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
        for name, k in kernels.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
