#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``raphtory_tpu_torch``) on one card.

    python3 chip_smoke.py [--parent DIR]

Needs one CUDA card, ``nvidia-smi`` and the CUDA toolkit (``nvcc``); builds
the kernels from ``raphtory_tpu_torch/csrc`` on first use. Phases, each
printing one JSON line:

1. device   — card name and power limit (nvidia-smi).
2. build    — nvcc build of every kernel library, one process per source.
3. kernels  — each kernel against its plain PyTorch twin on the card, at
              the shapes of the path that runs it: K1 (one launch a
              call; at the headline's edge and vertex calls and on
              ``k1_edge_cases``: int32 / int64 at their limits, h0 on and
              off, H 1 to 70, groups of hops chained) and K2a bitwise; K2b,
              and K2c's ranks, pull-sum input and dangling mass, within
              rtol 1e-5 / atol 1e-7 (K2b also bitwise its twin run on the
              CPU, which adds in edge order; K2a and K2b at C = 1, 9, 12,
              36, 129, 300, off alignment, and K2a over a layout's source
              walk); K2c's halting flags exact, and at
              C = 1, 9, 12, 127, 128, 129, 300 and with an unaligned ``r``
              against its twin, two launches from one state bitwise
              equal; K5 (CC
              superstep, GAB shapes), K6 (BFS/SSSP superstep, unit and
              weighted, directed and undirected, LDBC shapes; each of K5,
              K6, K5-P, K6-P one launch a superstep, with its device time
              from the profiler) and K6w (the weight rebuild, pads, with
              and without h0, at the LDBC length, a binned length and H
              70; one launch a call) bitwise
              (``torch.equal``); K7 (segment combine: sum / min / max,
              float32 / int32, both directions, k = 1 and 3, one launch a
              call; also ``segment_combine_out_degree``, bitcoin_range's
              int32 out-degree call over its Pareto senders, timed beside
              ``index_add_``) bitwise but for its float sums against the
              twin on the card (rtol 1e-5 / atol 1e-7); K7, K7-P and
              K7-mode past 65,535 grid rows (F * k features x windows,
              k windows) one launch a group of 65,535, bitwise their
              twins, and one launch at the limit (``grid_split``); K9a
              (one packed chunk a call, staged in pinned memory and
              uploaded in one non-blocking copy, int32 and int64, at the
              GAB and the past-cap job's capacities; ``calls`` gives the
              hop's upload + wrapper), K9b (bounds by value, 32 windows a
              launch: GAB k 1, Bitcoin k 3, GAB k 40, int64) and K8u (a
              cold View's two masks from one packed buffer in one launch,
              at the LDBC, GAB and taint Views' shapes: ``ms``, device
              time, the mask step's host time; and ``k8u_edge_cases``)
              bitwise; a ``sync_check``
              line: one resident hop's chunk upload, K9a and K9b, the cold
              View's mask step (one non-blocking copy, one K8u launch) and
              the host-column mask step (the fold columns' one staged
              copy, then K3, and KB1) under
              ``torch.cuda.set_sync_debug_mode("error")``, and their
              synchronizing calls counted under ``"warn"`` (the
              parent's mask steps too); K3 (host-column masks, the column
              bounds by value, a launch a group of 64 columns: the
              headline chunk, int32 and int64, the LDBC dispatch's shape
              and C 70; ``upload_and_call_ms`` the dispatch's mask step
              from staged fold columns) and K4 (scale masks at the scale
              sweep's shape, engine-order and binned through a synthetic
              layout, two launches a call, and ``k4_edge_cases``)
              bitwise; the binned kernels KB1, K2b-P
              (bitwise against K2b on a pre-aggregating layout at C = 1,
              9, 12, 36, 129, 300 and an unaligned ``rd``, and on one that
              does not pre-aggregate), K5-P (on a layout with buckets
              and one without), K6-P and K7-P (also
              against K7) at the pcpm phase's layouts. CUDA-event times,
              bounds, twin times.
4. headline — the north-star windowed PageRank Range query (GAB-like log,
              30k vertices / 300k edge events, 12 hops x 3 windows,
              chunks=3, warm start, tol 1e-7, 20 supersteps) through
              ``HopBatchedPageRank`` on the card, held against the same
              port run on the CPU (plain twins): rtol 1e-5 / atol 1e-7 and
              equal steps; every column's ranks sum to 1 +- 1e-4.
5. cc_range — the GAB ConnectedComponents Range query (the headline log,
              12 hops x the 1-month window, max_steps 50, chunks=1) through
              ``HopBatchedCC``, held BITWISE against the CPU run, equal
              steps.
6. ldbc_traversal — LDBC-like log (10k persons, 120k knows, 10 % deletes,
              weights), 10 hops x 2 sliding windows, seeds (0, 1, 2, 3),
              undirected, max_steps 32: ``HopBatchedBFS`` and
              ``HopBatchedSSSP`` (chunks=1), and SSSP with chunks=2 (the
              device-resident weight state), each BITWISE against the CPU
              run with equal steps; K6w one launch a dispatch.
7. job      — ``TemporalGraph`` + ``AnalysisManager`` PageRank, CC and
              weighted SSSP Range jobs, and a PageRank Range of 1,025
              views, one past the columnar route's cap, which declines
              it: the job ends ``done`` on the resident ``DeviceSweep``
              (one K9a and one K9b launch a hop; the kernels line's K9a /
              K9b launches are this job's), its 1,025 rows held against
              the same job on the CPU twins (rtol 1e-5 / atol 1e-7, equal
              supersteps); each job's wall seconds and views/s, the
              past-cap sweep's ``fold_s`` / ``dispatch_s`` / ``ship_bytes``.
8. gab_pr_view — the GAB PageRank View (``bench.py:bench_gab_pr_view``):
              PageRank(max_steps=20, tol=1e-7) View jobs at 0.90 (cold:
              pin + first dispatch), then 0.92 .. 1.0 x t_span (warm),
              window 2.6M, on the resident ``DeviceSweep`` (K9a, K9b, K7);
              rows and rank vectors against the same jobs on the CPU
              (rtol 1e-5 / atol 1e-7, equal steps).
9. bitcoin_range — ``bitcoin_like_log(20_000, 200_000)``, 10 hops over
              [0.5, 1.0] x t_span x windows (week, day, hour), PageRank
              through ``DeviceSweep.run_sweep`` (serial), against the CPU;
              the warm-up sweep counts K7's source-direction calls (the
              out-degree entry's launches).
10. view_programs — on the LDBC log: CC, DegreeBasic and undirected BFS
              View jobs on the resident route, weighted SSSP and a
              descending-time PageRank View on the cold ``bsp.run`` route
              (K8u); rows and result vectors bitwise against the CPU
              (PageRank: the tolerance above); each cold dispatch split
              by stage (``cold_split_s``).
11. host_columns — the headline PageRank, cc_range CC and LDBC BFS and
              SSSP on the host-column route (``RTPU_FOLD=host``: host-built
              ``[H, m_pad]`` fold columns, K3), each BITWISE with equal
              steps against the same engine's delta route on the card.
    fold_pipeline — the fold pipeline's modes (``core/sweep.py``), medians
              of 3 sweeps on fresh engines, each against the serial loop
              (``RTPU_FOLD_WORKERS=1 RTPU_PREFETCH=0``, fold cache off):
              the prefetch alone (1 worker), the defaults cold (the cache
              emptied before each sweep: the serial lane, which leaves
              checkpoints) and checkpoint-warm (an earlier sweep's
              checkpoints: forked folds), each sweep's fold mode checked,
              for the headline PageRank on both fold routes, cc_range CC
              and LDBC BFS; LDBC SSSP (chunks=2) on the prefetch lane; the
              fold alone (``fold_payloads``): its wall serial, with the
              vertex fold inline (no overlap), cold and checkpoint-warm,
              byte-equal the serial fold's, and the warm fold's worker
              seconds over its wall (``overlap``); ``bitcoin_range``'s
              ``run_sweep`` with ``RTPU_PREFETCH=0``, on the lookahead
              lane, cold and checkpoint-warm. Results
              bitwise the serial loop's (PageRank within rtol 1e-5 / atol
              1e-7 where not bitwise, equal steps; each mode's
              ``bitwise`` says which); the host's cores.
              Every timed sweep of phases 4-14 folds cold (the cache
              emptied before it) under the default pipeline, and reports
              ``fold_s`` (worker seconds), ``fold_stall_s`` (the dispatch
              loop's wait), ``fold_mode_s`` and ``device_s`` (the sweep
              less the wait).
12. scale_bulk — ``bench.py:bench_scale_pagerank`` uncut: the bulk loader
              over ``gab_like_arrays(5.3M, 2^25, seed 11)``, 16 one-hour
              hops x 8 windows = 128 columns, tol 0, 10 supersteps through
              ``run_scale_columns`` (K4, K2); one warm call then two timed
              sweeps (K4 at most 4 launches a sweep); every column finite
              and summing to 1 +- 1e-4; K4
              and K2a/b/c against their twins at this shape (K4, K2a
              bitwise; K2c twice from one state bitwise), K2a/b/c and
              K4's edge and vertex calls timed beside their bounds at
              this shape (K2b's gathers also counted in 32-byte sectors;
              K4's calls with their device time),
              K2a beside its library call (``index_add_`` of the int32
              mask, whole or in 32-column blocks where it does not fit),
              the source walk's set-up seconds and the largest degrees.
              Then a crosscheck on a
              30k / 300k stream over the same grid: card against CPU
              (rtol 1e-5 / atol 1e-7, equal steps), and ``run_columns``
              over the bulk host columns (K3) bitwise equal to
              ``run_scale_columns`` on the card.
13. pcpm    — the destination-binned (PCPM) route with ``RTPU_PCPM``
              unset (auto, the JAX package's default; phases 4-12 pin it
              to 0 and measure the unbinned route as before): the
              headline, cc_range, LDBC BFS / SSSP / SSSP chunks=2 on the
              delta route and the first four on the host-column route
              (KB1, K2b-P, K5-P, K6-P), and a cold GAB View at 0.90 x
              t_span (K7-P) through the jobs layer and ``bsp.run``; each
              held BITWISE with equal steps against the unbinned route on
              the card and against the CPU (PageRank within rtol 1e-5 /
              atol 1e-7); layout specs, build seconds and peak memory.
              ``scale_bulk`` (12) runs its binned part on the same load
              (the layout build, two timed sweeps, bitwise against the
              unbinned ranks, the binned K4, K2b-P and K2a over the
              layout's source walk against their twins at the scale
              shape, K2b-P bitwise
              K2b over the same masks, K2b-P and K2a timed, K2b-P beside
              its table bound and its gather bound with the mask's live
              share) and its crosscheck
              binned against the CPU; the headline's binned run makes one
              K2b-P launch a superstep.
14. scale   — the general-fold PageRank engine on a 5.3M-vertex /
              2^24-edge-event log (cut from 2^25 to pay for the serve
              phase: ~130 s of host fold at 2^25), 2 hops x 3 windows,
              chunks=2; K1 on the sweep's edge payload (its own h0 call,
              and both hops as one call of H 2 without h0) bitwise its
              twin, timed with its device time and bound (``k1_edge``).
15. features — ``bench.py:bench_scale_features`` uncut:
              ``twitter_like_log(2^22, 2^25, seed 11)``, F 128, 2 rounds,
              bf16, ``RTPU_PCPM`` unset; a set-up call at 0.8 t_span, then
              four timed calls (T0 + 1 h / 2 h x month / day) through
              ``FeatureAggregator`` on one ``DeviceSweep`` (K10, K9a):
              views/s, fold / dispatch seconds, K10 ms a round, traffic
              bytes and flops a call, peak memory, the resolved spec; every
              row finite and unit norm; K10 and K10-P (one launch a round
              each) against their twins at this shape (f32 max abs err;
              bf16 elements that differ, max ulps), K10-P bitwise K10 at
              the day and the month window; both timed at both windows
              with the row gathers' GB/s beside two bounds ("H read
              once", and with every live edge's row gathered, by bytes
              and in 32-byte sectors), and ``torch.sparse.mm`` timed
              at both windows as the yardstick, in the same call; then
              the four calls again under ``RTPU_PCPM=0``, two hops on
              (``unbinned``: K10's 8 launches, views/s, fold / dispatch
              seconds).
16. features_gab — the headline GAB log, F 128, f32 and bf16, with
              ``RTPU_PCPM=0`` (K10) and ``=1`` (K10-P): card against the
              CPU run (f32 atol 1e-6, bf16 2 ulps), binned against
              unbinned on the card (``torch.equal``); K10-P timed and
              held against its twin, and at F 132 / 260 / 388 / 512 (f32
              and bf16) bitwise K10 and against its twin;
              ``TemporalEmbeddings.nearest`` /
              ``drift`` on the card against the CPU.
17. lpa     — ``LabelPropagation``: a cold View job on the GAB log at
              0.90 t_span over (month, week, day), a hop-by-hop Range job
              over the LDBC log (10 hops x 2 windows) and
              ``DeviceSweep.run``, each BITWISE equal to the CPU run with
              equal steps; K7-mode against its twin on a synthetic case
              (a 100,003-row segment with ties, rows of 1, 32, 33, 4,096
              and 4,097, runs at the short rows' lane widths, masked and
              negative values, empty segments, k = 1, 2, 3, with and
              without a mask) and timed at the GAB View's shape (k 3)
              and at the LDBC Range's (k 2, ``ldbc_range_shape``).

18. taint   — ``TaintTracking`` (the reference's Ethereum taint
              tracking with its exchange stop-list) over the multigraph of
              edge-add events of ``bitcoin_like_log(2^21, 2^23, seed 11,
              one week)``: a View job at the week's end over (week, day,
              hour) and a Range job (4 daily hops x (day, hour)) through
              ``AnalysisManager``, binned (``RTPU_PCPM`` unset: K7-P on
              int64) and unbinned (``=0``: K7 on int64), BITWISE equal
              with equal supersteps; the View equal to the CPU job, the
              Range's first hop to the CPU run; fold / layout / dispatch
              seconds (the View's dispatch split by stage on each route,
              ``split_s``), views/s and the fold share, tainted counts,
              peak memory; K7 and K7-P int64 against their twins at
              this shape (timed beside ``scatter_reduce_``) and on edge
              cases (empty segments, a fully masked window, INT64_MIN /
              INT64_MAX, k = 1 and 3, an unaligned edge count).

19. mesh_one — the mesh path on ONE rank (no process group, the card):
              ``AnalysisManager(TemporalGraph(gab log), mesh=make_mesh(1,
              1))`` PageRank Range at the headline grid and CC Range at the
              month window (the column-sharded route, K12), a CC Range with
              the columnar route declined (``ShardedSweep``, K11 a hop),
              PageRank and CC Views at 0.90 t_span x (month, week, day)
              (K11); every row against the single-device port on the card
              (CC bitwise; PageRank rtol 1e-5 / atol 1e-7, equal steps),
              and K12 against the single-device host-column runners.
    serve   — the REST serving stack (``phase_serve``): ``RestServer``
              over ``AnalysisManager`` on the card, a GAB and an LDBC
              server; bursts of concurrent PageRank, CC and SSSP Range
              requests coalesced by the serving scheduler into one
              columnar dispatch a family, Views warm and cold, an explain
              Range, a kill, every ported GET route, the metrics text, a
              Live subscription; rows against the CPU twins, sinks
              against rows, an injected ``sched.dispatch`` failure sending
              members to their own routes; latencies, batches, the
              ``sched.dispatch`` spans and the Live epochs' split into
              repin / fold / dispatch.
20. mesh_ranks — 4 ranks on the card under gloo (``cluster.bootstrap.
              spawn``, share_card, hard timeout): on the headline log,
              ``sharded.run`` PageRank on 2 x 2 and 1 x 4 meshes over
              all_gather and halo, CC over all_gather, halo and sparse, a
              12-hop ``ShardedSweep`` PageRank, ``run_columns_sharded``
              PageRank and CC at the headline grid (36 columns, 9 a rank);
              on the ``sparse_collectives`` stream (``bench.py:3268-3297``)
              CC and BFS from its 3 hubs over all_gather and sparse;
              TaintTracking over the occurrence partition of the
              ``bitcoin_range`` log, plain and windowed, on 1 x 4
              (all_gather, halo) and 2 x 2. Each
              against the single-device port on the card (CC / BFS /
              taint bitwise, PageRank within the tolerance) and ``mesh_one``;
              bytes, supersteps and dispatch seconds per route (the
              view and its partition built before the clock); then
              measuring replays of a few cases: one that keeps the
              exchange kernels' inputs, one that times each collective
              (a sync before and after it). ``halo_pack``,
              ``frontier_compact`` and ``frontier_merge_min`` timed and
              held against their twins at the inputs the ranks gave them;
              each also at the deployment shape (the ``scale_bulk``
              graph's vertex state on 4 ranks: its halo page from
              ``_build_halo``, a CC replica of 8 x 5,308,416 rows with 1 %
              and 20 % of each rank's rows live, a rank's 8 x 1,327,104
              rows with 1 % and 20 % changed), each timed beside its
              library call in alternating
              rounds (the median of 7 batches of 200 calls: the card's
              timeline and, over the same batch, the host clock) and its
              device time taken from a profiler trace, and bitwise in
              their edge cases (every word width,
              trailing dimensions, offset leaves, pad slots, NaN, empty
              slices, strided counts). Then a ``program_bounds`` line:
              the K11 / K13 / K12 programs' bounds, each the sum of its
              kernels' bounds at the launches a dispatch made on rank 0,
              beside the bytes its collectives moved.

The launch counts are zeroed just before each path's timed run and read
just after it; each path fails if one of its kernels never launched (the
mesh kernels' counts come from rank 0 of ``mesh_ranks``).

With ``--parent DIR`` (the tree of the previous slice, e.g. its commit
unpacked with ``git archive``: ``Parent`` binds its C entry point), K8u
``rtpu_unpack_mask_bits`` as DIR's ``sweep.cu`` builds it, inside a copy
of DIR's wrapper, is held BITWISE against this tree's K8u at the LDBC,
GAB and taint Views' shapes and timed in turns with it (medians of 7
rounds: CUDA events, the host's time to a sync, and device time from the
profiler): the unpack alone (the parent's two calls, one an array) and the
mask step (the parent's two pageable uploads and two calls against one
non-blocking copy and one launch); and the host-column mask step (the
parent's four pageable fold-column uploads and K3 / KB1, whose
``masks.cu`` is unchanged, against the fold columns' one staged copy and
the same call) at the headline chunk, the LDBC shape and KB1 on the
headline layout; ``sync_check`` counts both parent steps' synchronizing
calls: a ``parent`` line before ``timing``.

Then a ``timing`` line (each phase's wall seconds, the binned route's
share), one line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device":
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
#: kernels each path launches (the ``columns.LAUNCHES`` keys)
PAGERANK_KERNELS = ("masks_from_deltas", "column_out_degree",
                    "column_pull_sum", "pagerank_update")
CC_KERNELS = ("masks_from_deltas", "cc_superstep")
SSSP_KERNELS = ("masks_from_deltas", "minplus_superstep",
                "weights_from_deltas")
RESIDENT_KERNELS = ("segment_combine", "apply_delta_chunk", "window_masks")
COLD_KERNELS = ("segment_combine", "unpack_mask_bits")
BTC_SPAN = 2_600_000
BTC_WINDOWS = [604_800, 86_400, 3_600]    # week / day / hour


#: wall seconds of each phase of this run (the ``timing`` line)
PHASE_S: dict = {}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def timed(name: str, fn, *args):
    """``fn(*args)``, its wall seconds kept in ``PHASE_S[name]``."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[name] = time.perf_counter() - t0
    return out


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


#: with ``--parent DIR``: K8u as the tree at DIR builds it (``Parent``),
#: and the parent's mask steps, held against this tree's and timed in turns
#: with them on the same inputs
PARENT = None
#: "kernel shape" -> this tree's and the parent's ms (``vs_parent``)
PARENT_MS: dict = {}


class Parent:
    """K8u ``rtpu_unpack_mask_bits`` of another tree's ``sweep.cu``, the C
    entry point it had before this tree unpacked a View's two masks from
    one buffer in one launch: ``(rows, nbytes | packed, out, stream)``,
    one array of ``u8[rows, nbytes]`` a call, inside a copy of that tree's
    wrapper (its checks, its allocation and its call; the kernels line's
    ``ms`` has always timed the wrapper); ``mask_step``: that tree's cold
    mask step (``bsp.run_async``'s ``ship_bits``: each array's packed bits
    uploaded pageable, a blocking ``.to``, then unpacked); and
    ``fold_columns_step``: that tree's host-column dispatch
    (``hopbatch._dispatch_columns``: the four fold columns uploaded one by
    one, pageable, then K3 / KB1, whose ``masks.cu`` this tree keeps as it
    was). Built with ``columns.build``'s nvcc flags. Its launches count
    nowhere."""

    def __init__(self, columns, root: str):
        import ctypes
        import hashlib

        src = os.path.join(root, "raphtory_tpu_torch", "csrc", "sweep.cu")
        with open(src, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        out = columns._BUILD / f"libparent_sweep_{tag}.so"
        if not out.exists():
            columns._BUILD.mkdir(exist_ok=True)
            proc = subprocess.run(
                [columns._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                 str(out), src], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, timeout=900)
            if proc.returncode:
                raise RuntimeError(f"parent build failed:\n"
                                   f"{proc.stdout.decode()}")
        lib = ctypes.CDLL(str(out))
        self._k8u = lib.rtpu_unpack_mask_bits
        self._k8u.argtypes = 2 * [ctypes.c_int64] + 3 * [ctypes.c_void_p]
        self._k8u.restype = ctypes.c_int
        self._c = columns
        self.source = str(root)

    def unpack_mask_bits(self, packed):
        """The parent's K8u wrapper (card branch): ``u8[k, b]`` →
        ``bool[k, 8b]``."""
        import torch

        name = "unpack_mask_bits"
        if packed.dim() != 2:
            raise ValueError(f"{name}: packed has shape "
                             f"{tuple(packed.shape)}, want [k, bytes]")
        rows, nbytes = packed.shape
        self._c._expect(name, packed, "packed", (torch.uint8,),
                        (rows, nbytes))
        self._c._on_cuda(name, packed)
        out = torch.empty((rows, nbytes * 8), dtype=torch.bool,
                          device=packed.device)
        err = self._k8u(rows, nbytes, packed.data_ptr(), out.data_ptr(),
                        self._c._stream(packed))
        if err:
            raise RuntimeError(f"parent K8u: cudaError {err}")
        return out

    def mask_step(self, v_bits, e_bits, dev):
        """The parent's cold mask step from its two host arrays of packed
        bits (``np.packbits`` of each mask, per row): two pageable uploads
        and two K8u calls."""
        import torch

        return tuple(self.unpack_mask_bits(torch.from_numpy(b).to(dev))
                     for b in (v_bits, e_bits))

    @staticmethod
    def fold_columns_step(columns, host_cols, bounds, dev, pv=()):
        """The parent's host-column mask step from the four host fold
        columns: four pageable uploads, then K3 (KB1 with ``pv``)."""
        import torch

        cols = [torch.from_numpy(a).to(dev) for a in host_cols]
        if pv:
            return columns.bin_column_masks(*cols, *bounds, *pv)
        return columns.column_masks(*cols, *bounds)


def column_steps(columns, host_cols, bounds, dev, pv=()):
    """``(new, old)``: the host-column dispatch's mask step from the same
    four host fold columns, this tree's (the columns staged once in pinned
    memory, as ``_fold_columns`` stages them, then ``hopbatch.
    _ship_columns``' one non-blocking copy and K3 / KB1) and the
    parent's (``Parent.fold_columns_step``)."""
    from raphtory_tpu_torch.engine import hopbatch
    from raphtory_tpu_torch.ops import resident

    staged = resident.pack(host_cols, pin=dev.type == "cuda")
    call = columns.bin_column_masks if pv else columns.column_masks

    def new():
        return call(*hopbatch._ship_columns(staged, dev), *bounds, *pv)

    def old():
        return Parent.fold_columns_step(columns, host_cols, bounds, dev, pv)
    return new, old


#: alternating rounds ``vs_parent`` times this tree's and the parent's call
PARENT_ROUNDS = 7


def wall_ms(torch, fn, iters: int = 20) -> float:
    """Mean host milliseconds of ``fn()`` to a device sync, each call
    timed on its own after a warm-up (a step whose result the caller
    waits for)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total / iters * 1e3


def vs_parent(torch, key: str, new, old, iters: int = 20, wall=False,
              **facts) -> None:
    """``new`` and the parent's ``old`` timed in turns: ``PARENT_ROUNDS``
    rounds, each ``cuda_ms`` over ``iters`` calls of one then the other
    (the order alternating, so both see the same host load: at the
    headline shapes a call is host-bound), compared by their medians;
    with ``wall``, also ``wall_ms`` (host time to a sync, a call at a
    time) in the same alternating rounds; then each one's device time
    (``device_ms``; both calls run their wrapper's checks, as the
    parent's wrapper did), into ``PARENT_MS[key]``."""
    import statistics

    ms, pms, wms, wpms = [], [], [], []
    for r in range(PARENT_ROUNDS):
        for fn, got, wgot in ((old, pms, wpms),
                              (new, ms, wms))[::1 if r % 2 else -1]:
            got.append(cuda_ms(torch, fn, iters))
            if wall:
                wgot.append(wall_ms(torch, fn, iters))
    dn, by_n = device_ms(torch, new, iters)
    dp, by_p = device_ms(torch, old, iters)
    med = statistics.median
    PARENT_MS[key] = dict(ms=ms, parent_ms=pms, ratio=med(ms) / med(pms),
                          device_ms=dn, parent_device_ms=dp,
                          device_ratio=dn / dp, device_by=[by_n, by_p],
                          **facts)
    if wall:
        PARENT_MS[key].update(wall_ms=wms, parent_wall_ms=wpms,
                              wall_ratio=med(wms) / med(wpms))


def k1_bound(length: int, C: int, updates: int, tbytes: int) -> float:
    """K1's bound (ms): the base state read once, the advanced state and
    the ``[len, C]`` masks written once, each live update's (pos, lat,
    alive) and the column bounds (lo, nowin) read once."""
    return bound(length * (tbytes + 1) * 2 + length * C
                 + updates * (4 + tbytes + 1) + C * (tbytes + 1))[0]


def k1_edge_cases(torch, np, columns, dev) -> int:
    """K1 bitwise its twin (and, with ``--parent``, the parent's kernel) on
    small payloads: int32 and int64 times with the bases, updates and
    column bounds at the dtype's limits (``lo`` clipped, unwindowed
    columns), ``h0`` on and off, H = 1, 2, 8, 9, 33, 64, 65 and 70 (one,
    two and three touch-word widths, groups chained; one applied hop on the
    dense path and on the touch path), W = 1, 3 and 16 (C a multiple of 16
    or not), rows every hop touches, positions < 0 and >= len, pad rows,
    and no updates at all (U = 0; H = 1 without ``h0``). Returns the
    count."""
    rng = np.random.default_rng(7)
    cases = 0
    for tdt in (np.int32, np.int64):
        info = np.iinfo(tdt)
        vals = np.concatenate([[info.min, info.min + 1, info.max - 1,
                                info.max], rng.integers(-40, 40, 30)])
        for length, H, W, U, h0 in (
                (37, 1, 3, 5, False), (37, 1, 3, 5, True),
                (101, 2, 3, 9, False), (40, 2, 3, 6, False),
                (64, 8, 16, 7, True), (90, 9, 3, 11, False),
                (45, 33, 1, 6, True), (77, 64, 3, 8, False),
                (50, 65, 3, 5, True), (61, 70, 2, 9, False),
                (33, 3, 3, 0, True), (1000, 4, 3, 300, True)):
            base_lat = torch.from_numpy(rng.choice(vals, length).astype(
                tdt)).to(dev)
            base_alive = torch.from_numpy(rng.random(length) < 0.6).to(dev)
            pos = np.full((H, U), 2**31 - 1, np.int32)
            for h in range(H):
                k = int(rng.integers(0, U + 1))
                pos[h, :k] = rng.choice(np.arange(2, length), k,
                                        replace=False)
                if U >= 3:
                    pos[h, 0] = 1                     # every hop
                    pos[h, -1] = -1 - h % 3           # outside [0, len)
            lat = rng.choice(vals, (H, U)).astype(tdt)
            alive = rng.random((H, U)) < 0.5
            T_col = np.repeat(rng.choice(vals, H), W).astype(np.int64)
            w_col = np.tile(rng.choice([-1, 0, 5, 1 << 40], W), H)
            lo = np.clip(T_col - w_col, info.min, info.max).astype(tdt)
            args = [base_lat, base_alive] + [torch.from_numpy(a).to(dev)
                                             for a in (pos, lat, alive, lo,
                                                       w_col < 0)]
            got = columns.masks_from_deltas(*args, H, W, h0)
            want = columns.masks_from_deltas_plain(*args, H, W, h0)
            what = (f"tdt={tdt.__name__}, len={length}, H={H}, W={W}, "
                    f"U={U}, h0={h0}")
            if not all(torch.equal(g, x) for g, x in zip(got, want)):
                raise AssertionError(f"K1 differs from its twin ({what})")
            cases += 1
    return cases


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
    k1 = {}
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
                launched = columns.LAUNCHES["masks_from_deltas"]
                got = columns.masks_from_deltas(*args, H, W, h0)
                if columns.LAUNCHES["masks_from_deltas"] - launched != 1:
                    raise AssertionError("K1: not one launch a call")
                want = columns.masks_from_deltas_plain(*args, H, W, h0)
                what = f"tdt={tdt.__name__}, h0={h0}, len={length}"
                for g, x in zip(got, want):
                    k1_err = max(k1_err, float(
                        (g.double() - x.double()).abs().max()))
                    if not torch.equal(g, x):
                        raise AssertionError(f"K1 differs from its twin "
                                             f"({what})")
                if tdt == np.int32 and h0:
                    key = "edge" if length == m_pad else "vertex"
                    valid = int((pos < length).sum())
                    k1[f"{key}_ms"] = cuda_ms(
                        torch, lambda: columns.masks_from_deltas(
                            *args, H, W, h0))
                    k1[f"{key}_device_ms"], k1[f"{key}_device_by"] = \
                        device_ms(torch, lambda: columns.masks_from_deltas(
                            *args, H, W, h0))
                    k1[f"{key}_bound_ms"] = k1_bound(length, C, valid, 4)
                    if key == "edge":
                        k1["plain_ms"] = cuda_ms(
                            torch, lambda: columns.masks_from_deltas_plain(
                                *args, H, W, h0), iters=3)
    out["masks_from_deltas"] = dict(
        source="raphtory_tpu_torch/csrc/masks.cu",
        replaces="raphtory_tpu/engine/hopbatch.py:66",
        max_abs_err=k1_err, ms=k1["edge_ms"],
        device_ms=k1["edge_device_ms"], plain_ms=k1["plain_ms"],
        library_ms=None, calls=k1,
        edge_cases=k1_edge_cases(torch, np, columns, dev),
        shape=f"edges len={m_pad} H={H} W={W} U=16384 int32 h0",
        bound_ms=k1["edge_bound_ms"],
        bound_by="bytes")

    # ---- K2: the headline's real (dst, src)-sorted edge tables, and
    # their source walk (K2a's)
    e_src, e_dst, indptr, out_indptr, out_perm = (
        torch.from_numpy(a).to(dev) for a in (
            tables.e_src, tables.e_dst, tables.in_indptr, tables.out_indptr,
            tables.out_perm))
    walk = (out_indptr, out_perm)
    m = tables.m
    me_np = rng.random((m_pad, C)) < 0.6
    me_np[:, 0] = False                     # an all-masked column
    me_np[m:] = False                       # pad edges carry no mask
    me = torch.from_numpy(me_np).to(dev)
    deg = columns.column_out_degree(me, e_src, n_pad, walk)
    want = columns.column_out_degree_plain(me, e_src, n_pad)
    a_err = float((deg - want).abs().max())
    if not torch.equal(deg, want):
        raise AssertionError(f"K2a differs from its twin: max abs err "
                             f"{a_err}")
    mef = me.to(torch.float32)
    a_ms = cuda_ms(torch, lambda: columns.column_out_degree(me, e_src, n_pad,
                                                            walk))
    a_plain = cuda_ms(torch, lambda: columns.column_out_degree_plain(
        me, e_src, n_pad))
    a_lib = cuda_ms(torch, lambda: torch.zeros(
        (n_pad, C), dtype=torch.float32, device=dev).index_add_(0, e_src, mef))
    rd = torch.from_numpy(
        (rng.random((n_pad, C)) * 1e-4).astype(np.float32)).to(dev)
    got = columns.column_pull_sum(me, rd, e_src, e_dst, indptr)
    want = columns.column_pull_sum_plain(me, rd, e_src, e_dst)
    err = (got - want).abs()
    if bool((err > 1e-7 + 1e-5 * want.abs()).any()):
        raise AssertionError(f"K2b differs from its twin: max abs err "
                             f"{float(err.max())}")
    # the twin on the CPU adds in edge order, as the kernel does
    if not torch.equal(got.cpu(), columns.column_pull_sum_plain(
            me.cpu(), rd.cpu(), e_src.cpu(), e_dst.cpu())):
        raise AssertionError("K2b differs from its twin run on the CPU")
    b_ms = cuda_ms(torch, lambda: columns.column_pull_sum(
        me, rd, e_src, e_dst, indptr))
    b_plain = cuda_ms(torch, lambda: columns.column_pull_sum_plain(
        me, rd, e_src, e_dst))
    edge = k2_edge_cases(torch, np, columns, tables, dev)
    out["column_out_degree"] = dict(
        source="raphtory_tpu_torch/csrc/pagerank_columns.cu",
        replaces="raphtory_tpu/engine/hopbatch.py:154",
        max_abs_err=a_err, ms=a_ms, plain_ms=a_plain, library_ms=a_lib,
        columns=C, shape=f"m_pad={m_pad} m={m} n_pad={n_pad} C={C}",
        edge_cases=edge,
        **dict(zip(("bound_ms", "bound_by"), k2a_bound(m, n_pad, C))))
    # the kernel walks the m real edges of the CSR (the pads lie past it)
    out["column_pull_sum"] = dict(
        source="raphtory_tpu_torch/csrc/pagerank_columns.cu",
        replaces="raphtory_tpu/engine/hopbatch.py:154",
        max_abs_err=float(err.max()), ms=b_ms, plain_ms=b_plain,
        library_ms=None, columns=C, edge_cases=edge,
        shape=f"m_pad={m_pad} m={m} n_pad={n_pad} C={C}",
        **dict(zip(("bound_ms", "bound_by"),
                   k2b_bound(m, n_pad, C, int(me_np.sum())))))

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
    repeat_bitwise(torch, columns, st_k, agg, deg, mv, n_act, 1e-7,
                   "K2c at the headline shape")
    st_p = columns.rank_state(r0.clone())
    columns.pagerank_update_plain(st_p, None, deg, mv, n_act, 0.85, 1e-7,
                                  prime=True)
    c_ms = cuda_ms(torch, lambda: columns.pagerank_update(
        st_k, agg, deg, mv, n_act, 0.85, 1e-7))
    c_plain = cuda_ms(torch, lambda: columns.pagerank_update_plain(
        st_p, agg, deg, mv, n_act, 0.85, 1e-7))
    edge = k2c_edge_cases(torch, np, columns, dev)
    c_err = max(c_err, max(edge.values()))
    out["pagerank_update"] = dict(
        source="raphtory_tpu_torch/csrc/pagerank_columns.cu",
        replaces="raphtory_tpu/engine/hopbatch.py:259",
        max_abs_err=c_err, ms=c_ms, plain_ms=c_plain, library_ms=None,
        columns=C, shape=f"n_pad={n_pad} C={C}", edge_cases=edge,
        # reads agg, deg, r (f32) and mv (bool); writes r and rd (f32);
        # ~10 f32 operations per (v, c)
        **dict(zip(("bound_ms", "bound_by"), k2c_bound(n_pad, C))))
    return out


def k2c_bound(n: int, C: int) -> tuple[float, str]:
    """K2c's bound: agg, deg, r (f32) and mv (bool) read once, r and rd
    (f32) written once; ~10 f32 operations per (v, c)."""
    return bound(n * C * (4 * 3 + 1 + 4 * 2), 10 * n * C)


def k2bp_bound(m: int, n: int, C: int, nnz: int) -> tuple[float, str]:
    """K2b-P's bound, its inputs read once: the m real slots' mask rows and
    walk pairs, the walk's offsets, rd, and agg written once; one add per
    masked (slot, column)."""
    return bound(m * C + m * 8 + (n + 1) * 8 + 2 * n * C * 4, nnz)


def k2a_bound(m: int, n: int, C: int) -> tuple[float, str]:
    """K2a's bound: the m real edges' mask rows, the source walk (4 bytes
    an edge and the offsets) read once, deg (f32) written once."""
    return bound(m * C + m * 4 + (n + 1) * 8 + n * C * 4)


def k2b_bound(m: int, n: int, C: int, nnz: int) -> tuple[float, str]:
    """K2b's bound, its inputs read once: the m real edges' mask rows and
    source ids, the CSR offsets, rd, and agg written once; one add per
    masked (edge, column)."""
    return bound(m * C + m * 4 + (n + 1) * 8 + 2 * n * C * 4, nnz)


def gather_bounds(torch, me, m: int, n: int, C: int, walk_bytes: int):
    """The pull-sum's gather bounds on these masks (``me [rows, C]`` bool,
    every row but the m real ones masked): every live (edge, 4-column
    group) reads its 16 bytes of rd from HBM — at the scale shape rd is far
    past the L2 — beside the m mask rows, the walk (``walk_bytes`` an
    entry), the offsets and agg; the same counted in the 32-byte sectors
    the groups fall in. Returns the two bounds (ms) and the live shares."""
    groups = int((me.view(torch.int32) != 0).sum())
    sectors = int((me.view(torch.int64) != 0).sum())
    rest = m * C + m * walk_bytes + (n + 1) * 8 + n * C * 4
    return dict(gather_bound_ms=bound(rest + 16 * groups)[0],
                gather_sector_bound_ms=bound(rest + 32 * sectors)[0],
                live_share=groups / (m * C / 4),
                live_sector_share=sectors / (m * C / 8))


def k2_edge_cases(torch, np, columns, tables, dev) -> dict:
    """K2a and K2b on the headline tables at C = 1, 9, 12, 36, 129, 300:
    K2a bitwise its twin, K2b bitwise its twin run on the CPU (edge order)
    and within rtol 1e-5 / atol 1e-7 of it on the card; at C 36 each also
    with ``me`` (and K2b's ``rd``) off their alignment (the per-element
    path), bitwise the aligned call; and K2a on binned masks over a
    layout's source walk (P 16, cap-pad slots) bitwise its twin. Returns
    each case's max abs error against the card twin."""
    from raphtory_tpu_torch.ops import partition

    rng = np.random.default_rng(13)
    n_pad, m_pad, m = tables.n_pad, tables.m_pad, tables.m
    e_src, e_dst, indptr, out_indptr, out_perm = (
        torch.from_numpy(a).to(dev) for a in (
            tables.e_src, tables.e_dst, tables.in_indptr, tables.out_indptr,
            tables.out_perm))
    walk = (out_indptr, out_perm)

    def offset(t):
        """A copy of ``t`` at one element past an aligned address."""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        o = buf[1:].view(t.shape)
        o.copy_(t)
        return o

    errs = {}
    for C in (1, 9, 12, 36, 129, 300):
        me_np = rng.random((m_pad, C)) < 0.5
        me_np[m:] = False
        me = torch.from_numpy(me_np).to(dev)
        rd = torch.from_numpy((rng.random((n_pad, C)) * 1e-4).astype(
            np.float32)).to(dev)
        deg = columns.column_out_degree(me, e_src, n_pad, walk)
        if not torch.equal(deg, columns.column_out_degree_plain(me, e_src,
                                                                n_pad)):
            raise AssertionError(f"K2a C={C} differs from its twin")
        agg = columns.column_pull_sum(me, rd, e_src, e_dst, indptr)
        want = columns.column_pull_sum_plain(me, rd, e_src, e_dst)
        if not (within_tol(agg, want) and torch.equal(
                agg.cpu(), columns.column_pull_sum_plain(
                    me.cpu(), rd.cpu(), e_src.cpu(), e_dst.cpu()))):
            raise AssertionError(f"K2b C={C} differs from its twin")
        errs[f"C={C}"] = exact_err(agg, want)
        if C == 36:
            mo, ro = offset(me), offset(rd)
            if not (torch.equal(columns.column_out_degree(
                    mo, e_src, n_pad, walk), deg)
                    and torch.equal(columns.column_pull_sum(
                        mo, ro, e_src, e_dst, indptr), agg)):
                raise AssertionError("K2a / K2b off alignment differ from "
                                     "the aligned call")
            errs["C=36 offset"] = errs["C=36"]
    lay = partition.build_layout(tables.e_src, tables.e_dst, n_pad, m, 16)
    be = lay.device_edges(dev, reverse=True)
    me_b = torch.from_numpy((rng.random((lay.B, 12)) < 0.5)
                            & lay.valid[:, None]).to(dev)
    if not torch.equal(columns.column_out_degree(
            me_b, be.b_src, n_pad, (be.out_indptr, be.out_order)),
            columns.column_out_degree_plain(me_b, be.b_src, n_pad)):
        raise AssertionError("K2a over a layout's source walk differs from "
                             "its twin")
    errs["binned C=12 P=16"] = 0.0
    return errs


def k2a_library_ms(torch, me, e_src, n_pad: int) -> tuple[float, str]:
    """One PyTorch call for K2a's function (never called by the port):
    ``index_add_`` of the int32 mask into a zeroed int32 ``[n_pad, C]``,
    then ``.to(float32)``, the int32 mask made beforehand. That mask is 4
    bytes a mask byte (17 GB at the scale shape): where it does not fit in
    the card's free memory beside the phase's tensors, the call is timed
    in 32-column blocks and their times summed. Returns (ms, "whole" or
    "32-column blocks")."""
    m, C = me.shape
    whole = m * C * 4 + n_pad * C * 8 + (2 << 30) < torch.cuda.mem_get_info()[0]
    total = 0.0
    for c in ((0,) if whole else range(0, C, 32)):
        mi = (me if whole else me[:, c:c + 32]).to(torch.int32)
        k = mi.shape[1]
        total += cuda_ms(torch, lambda: torch.zeros(
            (n_pad, k), dtype=torch.int32, device=me.device).index_add_(
                0, e_src, mi).to(torch.float32), iters=3)
        del mi
    return total, "whole" if whole else "32-column blocks"


def repeat_bitwise(torch, columns, st, agg, deg, mv, n_act, tol,
                   what: str) -> None:
    """K2c twice from the same state (two copies of ``st``): ``r``,
    ``rd``, ``dangling``, ``halted`` and ``done`` equal bit for bit — the
    cross-block sums do not depend on block scheduling. ``st`` is left as
    it was."""
    runs = []
    off = st.r.data_ptr() % 16 // 4     # keep r's alignment (and path)
    for _ in range(2):
        buf = torch.empty(st.r.numel() + off, dtype=torch.float32,
                          device=st.r.device)
        cp = columns.rank_state(buf[off:].view(st.r.shape))
        cp.r.copy_(st.r)
        for f in ("rd", "dangling", "halted", "done"):
            getattr(cp, f).copy_(getattr(st, f))
        columns.pagerank_update(cp, agg, deg, mv, n_act, 0.85, tol)
        runs.append(cp)
        del cp
    a, b = runs
    for f in ("r", "rd", "dangling", "halted", "done"):
        if not bits_equal(torch, getattr(a, f), getattr(b, f)):
            raise AssertionError(f"{what}: two launches from the same state "
                                 f"differ in {f}")


#: K2c's edge cases: column counts (a K12 rank's 9, the headline chunk's
#: 12, both sides of a 128-column row and of a 256-quad block tile), and
#: one with ``r`` 4 bytes off 16-byte alignment (the per-element path)
K2C_CASES = ((1, False), (9, False), (12, False), (127, False),
             (128, False), (129, False), (300, False), (128, True))


def k2c_edge_cases(torch, np, columns, dev, n: int = 4_099) -> dict:
    """K2c against its twin at each ``K2C_CASES`` shape over ``n`` rows:
    ranks, ``rd`` and the dangling mass within rtol 1e-5 / atol 1e-7,
    ``halted`` and ``done`` bitwise, after a prime and one update with a
    frozen column, an empty column and a column of one alive row; then
    every live column frozen (the all-halted flag); and two launches from
    one state bitwise equal. Returns each case's max abs error."""
    rng = np.random.default_rng(9)
    errs = {}
    for C, offset in K2C_CASES:
        mv = torch.from_numpy(rng.random((n, C)) < 0.8).to(dev)
        if C > 1:
            mv[:, 1] = False                          # an empty column
        if C > 3:
            mv[:, 3] = False
            mv[n // 2, 3] = True                      # one alive row
        deg = torch.from_numpy(rng.integers(0, 3, (n, C)).astype(
            np.float32)).to(dev)
        n_act = torch.clamp(mv.to(torch.float32).sum(0), min=1.0)
        r0 = torch.where(mv, torch.from_numpy(rng.random((n, C)).astype(
            np.float32)).to(dev), 0.0)
        r0 = r0 / r0.sum(0).clamp(min=1e-30)
        agg = torch.from_numpy((rng.random((n, C)) * 1e-4).astype(
            np.float32)).to(dev)
        err = 0.0
        # a frozen column; then every live column frozen (column 1 has
        # no alive row and halts at once): the all-halted flag
        frozen_sets = ([2] if C > 2 else [], [c for c in range(C) if c != 1])
        for every, frozen in enumerate(frozen_sets):
            pair = []
            for update in (columns.pagerank_update,
                           columns.pagerank_update_plain):
                if offset:    # a contiguous view 4 bytes into its buffer
                    buf = torch.empty(n * C + 1, dtype=torch.float32,
                                      device=dev)
                    r = buf[1:].view(n, C)
                    r.copy_(r0)
                else:
                    r = r0.clone()
                st = columns.rank_state(r)
                update(st, None, deg, mv, n_act, 0.85, 1e-7, prime=True)
                primed = (st.rd.clone(), st.dangling.clone())
                st.halted[frozen] = True
                if update is columns.pagerank_update:
                    repeat_bitwise(torch, columns, st, agg, deg, mv, n_act,
                                   1e-7, f"K2c C={C} offset={offset}")
                update(st, agg, deg, mv, n_act, 0.85, 1e-7)
                pair.append((primed, st))
            (p_got, got), (p_want, want) = pair
            for g, x, what in ((p_got[0], p_want[0], "primed rd"),
                               (p_got[1], p_want[1], "primed dangling"),
                               (got.r, want.r, "r"), (got.rd, want.rd, "rd"),
                               (got.dangling, want.dangling, "dangling")):
                e = (g - x).abs()
                err = max(err, float(e.max()))
                if bool((e > 1e-7 + 1e-5 * x.abs()).any()):
                    raise AssertionError(
                        f"K2c C={C} offset={offset}: {what} differs from its "
                        f"twin: max abs err {float(e.max())}")
            if not (torch.equal(got.halted, want.halted)
                    and torch.equal(got.done, want.done)):
                raise AssertionError(f"K2c C={C} offset={offset}: halting "
                                     "differs from its twin")
            if every and not bool(got.done):
                raise AssertionError(f"K2c C={C}: every column halted, flag "
                                     "unset")
        errs[f"C={C}" + (" offset" if offset else "")] = err
    return errs


def mask_kernels(torch, np, columns, gab, ldbc, dev):
    """K3 (its column bounds by value, a launch a group of 64 columns) at
    the headline's tables and one headline chunk (H = 4 hops x 3 windows;
    int32 timed, int64 checked too), at the LDBC dispatch's shape (H 10 x
    W 2 over its tables) and at C 70 (two launches), each BITWISE its twin
    and (``--parent``) the parent's kernel, timed in turns with the
    parent's mask step (its three bound uploads and its call); and K4 at
    the scale sweep's shape (``bench.py:bench_scale_pagerank``: m_pad
    33,554,432, n_pad 5,308,416, 16 hops x 8 windows, U_e 65,536, U_v
    131,072; the edge call also binned through a synthetic layout) and on
    ``k4_edge_cases``, each against its twin with ``torch.equal``; the
    calls timed, with their device time."""
    rng = np.random.default_rng(2)
    out = {}

    # ---- K3: random fold columns, times at the dtype's bounds among them
    t_pool = np.array([0, 1000, 4000, -5], np.int64)
    w_pool = np.array([-1, 0, 1 << 40, 300, 2_000, 86_400, 7, 64, 5_000, 1],
                      np.int64)
    calls, k3_err = {}, 0.0
    for key, t, H, W, tdts in (("headline", gab, 4, 3, (np.int32, np.int64)),
                               ("ldbc", ldbc, 10, 2, (np.int32,)),
                               ("c70", gab, 7, 10, (np.int32, np.int64))):
        C = H * W
        m, n = t.m_pad, t.n_pad
        hop_of_col = np.repeat(np.arange(H, dtype=np.int32), W)
        for tdt in tdts:
            info = np.iinfo(tdt)
            vals = np.concatenate([[info.min, info.min + 1, info.max - 1,
                                    info.max], rng.integers(-5000, 5000, 60)])
            T_col = np.repeat(t_pool[np.arange(H) % 4], W)
            T_col[:W] = info.max - 3
            w_col = np.tile(w_pool[:W], H)
            bounds = (hop_of_col, np.clip(T_col - w_col, info.min,
                                          info.max).astype(tdt), w_col < 0)
            host_cols = (rng.choice(vals, (H, m)).astype(tdt),
                         rng.random((H, m)) < 0.7,
                         rng.choice(vals, (H, n)).astype(tdt),
                         rng.random((H, n)) < 0.7)
            cols = [torch.from_numpy(a).to(dev) for a in host_cols]
            tb = [torch.from_numpy(a).to(dev) for a in bounds]
            before = columns.LAUNCHES["column_masks"]
            got = columns.column_masks(*cols, *bounds)
            if columns.LAUNCHES["column_masks"] - before != -(-C // 64):
                raise AssertionError(f"K3: not one launch a group of 64 "
                                     f"columns ({key})")
            want = columns.column_masks_plain(*cols, *tb)
            step, parent_step = column_steps(columns, host_cols, bounds,
                                             dev)
            what = f"{key}, tdt={tdt.__name__}"
            for g, x, y, z in zip(got, want, step(), parent_step()):
                if not (torch.equal(g, x) and torch.equal(g, y)
                        and torch.equal(g, z)):
                    raise AssertionError(f"K3 differs from its twin or from "
                                         f"the dispatch steps' ({what})")
                k3_err = max(k3_err, exact_err(g, x))
            if tdt != np.int32:
                continue

            def k3(cols=cols, bounds=bounds):
                return columns.column_masks(*cols, *bounds)
            # the fold columns (lat + alive) and the column bounds read
            # once, the masks written once
            bnd = bound(H * (m + n) * (info.bits // 8 + 1) + C * 17
                        + (m + n) * C)
            shape = f"m_pad={m} n_pad={n} H={H} C={C} int32"
            entry = dict(ms=cuda_ms(torch, k3, 50), bound_ms=bnd[0],
                         shape=shape, launches_a_call=-(-C // 64),
                         # the dispatch's mask step: the fold columns' one
                         # staged upload and the call
                         upload_and_call_ms=cuda_ms(torch, step, 50))
            entry["device_ms"], entry["device_by"] = device_ms(torch, k3, 50)
            if key == "headline":
                entry["plain_ms"] = cuda_ms(
                    torch, lambda: columns.column_masks_plain(*cols, *tb))
                head = bnd
            if PARENT is not None and key != "c70":
                vs_parent(torch, f"fold_columns {key}", step, parent_step,
                          iters=50, wall=True,
                          shape=shape + " (the fold columns' upload + the "
                                        "call)", bound_ms=bnd[0])
            calls[key] = entry
    out["column_masks"] = dict(
        source="raphtory_tpu_torch/csrc/masks.cu",
        replaces="raphtory_tpu/engine/hopbatch.py:50",
        max_abs_err=k3_err, ms=calls["headline"]["ms"],
        device_ms=calls["headline"]["device_ms"],
        plain_ms=calls["headline"]["plain_ms"], library_ms=None, calls=calls,
        columns=12, shape=calls["headline"]["shape"],
        **dict(zip(("bound_ms", "bound_by"), head)))

    # ---- K4 at the scale shape: random base states (half never seen),
    # half-full update lists padded with (0, INT32_MIN), a real update
    # to position 0, thresholds with unwindowed (0) columns among them;
    # the edge table's also binned through a synthetic layout (slots in a
    # random order, 5 % cap-pad slots, the last 4,096 positions — the
    # engine's pad rows — in no slot)
    H, W = 16, 8
    C = H * W
    gen = torch.Generator(device=dev).manual_seed(3)
    i32min = torch.iinfo(torch.int32).min

    def rand(shape, hi):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    thr = rand((C,), 2_600_000)
    thr[::5] = 0
    k4 = {}
    for length, U in ((33_554_432, 65_536), (5_308_416, 131_072)):
        base = torch.where(rand((length,), 2) == 0,
                           rand((length,), 2_000_000), i32min)
        pos, t = rand((H, U), length), rand((H, U), 2_600_000)
        pos[:, U // 2:] = 0
        t[:, U // 2:] = i32min
        pos[3, 0], t[3, 0] = 0, 2_500_000
        args = (base, pos, t, thr, H, W)
        launched = columns.LAUNCHES["scale_hop_masks"]
        got = columns.scale_hop_masks(*args)
        if columns.LAUNCHES["scale_hop_masks"] - launched != 2:
            raise AssertionError("K4: not two launches a call")
        want = columns.scale_hop_masks_plain(*args)
        if not torch.equal(got, want):
            raise AssertionError(f"K4 differs from its twin (len={length})")
        edge = length == 33_554_432
        shape = f"len={length} H={H} W={W} U={U}"
        if edge:
            real = length - 4096
            B = -(-(real * 21 // 20) // 64) * 64
            slots = torch.randperm(B, generator=gen, device=dev)[:real]
            perm = torch.full((B,), length - 1, dtype=torch.int32,
                              device=dev)
            perm[slots] = torch.randperm(real, generator=gen, device=dev) \
                .to(torch.int32)
            valid = torch.zeros(B, dtype=torch.bool, device=dev)
            valid[slots] = True
            pos[5, :64] = length - 1 - torch.arange(64, device=dev,
                                                    dtype=torch.int32)
            want = columns.scale_hop_masks_plain(*args)
            got_b = columns.scale_hop_masks(*args, perm=perm, valid=valid)
            if not torch.equal(got_b, want[perm.long()] & valid[:, None]):
                raise AssertionError("binned K4 differs from its twin")
            del got_b
        del got, want
        key = "edge" if edge else "vertex"
        k4[f"{key}_ms"] = cuda_ms(torch, lambda: columns.scale_hop_masks(
            *args), iters=5)
        k4[f"{key}_device_ms"], k4[f"{key}_device_by"] = device_ms(
            torch, lambda: columns.scale_hop_masks(*args), iters=5)
        # base and the update lists read once, thresholds, the
        # [len, H*W] masks written once
        k4[f"{key}_bound_ms"] = bound(length * 4 + H * U * 8 + C * 4
                                      + length * C)[0]
        if edge:
            k4["plain_ms"] = cuda_ms(
                torch, lambda: columns.scale_hop_masks_plain(*args), iters=2)
            bargs = dict(perm=perm, valid=valid)
            k4["binned_ms"] = cuda_ms(torch, lambda: columns.scale_hop_masks(
                *args, **bargs), iters=5)
            k4["binned_device_ms"], _ = device_ms(
                torch, lambda: columns.scale_hop_masks(*args, **bargs),
                iters=5)
            # as the edge call, plus perm and valid read once, B rows out
            k4["binned_bound_ms"] = bound(length * 4 + H * U * 8 + C * 4
                                          + B * 5 + B * C)[0]
            del perm, valid, slots
        del base, pos, t
    out["scale_hop_masks"] = dict(
        source="raphtory_tpu_torch/csrc/masks.cu",
        replaces="raphtory_tpu/engine/hopbatch.py:2129",
        max_abs_err=0.0, library_ms=None, ms=k4["edge_ms"],
        device_ms=k4["edge_device_ms"], plain_ms=k4["plain_ms"],
        edge_cases=k4_edge_cases(torch, columns, dev), calls=k4,
        shape=f"len=33554432 H={H} W={W} U=65536 (len=5308416 U=131072 "
              "and binned checked)",
        **dict(zip(("bound_ms", "bound_by"), bound(
            33_554_432 * 4 + H * 65_536 * 8 + C * 4 + 33_554_432 * C))))
    return out


def k4_edge_cases(torch, columns, dev) -> int:
    """K4 bitwise its twin on small payloads, engine-order and binned: a
    row updated in every hop, an update below its row's base, positions
    < 0 and >= len, the (0,
    INT32_MIN) pads, unwindowed (0) and extreme thresholds, never-seen and
    INT32_MAX bases, C = 1, 12, 15, 16, 33, 256, 4,112 (past the
    row-mapped pass) and 8,193 (past the thresholds staged in shared
    memory), no updates at all, and updates on the engine's pad rows,
    which no binned slot holds. Returns the count."""
    imin, imax = -2**31, 2**31 - 1
    gen = torch.Generator(device=dev).manual_seed(5)

    def ri(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    cases = 0
    for length, H, W, U in ((37, 3, 4, 6), (200, 3, 5, 9), (64, 2, 8, 0),
                            (1000, 1, 1, 50), (301, 3, 11, 17),
                            (50, 4, 64, 11), (30, 2, 2056, 7),
                            (40, 3, 2731, 5)):
        C = H * W
        base = ri((length,), -50, 50)
        base[::7] = imin
        base[1] = imax
        pos, t = ri((H, U), -3, length + 3), ri((H, U), -60, 60)
        if U:
            pos[:, -2:], t[:, -2:] = 0, imin                  # pads
            pos[:, 0] = 2                                     # every hop
            t[:, 0] = 40 + torch.arange(H, device=dev, dtype=torch.int32)
            pos[-1, 1], t[-1, 1] = 1, -60        # below its INT32_MAX base
            pos[0, 2], pos[0, 3] = -1, length    # outside [0, len)
            pos[0, 4] = length - 1               # an engine pad row
        thr = ri((C,), -55, 55)
        thr[::3] = 0
        if C > 2:
            thr[1], thr[-1] = imin, imax
        real = length - 3
        B = real + 5
        slots = torch.randperm(B, generator=gen, device=dev)[:real]
        perm = torch.full((B,), length - 1, dtype=torch.int32, device=dev)
        perm[slots] = torch.randperm(real, generator=gen, device=dev).to(
            torch.int32)
        valid = torch.zeros(B, dtype=torch.bool, device=dev)
        valid[slots] = True
        args = (base, pos, t, thr, H, W)
        for kw in ({}, dict(perm=perm, valid=valid)):
            got = columns.scale_hop_masks(*args, **kw)
            want = columns.scale_hop_masks_plain(*args)
            if kw:
                want = want[perm.long()] & valid[:, None]
            if not torch.equal(got, want):
                raise AssertionError(f"K4 differs from its twin (len="
                                     f"{length}, C={C}, U={U}, binned="
                                     f"{bool(kw)})")
            cases += 1
    return cases


def pcpm_kernels(torch, np, columns, minplus, segment, gab, ldbc, gab_view,
                 dev):
    """The destination-binned (PCPM) kernels against their twins at the
    shapes of the ``pcpm`` phase's paths, with the layouts the knobs'
    default (auto) gives them: KB1 (host-column form) and K2b-P on the
    headline tables (P 16, pre-aggregated), K5-P on the GAB CC shape, K6-P
    (unit and weighted, directed and undirected) on the LDBC shape, K7-P on
    the cold GAB View's layout. KB1, K5-P, K6-P and K7-P's min/max and int
    sums with ``torch.equal``; float sums within rtol 1e-5 / atol 1e-7 —
    and K2b-P bitwise equal to K2b over the same masks (its walk keeps
    K2b's order)."""
    from raphtory_tpu_torch.engine import bsp
    from raphtory_tpu_torch.ops import partition

    rng = np.random.default_rng(5)
    out = {}
    budget = partition.tile_budget_bytes()

    def layout_of(t):
        if not partition.pcpm_enabled(t.m_pad, "auto"):
            raise AssertionError(f"m_pad {t.m_pad} does not bin under auto")
        return partition.build_layout(
            t.e_src, t.e_dst, t.n_pad, t.m,
            partition.partition_count(t.n_pad, budget))

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def binned_masks(t, lay, C):
        me = rng.random((t.m_pad, C)) < 0.6
        me[t.m:] = False
        if C > 1:
            me[:, 1] = False                  # an all-masked column
        mv = rng.random((t.n_pad, C)) < 0.8
        mv[t.n:] = False
        return (put(me[lay.perm] & lay.valid[:, None]), put(mv), put(me),
                int(me.sum()))

    # ---- KB1 (host-column form) at the headline: H 4 x W 3 (timed, in
    # turns with the parent's mask step under --parent) and C 70 (two
    # launches), the column bounds by value
    lay = layout_of(gab)
    spec = lay.spec
    m, n, B = gab.m_pad, gab.n_pad, lay.B
    info = np.iinfo(np.int32)
    vals = np.concatenate([[info.min, info.max], rng.integers(-5000, 5000,
                                                              60)])
    pv = (put(lay.perm), put(lay.valid))
    kb1_err, timed_kb1 = 0.0, None
    for H, W in ((4, 3), (7, 10)):
        C = H * W
        T_col = np.repeat(np.array([info.max - 3, 0, 1000, 4000, -5, 7, 64],
                                   np.int64)[:H], W)
        w_col = np.tile(np.array([-1, 0, 1 << 40, 300, 2_000, 86_400, 7, 64,
                                  5_000, 1], np.int64)[:W], H)
        bounds = (np.repeat(np.arange(H, dtype=np.int32), W),
                  np.clip(T_col - w_col, info.min, info.max).astype(np.int32),
                  w_col < 0)
        host_cols = (rng.choice(vals, (H, m)).astype(np.int32),
                     rng.random((H, m)) < 0.7,
                     rng.choice(vals, (H, n)).astype(np.int32),
                     rng.random((H, n)) < 0.7)
        cols = [put(a) for a in host_cols]
        tb = [put(a) for a in bounds]
        before = columns.LAUNCHES["bin_masks"]
        got = columns.bin_column_masks(*cols, *bounds, *pv)
        if columns.LAUNCHES["bin_masks"] - before != -(-C // 64):
            raise AssertionError(f"KB1: not one launch a group of 64 columns "
                                 f"(C {C})")
        want = columns.bin_column_masks_plain(*cols, *tb, *pv)
        step, parent_step = column_steps(columns, host_cols, bounds, dev, pv)
        for g, x, y, z in zip(got, want, step(), parent_step()):
            if not (torch.equal(g, x) and torch.equal(g, y)
                    and torch.equal(g, z)):
                raise AssertionError(f"KB1 differs from its twin or from "
                                     f"the dispatch steps' (C {C})")
            kb1_err = max(kb1_err, exact_err(g, x))
        if timed_kb1 is None:
            timed_kb1 = (H, C, cols, bounds, tb, step, parent_step)
    H, C, cols, bounds, tb, step, parent_step = timed_kb1

    def kb1():
        return columns.bin_column_masks(*cols, *bounds, *pv)
    # the fold columns (lat i32 + alive), perm and valid, the column
    # bounds read once; the binned and vertex masks written once
    kb1_bound = bound(H * (m + n) * 5 + B * 5 + C * 17 + (B + n) * C)
    kb1_shape = (f"host-column form B={B} m_pad={m} n_pad={n} H={H} C={C} "
                 f"int32 (P={spec.partitions})")
    if PARENT is not None:
        vs_parent(torch, "fold_columns bin_masks headline", step,
                  parent_step, iters=50, wall=True,
                  shape=kb1_shape + " (the fold columns' upload + the call)",
                  bound_ms=kb1_bound[0])
    out["bin_masks"] = dict(
        source="raphtory_tpu_torch/csrc/masks.cu",
        replaces="raphtory_tpu/engine/hopbatch.py:283",
        max_abs_err=kb1_err, ms=cuda_ms(torch, kb1, 50),
        device_ms=device_ms(torch, kb1, 50)[0],
        plain_ms=cuda_ms(torch, lambda: columns.bin_column_masks_plain(
            *cols, *tb, *pv)),
        library_ms=None, columns=C, shape=kb1_shape,
        upload_and_call_ms=cuda_ms(torch, step, 50),
        **dict(zip(("bound_ms", "bound_by"), kb1_bound)))

    # ---- K2b-P at the headline (pre-aggregated), against its twin and
    # bitwise against K2b over the same masks in engine order; then on a
    # layout that does not pre-aggregate, and at other column counts
    be = lay.device_edges(dev)
    me_b, mv, me, nnz = binned_masks(gab, lay, C)
    rd = put((rng.random((n, C)) * 1e-4).astype(np.float32))
    flat_edges = tuple(put(a) for a in (gab.e_src, gab.e_dst,
                                        gab.in_indptr))
    got = columns.binned_pull_sum(me_b, rd, be)
    want = columns.binned_pull_sum_plain(me_b, rd, be)
    flat = columns.column_pull_sum(me, rd, *flat_edges)
    if not within_tol(got, want):
        raise AssertionError(f"K2b-P differs from its twin: max abs err "
                             f"{exact_err(got, want)}")
    if not torch.equal(got, flat):
        raise AssertionError("K2b-P differs from K2b over the same masks")
    k2bp_err = exact_err(got, want)
    k2bp_ms = cuda_ms(torch, lambda: columns.binned_pull_sum(me_b, rd, be))
    cases = {}
    for P in (1024, 4096, n):
        flay = partition.build_layout(gab.e_src, gab.e_dst, n, gab.m, P)
        if not flay.spec.preagg:
            break
    else:
        raise AssertionError("no layout of the headline table without "
                             "pre-aggregation")
    for what, blay, Cs in (("no preagg", flay, (C,)),
                           ("preagg", lay, (1, 9, 36, 129, 300))):
        bb = blay.device_edges(dev)
        for Ck in Cs:
            mk_b, _, mk, _ = binned_masks(gab, blay, Ck)
            rk = put((rng.random((n, Ck)) * 1e-4).astype(np.float32))
            got = columns.binned_pull_sum(mk_b, rk, bb)
            ok = torch.equal(got, columns.column_pull_sum(mk, rk,
                                                          *flat_edges))
            k2bp_err = max(k2bp_err, exact_err(
                got, columns.binned_pull_sum_plain(mk_b, rk, bb)))
            if Ck == 36:      # rd 4 bytes off 16-byte alignment
                buf = torch.empty(rk.numel() + 1, device=dev)
                ro = buf[1:].view(rk.shape)
                ro.copy_(rk)
                ok = ok and torch.equal(columns.binned_pull_sum(mk_b, ro, bb),
                                        got) and torch.equal(
                    columns.column_pull_sum(mk, ro, *flat_edges), got)
            if not ok:
                raise AssertionError(f"K2b-P ({what}, C={Ck}) differs from "
                                     "K2b over the same masks")
            cases[f"{what} C={Ck} P={blay.spec.partitions}"] = True
    U, real = be.U, gab.m
    out["binned_pull_sum"] = dict(
        source="raphtory_tpu_torch/csrc/pagerank_columns.cu",
        replaces="raphtory_tpu/engine/hopbatch.py:242",
        max_abs_err=k2bp_err, ms=k2bp_ms,
        plain_ms=cuda_ms(torch, lambda: columns.binned_pull_sum_plain(
            me_b, rd, be)),
        library_ms=None, bitwise_vs_k2b=cases,
        columns=C, shape=f"B={B} m={real} n_pad={n} C={C} P={spec.partitions} "
              f"cap={spec.cap} cap_u={spec.cap_u} preagg={spec.preagg}",
        **dict(zip(("bound_ms", "bound_by"),
                   k2bp_bound(real, n, C, nnz))))

    compare = superstep_compare(torch, columns, minplus)

    # ---- K5-P at GAB, C = 12
    C = 12
    be = lay.device_edges(dev, reverse=True)
    me_b, mv, _, nnz = binned_masks(gab, lay, C)
    lab = torch.where(mv, put(rng.integers(0, n, (n, C)).astype(np.int32)),
                      minplus.I32_MAX).contiguous()
    step = (lambda st: minplus.binned_cc_superstep(st, me_b, mv, be))
    plain = (lambda st: minplus.binned_cc_superstep_plain(st, me_b, mv, be))
    err = 0.0
    for frozen in ([2], [c for c in range(C) if c != 1]):
        err = max(err, compare("K5-P", "binned_cc_superstep", step, plain,
                               lab, frozen))
    # and on a layout of the same table that does not pre-aggregate
    be_flat = flay.device_edges(dev, reverse=True)
    mf_b, mf_v, _, _ = binned_masks(gab, flay, C)
    err = max(err, compare(
        "K5-P (no preagg)", "binned_cc_superstep",
        lambda st: minplus.binned_cc_superstep(st, mf_b, mf_v, be_flat),
        lambda st: minplus.binned_cc_superstep_plain(st, mf_b, mf_v,
                                                     be_flat), lab, [2]))
    shape = (f"n_pad={n} B={B} C={C} P={spec.partitions} "
             f"preagg={spec.preagg} U={be.U}")
    out["binned_cc_superstep"] = dict(
        source="raphtory_tpu_torch/csrc/minplus_columns.cu",
        replaces="raphtory_tpu/engine/hopbatch.py:572",
        max_abs_err=err, library_ms=None, columns=C, shape=shape,
        **step_times(torch, step, plain, lab, minplus),
        # masks of the real slots (both walks) and the vertex mask, the
        # slot ids and both walks, the bucket sources, state in and out;
        # one compare per masked edge and direction
        **dict(zip(("bound_ms", "bound_by"), bound(
            real * C + n * C + 4 * 4 * real + 2 * 8 * (n + 1) + U * 4
            + 2 * 4 * n * C, 2 * nnz))))

    # ---- K6-P at LDBC, C = 20 (10 hops x 2 windows)
    llay = layout_of(ldbc)
    H, W = 10, 2
    C = H * W
    lb = llay.device_edges(dev, reverse=True)
    me_b, mv, _, nnz = binned_masks(ldbc, llay, C)
    ln, lm = ldbc.n_pad, ldbc.m
    dist = torch.where(
        mv & put(rng.random((ln, C)) < 0.3),
        put(rng.integers(0, 5, (ln, C)).astype(np.float32)),
        minplus.INF).contiguous()
    ew = put(rng.choice(np.array([-0.5, 0.0, 0.5, 1.0, 2.25, 4.99],
                                 np.float32), (ldbc.m_pad, H))[llay.perm])
    err = 0.0
    for directed in (False, True):
        for w in (None, ew):
            for frozen in ([2], [c for c in range(C) if c != 1]):
                err = max(err, compare(
                    f"K6-P (directed={directed}, weighted={w is not None})",
                    "binned_minplus_superstep",
                    lambda st: minplus.binned_minplus_superstep(
                        st, me_b, mv, lb, directed, w, W),
                    lambda st: minplus.binned_minplus_superstep_plain(
                        st, me_b, mv, lb, directed, w, W), dist, frozen))
    lspec = llay.spec
    shape = (f"n_pad={ln} B={llay.B} C={C} weighted undirected "
             f"P={lspec.partitions} preagg={lspec.preagg} U={lb.U}")
    out["binned_minplus_superstep"] = dict(
        source="raphtory_tpu_torch/csrc/minplus_columns.cu",
        replaces="raphtory_tpu/engine/hopbatch.py:653",
        max_abs_err=err, library_ms=None, columns=C, shape=shape,
        **step_times(
            torch,
            lambda st: minplus.binned_minplus_superstep(st, me_b, mv, lb,
                                                        False, ew, W),
            lambda st: minplus.binned_minplus_superstep_plain(
                st, me_b, mv, lb, False, ew, W), dist, minplus),
        # as K5-P plus the real slots' [B, H] weights; an add and a compare
        # per masked edge and direction
        **dict(zip(("bound_ms", "bound_by"), bound(
            lm * C + ln * C + 4 * 4 * lm + 2 * 8 * (ln + 1) + lb.U * 4
            + 2 * 4 * ln * C + 4 * lm * H, 4 * nnz))))

    # ---- K7-P on the cold GAB View's layout: PageRank's f32 sum (k = 1),
    # min/max and int sums (k = 1, 3), and against K7 over the same edges
    with knobs(RTPU_PCPM=None):
        vlay = bsp._view_layout(gab_view)
    if vlay is None:
        raise AssertionError("the cold GAB View does not bin under auto")
    vb = vlay.device_edges(dev)
    walk = segment.PartitionWalk(vb.in_indptr, vb.in_order, vb.perm,
                                 vb.valid)
    vm, vn, vreal = gab_view.m_pad, gab_view.n_pad, int(gab_view.m_active)
    flat = segment.SegmentCSR(put(gab_view.e_dst),
                              put(gab_view.in_indptr.astype(np.int64)), None)
    err, bad = 0.0, []
    for op, dt, k in (("sum", "f32", 1), ("sum", "i32", 3), ("min", "i32", 1),
                      ("max", "f32", 3), ("min", "f32", 1)):
        mask = rng.random((k, vm)) < 0.7
        mask[:, vreal:] = False
        x = ((rng.random(k * vm) * 1e-4).astype(np.float32) if dt == "f32"
             else rng.integers(-10**6, 10**6, k * vm).astype(np.int32))
        x, mask = put(x), put(mask.reshape(-1))
        got = segment.partition_reduce(x, walk, op, mask, k)
        want = segment.partition_reduce_plain(x, walk, op, mask, k)
        ref = segment.segment_combine(x, flat, op, mask, k)
        ok = (within_tol(got, want) if op == "sum" and dt == "f32"
              else torch.equal(got, want)) and torch.equal(got, ref)
        err = max(err, exact_err(got, want))
        if not ok:
            bad.append(f"{op} {dt} k={k} (max abs err "
                       f"{exact_err(got, want)})")
    if bad:
        raise AssertionError(f"K7-P differs from its twin or K7: {bad}")
    mask = put(np.arange(vm) < vreal)
    x = put((rng.random(vm) * 1e-4).astype(np.float32))
    ids = put(gab_view.e_dst).long()
    xm = torch.where(mask, x, 0.0)
    vspec = vlay.spec

    def k7p():
        return segment.partition_reduce(x, walk, "sum", mask, 1)
    # the real edges' payload and mask, their walk entries, perm and
    # valid, the output; one add per edge
    k7p_bound = bound(vreal * 5 + vreal * 9 + (vn + 1) * 8 + vn * 4, vreal)
    out["partition_segment_reduce"] = dict(
        source="raphtory_tpu_torch/csrc/segment.cu",
        replaces="raphtory_tpu/ops/segment.py:116",
        max_abs_err=err, ms=cuda_ms(torch, k7p),
        device_ms=device_ms(torch, k7p)[0],
        plain_ms=cuda_ms(torch, lambda: segment.partition_reduce_plain(
            x, walk, "sum", mask, 1)),
        # one call: index_add_ of the pre-masked payload at destination
        library_ms=cuda_ms(torch, lambda: torch.zeros(
            vn, device=dev).index_add_(0, ids, xm)),
        shape=f"sum f32 k=1 F=1 n_pad={vn} m_pad={vm} B={vlay.B} "
              f"P={vspec.partitions}",
        **dict(zip(("bound_ms", "bound_by"), k7p_bound)))
    return out


def check_launched(path: str, launches: dict, kernels) -> None:
    """Fail if a kernel of ``path`` was launched no time in its run."""
    idle = [k for k in kernels if launches[k] <= 0]
    if idle:
        raise AssertionError(f"{path}: kernels of the path never launched: "
                             f"{idle} ({launches})")


def one_launch_a_superstep(path: str, launches: dict, kernel: str,
                           steps: int) -> None:
    """Fail unless ``kernel`` launched once a superstep in a one-dispatch
    sweep of ``steps`` supersteps."""
    if launches[kernel] != steps:
        raise AssertionError(f"{path}: {launches[kernel]} {kernel} launches "
                             f"for {steps} supersteps")


def exact_err(got, want) -> float:
    """Max abs difference of two equal-shaped tensors, 0 where they are
    equal (so inf == inf counts as no error)."""
    import torch

    diff = torch.where(got == want, 0.0,
                       (got.double() - want.double()).abs())
    return float(diff.max()) if diff.numel() else 0.0


def superstep_compare(torch, columns, minplus):
    """``compare(what, name, step, plain, x0, frozen)``: one superstep of
    the kernel (``step``, which must add exactly one launch to
    ``LAUNCHES[name]``) and of its twin from the same state, columns
    ``frozen`` halted before it; state, halted flags and the all-halted
    flag bitwise the twin's. Returns the max abs err against the twin."""

    def compare(what, name, step, plain, x0, frozen):
        states = []
        for i, fn in enumerate((step, plain)):
            st = minplus.min_state(x0.clone())
            st.halted[frozen] = True
            launched = columns.LAUNCHES[name]
            fn(st)
            if i == 0 and columns.LAUNCHES[name] - launched != 1:
                raise AssertionError(f"{what}: not one launch a superstep "
                                     f"({columns.LAUNCHES[name] - launched})")
            states.append(st)
        got, other = states
        for a, b, part in ((got.cur, other.cur, "state"),
                           (got.halted, other.halted, "halted"),
                           (got.done, other.done, "done")):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: {part} differs from its twin "
                                     f"(frozen {frozen})")
        return exact_err(got.cur, other.cur)

    return compare


def step_times(torch, step, plain, x0, minplus):
    """``ms`` (CUDA events over 20 calls: the wrapper's host path counts
    in), ``device_ms`` (the profiler's device time a call), ``plain_ms``,
    each from its own state started at ``x0``."""
    sts = [minplus.min_state(x0.clone()) for _ in range(2)]
    out = dict(ms=cuda_ms(torch, lambda: step(sts[0])),
               plain_ms=cuda_ms(torch, lambda: plain(sts[1])))
    out["device_ms"], out["device_by"] = device_ms(torch,
                                                   lambda: step(sts[0]))
    return out


def minplus_kernels(torch, np, columns, minplus, gab, ldbc, dev):
    """K5 at the GAB CC shapes, K6 and K6w at the LDBC traversal shapes,
    each against its twin with ``torch.equal``."""
    from raphtory_tpu_torch.engine.device_sweep import DeviceEdges

    rng = np.random.default_rng(1)
    out = {}

    def edges_of(t):
        return DeviceEdges(*(torch.from_numpy(getattr(t, f)).to(dev)
                             for f in DeviceEdges._fields))

    def masks(t, C):
        me = rng.random((t.m_pad, C)) < 0.6
        me[t.m:] = False                      # pad edges carry no mask
        if C > 1:
            me[:, 1] = False                  # an all-masked column
        mv = rng.random((t.n_pad, C)) < 0.8
        mv[t.n:] = False                      # pad rows
        return (torch.from_numpy(me).to(dev), torch.from_numpy(mv).to(dev),
                int(me.sum()))

    compare = superstep_compare(torch, columns, minplus)

    # ---- K5 at GAB: n_pad 32,768, m_pad 327,680, C = 12 (12 hops x 1)
    C = 12
    e = edges_of(gab)
    me, mv, nnz = masks(gab, C)
    lab = torch.where(mv, torch.from_numpy(rng.integers(
        0, gab.n_pad, (gab.n_pad, C)).astype(np.int32)).to(dev),
        minplus.I32_MAX).contiguous()
    step = (lambda st: minplus.cc_superstep(st, me, mv, e))
    plain = (lambda st: minplus.cc_superstep_plain(st, me, mv, e))
    err = 0.0
    for frozen in ([2], [c for c in range(C) if c != 1]):
        err = max(err, compare("K5", "cc_superstep", step, plain, lab,
                               frozen))
    # every column unchanged → all halt, and the flag is set
    settled = minplus.min_state(torch.full_like(lab, minplus.I32_MAX))
    minplus.cc_superstep(settled, me, torch.zeros_like(mv), e)
    if not bool(settled.done) or not bool(settled.halted.all()):
        raise AssertionError("K5: every column settled, flag unset")
    n, m = gab.n_pad, gab.m
    shape = f"n_pad={n} m_pad={gab.m_pad} C={C}"
    out["cc_superstep"] = dict(
        source="raphtory_tpu_torch/csrc/minplus_columns.cu",
        replaces="raphtory_tpu/engine/hopbatch.py:538",
        max_abs_err=err, library_ms=None, columns=C, shape=shape,
        **step_times(torch, step, plain, lab, minplus),
        # mask and vertex mask, edge ids, both CSRs and the source index,
        # state in and out, each once; one compare per masked edge and
        # direction
        **dict(zip(("bound_ms", "bound_by"), bound(
            m * C + n * C + 3 * 4 * m + 2 * 8 * (n + 1) + 2 * 4 * n * C,
            2 * nnz))))

    # ---- K6 at LDBC: C = 20 (10 hops x 2 windows), unit and weighted,
    # directed and undirected
    H, W = 10, 2
    C = H * W
    e = edges_of(ldbc)
    me, mv, nnz = masks(ldbc, C)
    dist = torch.where(
        mv & torch.from_numpy(rng.random((ldbc.n_pad, C)) < 0.3).to(dev),
        torch.from_numpy(rng.integers(0, 5, (ldbc.n_pad, C)).astype(
            np.float32)).to(dev), minplus.INF).contiguous()
    ew = torch.from_numpy(rng.choice(np.array(
        [-0.5, 0.0, 0.5, 1.0, 2.25, 4.99], np.float32),
        (ldbc.m_pad, H))).to(dev)
    err = 0.0
    for directed in (False, True):
        for w in (None, ew):
            for frozen in ([2], [c for c in range(C) if c != 1]):
                err = max(err, compare(
                    f"K6 (directed={directed}, weighted={w is not None})",
                    "minplus_superstep",
                    lambda st: minplus.minplus_superstep(
                        st, me, mv, e, directed, w, W),
                    lambda st: minplus.minplus_superstep_plain(
                        st, me, mv, e, directed, w, W), dist, frozen))
    n, m = ldbc.n_pad, ldbc.m
    shape = f"n_pad={n} m_pad={ldbc.m_pad} C={C} weighted undirected"
    out["minplus_superstep"] = dict(
        source="raphtory_tpu_torch/csrc/minplus_columns.cu",
        replaces="raphtory_tpu/engine/hopbatch.py:620",
        max_abs_err=err, library_ms=None, columns=C, shape=shape,
        **step_times(
            torch,
            lambda st: minplus.minplus_superstep(st, me, mv, e, False, ew,
                                                 W),
            lambda st: minplus.minplus_superstep_plain(st, me, mv, e, False,
                                                       ew, W), dist, minplus),
        # as K5 plus the [m_pad, H] weights; an add and a compare per
        # masked edge and direction
        **dict(zip(("bound_ms", "bound_by"), bound(
            m * C + n * C + 3 * 4 * m + 2 * 8 * (n + 1) + 2 * 4 * n * C
            + 4 * m * H, 4 * nnz))))

    # ---- K6w at LDBC: len m_pad, H = 10, U = 8,192 weight updates a hop;
    # the same at a binned length (the LDBC layout's B) and an H 70 call
    # (two touch-word groups chained), each on both h0 settings
    from raphtory_tpu_torch.ops import partition

    def k6w_inputs(length, H, U, real):
        base = torch.from_numpy(rng.random(length).astype(np.float32)).to(
            dev)
        pos = np.full((H, U), 2**31 - 1, np.int32)
        val = np.zeros((H, U), np.float32)
        for h in range(H):
            k = int(rng.integers(U // 2, U))
            pos[h, :k] = rng.choice(real, k, replace=False)
            val[h, :k] = rng.random(k) * 5 - 0.5
        return (base, *(torch.from_numpy(a).to(dev) for a in (pos, val)),
                int((pos < length).sum()))

    U = 8192
    length = ldbc.m_pad
    B = partition.build_layout(ldbc.e_src, ldbc.e_dst, ldbc.n_pad, ldbc.m,
                               8).B
    calls = {"unbinned": (length, H, U, ldbc.m),
             "binned": (B, H, U, B), "h70": (50_000, 70, 512, 50_000)}
    err, k6w_calls = 0.0, {}
    for what, (n_rows, Hc, Uc, real) in calls.items():
        base, d_pos, d_val, valid = k6w_inputs(n_rows, Hc, Uc, real)
        for h0 in (False, True):
            before = columns.LAUNCHES["weights_from_deltas"]
            got = columns.weights_from_deltas(base, d_pos, d_val, Hc, h0)
            if columns.LAUNCHES["weights_from_deltas"] - before != 1:
                raise AssertionError("K6w: not one launch a call")
            want = columns.weights_from_deltas_plain(base, d_pos, d_val, Hc,
                                                     h0)
            for g, x in zip(got, want):
                if not torch.equal(g, x):
                    raise AssertionError(f"K6w differs from its twin "
                                         f"({what}, h0={h0})")
                err = max(err, exact_err(g, x))
        k6w_calls[what] = dict(len=n_rows, H=Hc, U=Uc, live=valid)
        if what == "unbinned":
            timed = (base, d_pos, d_val, valid)
    base, d_pos, d_val, valid = timed
    # base in, live delta rows, the [len, H] block and the state out
    k6w_bound = bound(length * 4 + valid * 8 + length * H * 4 + length * 4)

    def k6w():
        return columns.weights_from_deltas(base, d_pos, d_val, H, True)
    k6w_dev, k6w_by = device_ms(torch, k6w)
    out["weights_from_deltas"] = dict(
        source="raphtory_tpu_torch/csrc/masks.cu",
        replaces="raphtory_tpu/engine/hopbatch.py:374",
        max_abs_err=err, ms=cuda_ms(torch, k6w), device_ms=k6w_dev,
        device_by=k6w_by,
        plain_ms=cuda_ms(torch, lambda: columns.weights_from_deltas_plain(
            base, d_pos, d_val, H, True), iters=3),
        library_ms=None, shape=f"len={length} H={H} U={U} h0",
        calls=k6w_calls,
        **dict(zip(("bound_ms", "bound_by"), k6w_bound)))
    return out


def timed_sweep(torch, columns, make, hops, windows, chunks, reps=3,
                **run_kw):
    """Best of ``reps`` cold engines after one warm-up, each folding cold
    (the fold cache emptied before it); the launch counts cover the last
    timed sweep alone (zeroed just before it)."""
    make().run(hops, windows, chunks=chunks, **run_kw)
    torch.cuda.synchronize()
    reps_out = []
    for _ in range(reps):
        cold_fold()
        hb = make()
        columns.reset_launches()
        t0 = time.perf_counter()
        res, steps = hb.run(hops, windows, chunks=chunks, **run_kw)
        torch.cuda.synchronize()
        reps_out.append(fold_stats(hb, time.perf_counter() - t0))
        launches = dict(columns.LAUNCHES)
    cold_fold()
    best = min(reps_out, key=lambda r: r["sweep_s"])
    n_views = len(hops) * len(windows)
    return res, steps, launches, dict(
        best, views=n_views, views_per_s=n_views / best["sweep_s"],
        repeat_sweep_s=[r["sweep_s"] for r in reps_out], supersteps=steps,
        launches=launches)


def bitwise_vs_cpu(what, got, steps, ref, ref_steps) -> None:
    import torch

    if not torch.equal(got.cpu(), ref) or steps != ref_steps:
        raise AssertionError(f"{what} differs from the CPU run (steps "
                             f"{steps} vs {ref_steps})")


def phase_cc_range(torch, np, columns, log, dev):
    from raphtory_tpu_torch.engine.hopbatch import HopBatchedCC

    hops, _ = headline_grid()
    windows = [GAB_SPAN]
    labels, steps, launches, stats = timed_sweep(
        torch, columns, lambda: HopBatchedCC(log, max_steps=50, device=dev),
        hops, windows, chunks=1)
    check_launched("cc_range", launches, CC_KERNELS)
    one_launch_a_superstep("cc_range", launches, "cc_superstep", steps)
    cold_fold()
    ref, ref_steps = HopBatchedCC(log, max_steps=50, device="cpu").run(
        hops, windows)
    bitwise_vs_cpu("cc_range", labels, steps, ref, ref_steps)
    lab = labels.cpu().numpy()
    n = int((lab[-1] != np.iinfo(np.int32).max).sum())
    biggest = int(np.unique(lab[-1][lab[-1] != np.iinfo(np.int32).max],
                            return_counts=True)[1].max())
    emit("cc_range", **stats, vertices_last_view=n,
         biggest_component_last_view=biggest)
    return launches


LDBC_SPAN = 2_600_000
LDBC_SEEDS = (0, 1, 2, 3)


def ldbc_log():
    from raphtory_tpu_torch.utils.synth import ldbc_like_log

    return ldbc_like_log(n_persons=10_000, n_knows=120_000, t_span=LDBC_SPAN,
                         weighted=True)


def phase_ldbc_traversal(torch, np, columns, log, dev):
    from raphtory_tpu_torch.engine.hopbatch import (HopBatchedBFS,
                                                    HopBatchedSSSP)

    hops = [int(T) for T in
            np.linspace(0.5 * LDBC_SPAN, LDBC_SPAN, 10).astype(np.int64)]
    windows = [1_300_000, 604_800]
    seeds = LDBC_SEEDS
    runs = {
        "bfs": (lambda d: HopBatchedBFS(log, seeds, directed=False,
                                        max_steps=32, device=d), 1),
        "sssp": (lambda d: HopBatchedSSSP(log, seeds, "weight",
                                          directed=False, max_steps=32,
                                          device=d), 1),
        "sssp_chunks2": (lambda d: HopBatchedSSSP(
            log, seeds, "weight", directed=False, max_steps=32, device=d),
            2),
    }
    total = {k: 0 for k in columns.LAUNCHES}
    result = {}
    for name, (make, chunks) in runs.items():
        dist, steps, launches, stats = timed_sweep(
            torch, columns, lambda make=make: make(dev), hops, windows,
            chunks=chunks)
        cold_fold()
        ref, ref_steps = make("cpu").run(hops, windows, chunks=chunks)
        bitwise_vs_cpu(f"ldbc_traversal {name}", dist, steps, ref,
                       ref_steps)
        if chunks == 1:
            one_launch_a_superstep(f"ldbc_traversal {name}", launches,
                                   "minplus_superstep", steps)
        if name.startswith("sssp") and \
                launches["weights_from_deltas"] != chunks:
            raise AssertionError(f"ldbc_traversal {name}: "
                                 f"{launches['weights_from_deltas']} K6w "
                                 f"launches for {chunks} dispatches")
        reached = int(torch.isfinite(ref[-1]).sum())
        if reached <= len(seeds):
            raise AssertionError(f"ldbc {name}: only {reached} reached")
        for k, v in launches.items():
            total[k] += v
        result[name] = dict(stats, reached_last_view=reached)
    check_launched("ldbc_traversal", total,
                   ("masks_from_deltas", "minplus_superstep"))
    check_launched("ldbc_traversal sssp", result["sssp"]["launches"],
                   SSSP_KERNELS)
    tables = runs["bfs"][0]("cpu").tables
    emit("ldbc_traversal", n=tables.n, m=tables.m, n_pad=tables.n_pad,
         m_pad=tables.m_pad, runs=result, launches=total)
    return total


def phase_headline(torch, np, columns, HopBatchedPageRank, log, dev):
    hops, windows = headline_grid()
    n_views = len(hops) * len(windows)
    kw = dict(tol=1e-7, max_steps=20)
    HopBatchedPageRank(log, device=dev, **kw).run(
        hops, windows, chunks=3, warm_start=True)      # warm-up
    torch.cuda.synchronize()
    reps = []
    for _ in range(3):
        cold_fold()
        hb = HopBatchedPageRank(log, device=dev, **kw)
        # the counts of this sweep alone: zeroed just before it, read
        # just after it
        columns.reset_launches()
        t0 = time.perf_counter()
        ranks, steps = hb.run(hops, windows, chunks=3, warm_start=True)
        torch.cuda.synchronize()
        reps.append(fold_stats(hb, time.perf_counter() - t0))
        launches = dict(columns.LAUNCHES)
    check_launched("headline", launches, PAGERANK_KERNELS)
    ranks = ranks.cpu()
    cold_fold()
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
    best = min(reps, key=lambda r: r["sweep_s"])
    emit("headline", n=hb.tables.n, m=hb.tables.m, n_pad=hb.tables.n_pad,
         m_pad=hb.tables.m_pad, views=n_views,
         views_per_s=n_views / best["sweep_s"], **best,
         repeat_sweep_s=[r["sweep_s"] for r in reps], supersteps=steps,
         launches=launches, max_abs_err_vs_cpu=float(err.max()))
    return launches


def phase_job(torch, np, columns, dev):
    from raphtory_tpu_torch.algorithms import SSSP, ConnectedComponents, \
        PageRank
    from raphtory_tpu_torch.core.service import TemporalGraph
    from raphtory_tpu_torch.jobs.manager import AnalysisManager, RangeQuery
    from raphtory_tpu_torch.utils.synth import ldbc_like_log

    def run_job(log, prog, q, kernels):
        mgr = AnalysisManager(TemporalGraph(log, device=dev), device=dev)
        columns.reset_launches()
        cold_fold()   # the CC job repeats the PageRank job's log and grid
        t0 = time.perf_counter()
        job = mgr.submit(prog, q)
        if not job.wait(600):
            raise AssertionError("job did not finish in 600 s")
        seconds = time.perf_counter() - t0
        launches = dict(columns.LAUNCHES)
        rows = mgr.results(job.id)
        n_rows = len(range(q.start, q.end + 1, q.jump)) * len(q.windows)
        if job.status != "done" or len(rows) != n_rows:
            raise AssertionError(f"{type(prog).__name__} job {job.status}: "
                                 f"{len(rows)} rows, error {job.error}")
        check_launched(f"{type(prog).__name__} job", launches, kernels)
        return rows, dict(status=job.status, rows=len(rows),
                          steps=rows[0]["steps"], launches=launches,
                          job_s=seconds, views_per_s=len(rows) / seconds)

    gab = past_cap_log()
    q = RangeQuery(start=40_000, end=100_000, jump=10_000,
                   windows=(100_000, 20_000, 5_000))
    rows, pr = run_job(gab, PageRank(tol=1e-7, max_steps=20), q,
                       PAGERANK_KERNELS)
    if any(abs(r["result"]["sum"] - 1.0) > 1e-4 for r in rows):
        raise AssertionError("job rank sums off 1")
    rows, cc = run_job(gab, ConnectedComponents(max_steps=50), q,
                       CC_KERNELS)
    if any(r["result"]["vertices"] and not r["result"]["clusters"]
           for r in rows):
        raise AssertionError("CC job rows without clusters")
    ldbc = ldbc_like_log(n_persons=2_000, n_knows=20_000, t_span=100_000,
                         weighted=True)
    rows, sssp = run_job(ldbc, SSSP(seeds=(0, 1), weight_prop="weight",
                                    directed=False, max_steps=32),
                         RangeQuery(start=50_000, end=100_000, jump=10_000,
                                    windows=(100_000, 30_000)),
                         SSSP_KERNELS)
    if not any(r["result"]["reached"] > 2 for r in rows):
        raise AssertionError("SSSP job reached no vertex past its seeds")
    # one view past the columnar route's 1,024-view cap: the route
    # declines and the job runs on the resident DeviceSweep (one K9a chunk
    # apply and one K9b call a hop, then the supersteps); its sweep is
    # kept to read its fold and dispatch seconds
    from raphtory_tpu_torch.jobs import manager

    q = RangeQuery(**PAST_CAP_QUERY)
    sweeps, made = [], manager.DeviceSweep
    manager.DeviceSweep = lambda *a, **kw: sweeps.append(
        made(*a, **kw)) or sweeps[-1]
    try:
        rows, past = run_job(gab, PageRank(tol=1e-7, max_steps=20), q,
                             RESIDENT_KERNELS)
    finally:
        manager.DeviceSweep = made
    if past["launches"]["masks_from_deltas"] or len(rows) != 1_025:
        raise AssertionError("past-cap job took the columnar route")
    if any(abs(r["result"]["sum"] - 1.0) > 1e-4 for r in rows):
        raise AssertionError("past-cap job rank sums off 1")
    ds = sweeps[-1]
    past.update(fold_s=ds.fold_seconds, dispatch_s=ds.dispatch_seconds,
                ship_bytes=ds.ship_bytes, n_pad=ds.n_pad, m_pad=ds.m_pad,
                cap_v=ds.cap_v, cap_e=ds.cap_e)
    # the same job on the CPU twins: every row within the PageRank
    # tolerance, equal supersteps
    cpu_rows, past["cpu_job_s"] = past_cap_cpu_rows()
    compare_rows("past-cap job", rows, cpu_rows)
    emit("job", pagerank=pr, cc=cc, sssp=sssp, pagerank_past_cap=past)
    return past["launches"]


def k7_launches() -> int:
    """K7's launches so far, every payload dtype."""
    from raphtory_tpu_torch.ops import columns

    return (columns.LAUNCHES["segment_combine"]
            + columns.LAUNCHES["segment_combine_i64"])


def within_tol(got, want) -> bool:
    """The float-sum tolerance: |got - want| <= 1e-7 + 1e-5 |want|."""
    err = (got.double() - want.double()).abs()
    return not bool((err > 1e-7 + 1e-5 * want.double().abs()).any())


def past_cap_log():
    """The ``job`` phase's GAB log, whose 1,025-view PageRank Range runs
    on the resident ``DeviceSweep`` (the past-cap route)."""
    from raphtory_tpu_torch.utils.synth import gab_like_log

    return gab_like_log(3_000, 30_000, seed=3, t_span=100_000)


#: the past-cap job's query (``phase_job``)
PAST_CAP_QUERY = dict(start=48_800, end=100_000, jump=50, windows=(20_000,))
#: the child process running the past-cap job on the CPU twins
#: (``start_past_cap_cpu``), started before the kernels are built
PAST_CAP_CPU = None
#: the child's program: the past-cap job on the CPU, its rows and wall
#: seconds as one JSON line
PAST_CAP_CPU_CODE = """
import json, os, sys, time
os.nice(19)
import torch
torch.set_num_threads(1)
import chip_smoke as cs
from raphtory_tpu_torch.algorithms import PageRank
from raphtory_tpu_torch.core.service import TemporalGraph
from raphtory_tpu_torch.jobs.manager import AnalysisManager, RangeQuery
mgr = AnalysisManager(TemporalGraph(cs.past_cap_log(), device="cpu"),
                      device="cpu")
t0 = time.perf_counter()
job = mgr.submit(PageRank(tol=1e-7, max_steps=20),
                 RangeQuery(**cs.PAST_CAP_QUERY))
if not job.wait(1200) or job.status != "done":
    sys.exit(f"CPU past-cap job {job.status}: {job.error}")
print(json.dumps(dict(job_s=time.perf_counter() - t0,
                      rows=mgr.results(job.id))))
"""


def start_past_cap_cpu():
    """Start the past-cap job on the CPU twins in a child process (one
    torch thread, lowest priority), so that its 1,025 reference rows are
    made while the kernels build; ``phase_job`` reads them."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.Popen([sys.executable, "-c", PAST_CAP_CPU_CODE],
                            cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def past_cap_cpu_rows():
    """The CPU reference of the past-cap job (``start_past_cap_cpu``'s
    child): its rows and wall seconds."""
    out, err = PAST_CAP_CPU.communicate(timeout=1200)
    if PAST_CAP_CPU.returncode:
        raise AssertionError(f"CPU past-cap job exited "
                             f"{PAST_CAP_CPU.returncode}: {err[-2000:]}")
    got = json.loads(out.strip().splitlines()[-1])
    return got["rows"], got["job_s"]


def past_cap_shape(dev) -> tuple:
    """``(n_pad, m_pad)`` of the past-cap job's resident buffers."""
    from raphtory_tpu_torch.engine.device_sweep import GlobalTables
    from raphtory_tpu_torch.core.sweep import SweepBuilder

    t = GlobalTables(SweepBuilder(past_cap_log(), track_rows=False,
                                  preseed_pairs=True))
    return t.n_pad, t.m_pad


def k9a_case(torch, np, resident, rng, n_pad, m_pad, cap_v, cap_e, tdt, tt,
             dev) -> dict:
    """One K9a chunk (rows over half to all of each capacity, an index
    past the buffer and a negative one, times at the dtype's limits)
    staged as the path stages it (``pack_chunk`` in pinned memory, one
    non-blocking upload) and applied, held BITWISE against the twin on the
    same chunk."""
    info = np.iinfo(tdt)
    edge = np.array([info.min, info.min + 1, -5, 0, 7, info.max - 1,
                     info.max], tdt)

    def rows(cap, length):
        kk = min(int(rng.integers(cap // 2, cap + 1)), length)
        idx = rng.choice(length, kk, replace=False).astype(np.int32)
        if kk >= 3:
            idx[0], idx[1] = length, -1                 # skipped
        return (idx, rng.choice(edge, kk).astype(tdt), rng.random(kk) < 0.5,
                rng.choice(edge, kk).astype(tdt))

    arrays = rows(cap_v, n_pad) + rows(cap_e, m_pad)
    live = sum(int(((a >= 0) & (a < ln)).sum())
               for a, ln in ((arrays[0], n_pad), (arrays[4], m_pad)))
    packed = resident.pack_chunk(arrays, cap_v, cap_e, tt, pin=True)
    padded = tuple(a.numpy().copy() for a in packed.arrays())
    base = tuple(torch.from_numpy(rng.choice(edge, ln).astype(tdt)).to(dev)
                 if i % 3 != 1 else
                 torch.from_numpy(rng.random(ln) < 0.5).to(dev)
                 for i, ln in enumerate((n_pad,) * 3 + (m_pad,) * 3))
    got = tuple(b.clone() for b in base)
    want = tuple(b.clone() for b in base)
    resident.apply_delta_chunk(got, packed._replace(
        data=packed.data.to(dev, non_blocking=True)))
    on_card = tuple(torch.from_numpy(a).to(dev) for a in padded)
    resident.apply_delta_chunk_plain(want, on_card)
    err = 0.0
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"K9a differs from its twin (n_pad="
                                 f"{n_pad}, {tdt.__name__})")
        err = max(err, exact_err(g, w))
    return dict(err=err, got=got, want=want, packed=packed,
                on_card=on_card, live=live, cap_v=cap_v,
                cap_e=cap_e, n_pad=n_pad, m_pad=m_pad,
                shape=f"n_pad={n_pad} m_pad={m_pad} cap_v={cap_v} "
                      f"cap_e={cap_e} {tdt.__name__} live={live}")


def sync_check(torch, np, resident, gab, view_shape, dev) -> dict:
    """Synchronizing calls under ``torch.cuda.set_sync_debug_mode("error")``
    (it raises on one) in three steps: one resident hop of the past-cap
    job's sweep — its chunk upload (``DeviceSweep._apply_staged``: one
    non-blocking copy from pinned memory) plus K9a, then K9b; the cold
    View's mask step at ``view_shape`` (``(k, n_pad, m_pad)``: both masks'
    bits from one pinned buffer in one non-blocking copy, then one K8u
    launch, as ``bsp.run_async`` takes it); and the host-column route's
    mask step (``hopbatch._dispatch_columns`` at the headline's chunk, H 4
    x C 12, from fold columns staged as ``_fold_columns`` stages them: one
    non-blocking copy, then K3; and KB1's on a layout of the headline
    tables, its device arrays built first). Then each step's synchronizing
    calls counted under ``"warn"``, this tree's and (with ``--parent``)
    the parent's: its cold mask step (two pageable uploads and two K8u
    calls) and its host-column mask step (four pageable uploads and the
    call)."""
    import warnings

    from raphtory_tpu_torch.engine import hopbatch
    from raphtory_tpu_torch.engine.device_sweep import DeviceSweep
    from raphtory_tpu_torch.ops import columns, partition

    ds = DeviceSweep(past_cap_log(), device=dev)
    ds.advance(48_800)                       # the first hop: a full state
    payloads = [ds._fold_hop_inner(T) for T in (48_850, 48_900)]
    if any(p["kind"] != "chunks" for p in payloads):
        raise AssertionError("sync check: a hop took no delta chunk")
    windows = [20_000]
    rng = np.random.default_rng(8)
    # the cold mask step's inputs: a View's masks, packed into pinned
    # memory as ``bsp.run_async`` packs them
    k, n, m = view_shape
    v_masks, e_masks = rng.random((k, n)) < 0.4, rng.random((k, m)) < 0.6
    packed = resident.pack_view_masks(v_masks, e_masks, pin=True)
    # the host-column step's inputs: a headline chunk's fold columns
    # (``gab`` the headline's tables), staged, and their windows
    hops, _ = headline_grid()
    host_cols = (rng.integers(0, GAB_SPAN, (4, gab.m_pad)).astype(np.int32),
                 rng.random((4, gab.m_pad)) < 0.7,
                 rng.integers(0, GAB_SPAN, (4, gab.n_pad)).astype(np.int32),
                 rng.random((4, gab.n_pad)) < 0.7)
    staged = resident.pack(host_cols, pin=True)
    lay = partition.build_layout(gab.e_src, gab.e_dst, gab.n_pad, gab.m,
                                 partition.partition_count(
                                     gab.n_pad, partition.tile_budget_bytes()))
    lay.device_args(dev)                     # built once per layout

    def cold():
        return resident.unpack_view_masks(resident.upload(packed, dev), k,
                                          n, m)

    def columns_step(layout=None):
        return hopbatch._dispatch_columns(gab, staged, hops[:4], WINDOWS,
                                          dev, layout)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ds._apply_staged(payloads[0])
        v_lat, v_alive, _, e_lat, e_alive, _ = ds._bufs
        resident.window_masks(v_lat, v_alive, e_lat, e_alive, 48_850,
                              windows)
        got_v, got_e = cold()
        columns_step()
        columns_step(lay)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not (torch.equal(got_v.cpu(), torch.from_numpy(v_masks))
            and torch.equal(got_e.cpu(), torch.from_numpy(e_masks))):
        raise AssertionError("sync check: the cold mask step's masks differ "
                             "from the host's")

    def count(fn) -> int:
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return sum("synchroniz" in str(w.message) for w in rec)

    def hop():
        ds._apply_staged(payloads[1])
        resident.window_masks(*(ds._bufs[i] for i in (0, 1, 3, 4)), 48_900,
                              windows)

    out = dict(error_mode="passed", chunks=len(payloads[1]["chunks"]),
               warnings=count(hop),
               cold_mask_step=dict(shape=f"k={k} n_pad={n} m_pad={m}",
                                   calls=count(cold)),
               mask_step=dict(shape=f"m_pad={gab.m_pad} n_pad={gab.n_pad} "
                                    f"H=4 C=12 int32, B={lay.B}",
                              column_masks=count(columns_step),
                              bin_masks=count(lambda: columns_step(lay)),
                              dispatch_ms=cuda_ms(torch, columns_step)))
    if PARENT is not None:
        v_bits, e_bits = (np.packbits(a, axis=1, bitorder="little")
                          for a in (v_masks, e_masks))
        out["cold_mask_step"]["parent_calls"] = count(
            lambda: PARENT.mask_step(v_bits, e_bits, dev))
        bounds = hopbatch._column_layout(hops[:4], WINDOWS)
        info = np.iinfo(np.int32)
        bounds = (bounds[2], np.clip(bounds[3] - bounds[4], info.min,
                                     info.max).astype(np.int32),
                  bounds[4] < 0)
        pv = tuple(torch.from_numpy(a).to(dev) for a in (lay.perm,
                                                         lay.valid))
        out["mask_step"]["parent_column_masks"] = count(
            lambda: Parent.fold_columns_step(columns, host_cols, bounds,
                                             dev))
        out["mask_step"]["parent_bin_masks"] = count(
            lambda: Parent.fold_columns_step(columns, host_cols, bounds,
                                             dev, pv))
    return out


def grid_split_cases(torch, np, segment, dev) -> dict:
    """K7, K7-P and K7-mode past the 65,535 grid rows of one launch (F * k
    features x windows for K7 / K7-P, k windows for K7-mode), on a small
    CSR with an empty row: one launch a group of 65,535 rows, BITWISE the
    twin (int32 sum, f32 max), and at the limit one launch."""
    from raphtory_tpu_torch.ops import columns

    rng = np.random.default_rng(16)
    runs = [2, 0, 3, 1, 40, 7]
    n, m = len(runs), int(sum(runs))
    ids = np.repeat(np.arange(n), runs).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(runs)]).astype(np.int64)
    csr = segment.SegmentCSR(torch.from_numpy(ids).to(dev),
                             torch.from_numpy(indptr).to(dev), None)
    walk = segment.PartitionWalk(csr.indptr, torch.arange(
        m, dtype=torch.int32, device=dev), None, None)
    cases = []
    for k, F, want_l in ((1, 65_535, 1), (1, 65_537, 2), (3, 21_846, 2)):
        for dt, op in (("i32", "sum"), ("f32", "max")):
            x = (rng.integers(-1000, 1000, (k * m, F)).astype(np.int32)
                 if dt == "i32" else
                 rng.random((k * m, F)).astype(np.float32))
            x = torch.from_numpy(x).to(dev)
            mask = torch.from_numpy(rng.random(k * m) < 0.8).to(dev)
            want = segment.segment_combine_plain(x, csr, op, mask, k)
            for name, fn in (("segment_combine", lambda: segment.
                              segment_combine(x, csr, op, mask, k)),
                             ("partition_segment_reduce", lambda: segment.
                              partition_reduce(x, walk, op, mask, k))):
                before = columns.LAUNCHES[name]
                got = fn()
                launched = columns.LAUNCHES[name] - before
                if launched != want_l or not torch.equal(got, want):
                    raise AssertionError(f"{name} past the grid-row limit: "
                                         f"k={k} F={F} {op} {dt}, "
                                         f"{launched} launches")
                cases.append(f"{name} k={k} F={F} {op} {dt}: {launched}")
    for k, want_l in ((65_535, 1), (65_538, 2)):
        v = torch.from_numpy(rng.integers(-1, 5, k * m).astype(
            np.int32)).to(dev)
        mask = torch.from_numpy(rng.random(k * m) < 0.85).to(dev)
        before = columns.LAUNCHES["segment_mode"]
        got = segment.segment_mode(v, csr, k * n, mask, -1, k)
        launched = columns.LAUNCHES["segment_mode"] - before
        if launched != want_l or not torch.equal(
                got, segment.segment_mode_plain(v, csr, k * n, mask, -1, k)):
            raise AssertionError(f"segment_mode past the window limit: "
                                 f"k={k}, {launched} launches")
        cases.append(f"segment_mode k={k}: {launched}")
    return dict(bitwise=len(cases), launches=cases)


def segment_kernels(torch, np, segment, resident, gab, btc, view_shapes,
                    dev):
    """K7, K9a, K9b and K8u against their twins on the card, at the shapes
    of the paths that run them: GAB (gab_pr_view, k = 1) and Bitcoin
    (bitcoin_range, k = 3) tables, the GAB and past-cap resident buffers
    and chunk capacities, the cold Views' masks (``view_shapes``: name ->
    ``(k, n_pad, m_pad)``, ``k8u_calls``); K7 / K7-P / K7-mode past 65,535
    grid rows (``grid_split_cases``); the ``sync_check`` line."""
    from raphtory_tpu_torch.ops.columns import LAUNCHES

    rng = np.random.default_rng(2)
    out = {}

    # ---- K7: every (op, dtype, direction) the programs use, k = 1 and 3
    def csr_of(t, direction):
        if direction == "dst":
            return segment.SegmentCSR(
                torch.from_numpy(t.e_dst).to(dev),
                torch.from_numpy(t.in_indptr).to(dev), None)
        return segment.SegmentCSR(
            torch.from_numpy(t.e_src).to(dev),
            torch.from_numpy(t.out_indptr).to(dev),
            torch.from_numpy(t.out_perm).to(dev))

    def inputs(t, k, dtype):
        mask = rng.random((k, t.m_pad)) < 0.7
        mask[:, t.m:] = False                  # pads masked everywhere
        if dtype == "f32":
            # PageRank's messages: rank / degree, positive, ~1e-4
            x = (rng.random(k * t.m_pad) * 1e-4).astype(np.float32)
        else:
            x = rng.integers(-10**6, 10**6, k * t.m_pad).astype(np.int32)
        return (torch.from_numpy(x).to(dev),
                torch.from_numpy(mask.reshape(-1)).to(dev), int(mask.sum()))

    err7, bad = 0.0, []
    cases = [("sum", "f32", "dst", gab, 1), ("sum", "i32", "dst", gab, 1),
             ("sum", "i32", "src", gab, 1), ("min", "i32", "src", gab, 1),
             ("min", "f32", "dst", gab, 1), ("max", "f32", "src", gab, 1),
             ("sum", "f32", "dst", btc, 3), ("sum", "i32", "src", btc, 3),
             ("min", "i32", "dst", btc, 3), ("sum", "f32", "src", btc, 3),
             ("max", "f32", "src", btc, 3), ("min", "f32", "src", btc, 1),
             ("max", "i32", "src", btc, 3),
             # BinaryDiffusion's combine: int32 max at the destination,
             # its Views' windows at the GAB shape
             ("max", "i32", "dst", gab, 3)]
    for op, dt, direction, t, k in cases:
        csr = csr_of(t, direction)
        x, mask, _ = inputs(t, k, dt)
        before = k7_launches()
        got = segment.segment_combine(x, csr, op, mask, k)
        if k7_launches() - before != 1:
            raise AssertionError("K7: not one launch a call")
        want = segment.segment_combine_plain(x, csr, op, mask, k)
        ok = (within_tol(got, want) if op == "sum" and dt == "f32"
              else torch.equal(got, want))
        err7 = max(err7, exact_err(got, want))
        if not ok:
            bad.append(f"{op} {dt} {direction} k={k} (max abs err "
                       f"{exact_err(got, want)})")
    if bad:
        raise AssertionError(f"K7 differs from its twin: {bad}")
    # the timed call: PageRank's message combine on the GAB View (k = 1)
    csr = csr_of(gab, "dst")
    x, mask, nnz = inputs(gab, 1, "f32")
    ids = csr.ids.long()
    xm = torch.where(mask, x, 0.0)
    m, n = gab.m, gab.n_pad

    def k7():
        return segment.segment_combine(x, csr, "sum", mask, 1)
    k7_bound = bound(m * 5 + (n + 1) * 8 + n * 4, nnz)
    out["segment_combine"] = dict(
        source="raphtory_tpu_torch/csrc/segment.cu",
        replaces="raphtory_tpu/ops/segment.py:35",
        max_abs_err=err7, ms=cuda_ms(torch, k7),
        device_ms=device_ms(torch, k7)[0],
        plain_ms=cuda_ms(torch, lambda: segment.segment_combine_plain(
            x, csr, "sum", mask, 1)),
        # one call: index_add_ of the pre-masked payload
        library_ms=cuda_ms(torch, lambda: torch.zeros(
            n, device=dev).index_add_(0, ids, xm)),
        shape=f"sum f32 dst n_pad={n} m_pad={gab.m_pad} k=1 F=1",
        # the real edges' payload and mask, the CSR, the output; one add
        # per masked edge
        **dict(zip(("bound_ms", "bound_by"), k7_bound)))

    # ---- K7 at bitcoin_range's out-degree call: int32 sum of ones in the
    # source direction through out_perm, k = 3 (Pareto senders: runs to
    # 4,119 entries, each past 32 a block of the launch)
    csr = csr_of(btc, "src")
    k, m, n = 3, btc.m, btc.n_pad
    ones = torch.ones(k * btc.m_pad, dtype=torch.int32, device=dev)
    _, mask, live = inputs(btc, k, "i32")
    lens = np.diff(btc.out_indptr)

    def k7_src():
        return segment.segment_combine(ones, csr, "sum", mask, k)
    got = k7_src()
    if not torch.equal(got, segment.segment_combine_plain(
            ones, csr, "sum", mask, k)):
        raise AssertionError("K7 differs from its twin at the out-degree "
                             "call")
    flat = (csr.ids.long()[None, :] + torch.arange(
        k, device=dev)[:, None] * n).reshape(-1)
    ones_m = torch.where(mask, ones, 0)
    # the walk (out_perm, indptr) once, each window's mask of the real
    # edges, the live entries' payload, the output; an add per live entry
    src_bound = bound(4 * m + 8 * (n + 1) + k * m + 4 * live + 4 * k * n,
                      live)
    out["segment_combine_out_degree"] = dict(
        source="raphtory_tpu_torch/csrc/segment.cu",
        replaces="raphtory_tpu/ops/segment.py:35",
        max_abs_err=exact_err(got, segment.segment_combine_plain(
            ones, csr, "sum", mask, k)),
        ms=cuda_ms(torch, k7_src), device_ms=device_ms(torch, k7_src)[0],
        plain_ms=cuda_ms(torch, lambda: segment.segment_combine_plain(
            ones, csr, "sum", mask, k)),
        # one call: index_add_ of the pre-masked ones at the flat sources
        library_ms=cuda_ms(torch, lambda: torch.zeros(
            k * n, dtype=torch.int32, device=dev).index_add_(0, flat,
                                                             ones_m)),
        shape=f"sum i32 src k={k} n_pad={n} m_pad={btc.m_pad} "
              f"runs_past_32={int((lens > 32).sum())} "
              f"runs_past_1024={int((lens > 1024).sum())} "
              f"longest={int(lens.max())} live={live}",
        **dict(zip(("bound_ms", "bound_by"), src_bound)))

    out["segment_combine"]["grid_split"] = grid_split_cases(
        torch, np, segment, dev)

    # ---- K9a: one packed chunk a call (one upload from pinned memory),
    # at the GAB resident buffers' capacities and at the past-cap job's
    err9a, hops = 0.0, {}
    for what, n_pad, m_pad in (("gab", gab.n_pad, gab.m_pad),
                               ("past_cap", *past_cap_shape(dev))):
        cap_v, cap_e = max(1024, n_pad // 4), max(4096, m_pad // 16)
        for tdt, tt in ((np.int32, torch.int32), (np.int64, torch.int64)):
            case = k9a_case(torch, np, resident, rng, n_pad, m_pad, cap_v,
                            cap_e, tdt, tt, dev)
            err9a = max(err9a, case["err"])
            if tdt == np.int32:
                hops[what] = case
    calls9a = {}
    for what, c in hops.items():
        got, packed = c["got"], c["packed"]

        def hop(got=got, packed=packed):
            resident.apply_delta_chunk(got, packed._replace(
                data=packed.data.to(dev, non_blocking=True)))
        bnd = bound((c["cap_v"] + c["cap_e"]) * 13 + c["live"] * 9)
        calls9a[what] = dict(hop_ms=cuda_ms(torch, hop, 50),
                             hop_device_ms=device_ms(torch, hop, 50)[0],
                             bound_ms=bnd[0], shape=c["shape"])
    c = hops["gab"]
    got, chunk = c["got"], c["on_card"]
    valid = [(x >= 0) & (x < ln) for x, ln in ((chunk[0], c["n_pad"]),
                                              (chunk[4], c["m_pad"]))]
    lib_rows = [(b, chunk[i].long()[valid[i // 4]], chunk[j][valid[i // 4]])
                for b, i, j in ((got[0], 0, 1), (got[1], 0, 2),
                                (got[2], 0, 3), (got[3], 4, 5),
                                (got[4], 4, 6), (got[5], 4, 7))]
    on_card = c["packed"]._replace(data=c["packed"].data.to(dev))

    def library():
        for b, p, v in lib_rows:
            b.index_put_((p,), v)

    def k9a():
        resident.apply_delta_chunk(got, on_card)
    out["apply_delta_chunk"] = dict(
        source="raphtory_tpu_torch/csrc/sweep.cu",
        replaces="raphtory_tpu/engine/device_sweep.py:239",
        max_abs_err=err9a,
        # the wrapper and kernel on a chunk already on the card, as the
        # kernels line always timed it; a hop's upload + wrapper in calls
        ms=cuda_ms(torch, k9a), device_ms=device_ms(torch, k9a)[0],
        plain_ms=cuda_ms(torch, lambda: resident.apply_delta_chunk_plain(
            c["want"], chunk), iters=3),
        # six index_put_ calls on the unpadded rows
        library_ms=cuda_ms(torch, library),
        shape=c["shape"], calls=calls9a,
        # the chunk read once (4 + 4 + 1 + 4 bytes a row), the live rows
        # written once (4 + 1 + 4 bytes)
        **dict(zip(("bound_ms", "bound_by"), bound(
            (c["cap_v"] + c["cap_e"]) * 13 + c["live"] * 9))))

    # ---- K9b: the bounds by value, 32 windows a launch; GAB (k 1, the
    # View's window), Bitcoin (k 3), GAB past the launch's window group
    # (k 40), GAB int64 with unbounded and clamped windows
    err9b, calls9b, timed = 0.0, {}, None
    for what, t, windows, T, tt in (
            ("gab_k1", gab, [2_600_000], 2_400_000, torch.int32),
            ("btc_k3", btc, BTC_WINDOWS, 2_000_000, torch.int32),
            ("gab_k40", gab, [int(w) for w in rng.integers(
                -1, 2_600_000, 40)], 2_400_000, torch.int32),
            ("gab_i64", gab, [-1, 0, 1 << 62], 2_400_000, torch.int64)):
        lat = [torch.from_numpy(rng.integers(0, 2_600_000, s)).to(
            dev, tt) for s in (t.n_pad, t.m_pad)]
        alive = [torch.from_numpy(rng.random(s) < 0.8).to(dev)
                 for s in (t.n_pad, t.m_pad)]
        args = (lat[0], alive[0], lat[1], alive[1])
        before = LAUNCHES["window_masks"]
        got = resident.window_masks(*args, T, windows)
        if LAUNCHES["window_masks"] - before != -(-len(windows) // 32):
            raise AssertionError(f"K9b: not one launch a group of 32 "
                                 f"windows ({what})")
        lo, nowin = resident.window_bounds(T, windows, tt, dev)
        want = resident.window_masks_plain(*args, lo, nowin)
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"K9b differs from its twin ({what})")
            err9b = max(err9b, exact_err(g, w))
        k = len(windows)

        def k9b(args=args, T=T, windows=windows):
            return resident.window_masks(*args, T, windows)
        # lat + alive read, k masks written
        bnd = bound((t.n_pad + t.m_pad) * (tt.itemsize + 1 + k))
        shape = f"n_pad={t.n_pad} m_pad={t.m_pad} k={k} {tt}"
        calls9b[what] = dict(ms=cuda_ms(torch, k9b, 50),
                             device_ms=device_ms(torch, k9b, 50)[0],
                             bound_ms=bnd[0], shape=shape)
        if timed is None:
            timed = (args, T, windows, lo, nowin, t, bnd, shape)
    args, T, windows, lo, nowin, t, bnd, shape = timed
    out["window_masks"] = dict(
        source="raphtory_tpu_torch/csrc/sweep.cu",
        replaces="raphtory_tpu/engine/device_sweep.py:273",
        max_abs_err=err9b,
        ms=calls9b["gab_k1"]["ms"], device_ms=calls9b["gab_k1"]["device_ms"],
        plain_ms=cuda_ms(torch, lambda: resident.window_masks_plain(
            *args, lo, nowin)),
        library_ms=None, shape=shape, calls=calls9b,
        **dict(zip(("bound_ms", "bound_by"), bnd)))
    emit("sync_check", **sync_check(torch, np, resident, gab,
                                    view_shapes["ldbc"], dev))

    out["unpack_mask_bits"] = k8u_calls(torch, np, resident, view_shapes,
                                        dev)
    return out


def k8u_bound(k: int, n: int, m: int) -> tuple[float, str]:
    """K8u's bound: a View's packed bits read once, its masks written
    once."""
    return bound(-(-k * n // 8) + -(-k * m // 8) + k * (n + m))


def k8u_edge_cases(torch, np, resident, columns, dev) -> int:
    """K8u (through the C entry) bitwise its twin and the numpy masks on
    small Views: k 1-5, n_pad / m_pad 0, 8, 16, 24, 64, 1,024, 4,104 and
    2^16 — regions under 16 bytes, k*n not a multiple of 128, a block's
    end, empty regions. Returns the count."""
    rng = np.random.default_rng(18)
    fn = columns._fn("sweep", "rtpu_unpack_view_masks")
    cases = 0
    for k in (1, 2, 3, 4, 5):
        for n, m in ((8, 8), (16, 64), (24, 0), (0, 1024), (64, 4104),
                     (1024, 1 << 16), (1 << 16, 16)):
            v, e = rng.random((k, n)) < 0.4, rng.random((k, m)) < 0.6
            packed = resident.upload(resident.pack_view_masks(v, e,
                                                              pin=True), dev)
            want = resident.unpack_view_masks_plain(packed, k, n, m)
            buf, gv, ge = resident._view_masks_out(k, n, m, dev)
            err = fn(k * n, k * m, packed.data_ptr(), buf.data_ptr(),
                     columns._stream(packed))
            torch.cuda.synchronize()
            if err or not (torch.equal(gv, want[0])
                           and torch.equal(ge, want[1])
                           and torch.equal(gv.cpu(), torch.from_numpy(v))
                           and torch.equal(ge.cpu(), torch.from_numpy(e))):
                raise AssertionError(f"K8u differs from its twin (k={k} "
                                     f"n={n} m={m}, cudaError {err})")
            cases += 1
    return cases


def flushed_ms(torch, fn, dev, iters: int = 10) -> float:
    """Mean milliseconds of one ``fn()`` by CUDA events around it alone,
    each call after a 128 MB write that evicts the L2 (the launch latency
    counts in)."""
    scrub = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(iters):
        scrub.fill_(1)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def k8u_calls(torch, np, resident, view_shapes, dev) -> dict:
    """K8u at each cold View's shape (``view_shapes``): random masks packed
    into pinned memory as ``bsp.run_async`` packs them; the wrapper on the
    uploaded bits held BITWISE against its twin, the numpy masks and the
    parent's two calls (with ``--parent``); its ``ms`` and device time, and
    the mask step (the upload + the unpack, host time to a sync) in turns
    with the parent's (its two pageable uploads and two calls); then the
    edge cases. The kernels line's entry is the LDBC View's."""
    from raphtory_tpu_torch.ops import columns

    rng = np.random.default_rng(18)
    calls, err8 = {}, 0.0
    for name, (k, n, m) in view_shapes.items():
        v, e = rng.random((k, n)) < 0.4, rng.random((k, m)) < 0.6
        host = resident.pack_view_masks(v, e, pin=True)
        packed = resident.upload(host, dev)
        got = resident.unpack_view_masks(packed, k, n, m)
        want = resident.unpack_view_masks_plain(packed, k, n, m)
        bits = [np.packbits(a, axis=1, bitorder="little") for a in (v, e)]
        par = (PARENT.mask_step(*bits, dev) if PARENT is not None
               else want)
        for g, x, y, a in zip(got, want, par, (v, e)):
            if not (torch.equal(g, x) and torch.equal(g, y)
                    and torch.equal(g.cpu(), torch.from_numpy(a))):
                raise AssertionError(f"K8u differs from its twin, the host's "
                                     f"masks or the parent's ({name})")
            err8 = max(err8, exact_err(g, x))

        def kern(packed=packed, k=k, n=n, m=m):
            return resident.unpack_view_masks(packed, k, n, m)

        def step(host=host, k=k, n=n, m=m):
            return resident.unpack_view_masks(resident.upload(host, dev), k,
                                              n, m)

        shape = f"k={k} n_pad={n} m_pad={m}"
        bnd = k8u_bound(k, n, m)
        entry = dict(shape=shape, ms=cuda_ms(torch, kern),
                     step_wall_ms=wall_ms(torch, step), bound_ms=bnd[0])
        entry["device_ms"], entry["device_by"] = device_ms(torch, kern)
        if (n + m) * k * 9 // 8 > 16 << 20:
            # a working set that stays in the 50 MB L2 between back-to-back
            # calls: also each call after a 128 MB write, by CUDA events
            entry["l2_flushed_events_ms"] = flushed_ms(torch, kern, dev)
        if name == "ldbc":
            entry["plain_ms"] = cuda_ms(
                torch, lambda: resident.unpack_view_masks_plain(packed, k, n,
                                                                m))
        if PARENT is not None:
            vs_parent(torch, f"unpack_mask_bits kernel {name}", kern,
                      lambda bits=[torch.from_numpy(b).to(dev)
                                   for b in bits]:
                      [PARENT.unpack_mask_bits(b) for b in bits],
                      shape=shape + " (the unpack alone)", bound_ms=bnd[0])
            vs_parent(torch, f"unpack_mask_bits step {name}", step,
                      lambda bits=bits: PARENT.mask_step(*bits, dev),
                      wall=True, shape=shape + " (the upload + the unpack)",
                      bound_ms=bnd[0])
        calls[name] = entry
    ldbc = calls["ldbc"]
    return dict(
        source="raphtory_tpu_torch/csrc/sweep.cu",
        replaces="raphtory_tpu/engine/bsp.py:39", max_abs_err=err8,
        ms=ldbc["ms"], device_ms=ldbc["device_ms"],
        plain_ms=ldbc["plain_ms"], library_ms=None, shape=ldbc["shape"],
        calls=calls,
        edge_cases=k8u_edge_cases(torch, np, resident, columns, dev),
        **dict(zip(("bound_ms", "bound_by"),
                   k8u_bound(*view_shapes["ldbc"]))))


def compare_rows(what, got, want) -> None:
    """Job rows on the card against the CPU's: time / windowsize / steps
    equal; PageRank's top-10 ids equal and ranks within the tolerance,
    every other result equal."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} rows vs {len(want)}")
    for g, w in zip(got, want):
        if any(g[k] != w[k] for k in ("time", "windowsize", "steps")):
            raise AssertionError(f"{what}: row {g} vs {w}")
        r, x = g["result"], w["result"]
        if isinstance(x, dict) and "top10" in x:
            gr = [v for _, v in r["top10"]]
            xr = [v for _, v in x["top10"]]
            ok = ([v for v, _ in r["top10"]] == [v for v, _ in x["top10"]]
                  and all(abs(a - b) <= 1e-7 + 1e-5 * abs(b)
                          for a, b in zip(gr, xr))
                  and abs(r["sum"] - x["sum"]) <= 1e-5)
        else:
            ok = r == x
        if not ok:
            raise AssertionError(f"{what}: result {r} vs {x}")


def run_view_jobs(log, dev, jobs):
    """``(rows, per-job viewTime seconds, per-job resident (fold,
    dispatch) seconds, graph)`` of View jobs submitted one after another
    through ``TemporalGraph`` + ``AnalysisManager``."""
    from raphtory_tpu_torch.core.service import TemporalGraph
    from raphtory_tpu_torch.jobs.manager import AnalysisManager

    g = TemporalGraph(log, device=dev)
    mgr = AnalysisManager(g, device=dev)
    rows, secs, split = [], [], []

    def resident_clock():
        ds = g._resident
        return (0.0, 0.0) if ds is None else (ds.fold_seconds,
                                              ds.dispatch_seconds)

    for prog, q in jobs:
        before = resident_clock()
        job = mgr.submit(prog, q)
        if not job.wait(600) or job.status != "done":
            raise AssertionError(f"{type(prog).__name__} View job "
                                 f"{job.status}: {job.error}")
        r = mgr.results(job.id)
        rows.extend(r)
        secs.append(sum(x["viewTime"] for x in r) / 1e3)
        after = resident_clock()
        split.append([a - b if a >= b else a
                      for a, b in zip(after, before)])
    return rows, secs, split, g


def result_leaves(tree):
    return [tree[k] for k in sorted(tree)] if isinstance(tree, dict) \
        else [tree]


def phase_gab_pr_view(torch, np, columns, log, dev):
    """bench.py:bench_gab_pr_view through the port's jobs layer."""
    from raphtory_tpu_torch.algorithms import PageRank
    from raphtory_tpu_torch.engine.device_sweep import DeviceSweep
    from raphtory_tpu_torch.jobs.manager import ViewQuery

    prog = PageRank(max_steps=20, tol=1e-7)
    times = [int(f * GAB_SPAN) for f in (0.90, 0.92, 0.94, 0.96, 0.98, 1.0)]
    jobs = [(prog, ViewQuery(t, window=2_600_000)) for t in times]
    columns.reset_launches()
    t0 = time.perf_counter()
    rows, secs, split, g = run_view_jobs(log, dev, jobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(columns.LAUNCHES)
    check_launched("gab_pr_view", launches, RESIDENT_KERNELS)
    if launches["unpack_mask_bits"]:
        raise AssertionError("gab_pr_view: a View took the cold route")
    sweep = g._resident
    if sweep is None or sweep.t_now != times[-1]:
        raise AssertionError("gab_pr_view: the Views did not ride the "
                             "resident sweep")
    want = run_view_jobs(log, "cpu", jobs)[0]
    compare_rows("gab_pr_view", rows, want)
    # the rank vectors themselves, card against CPU
    card, cpu = DeviceSweep(log, device=dev), DeviceSweep(log, device="cpu")
    err = 0.0
    for t in times:
        (r, s), (x, xs) = (ds.run(prog, t, window=2_600_000)
                           for ds in (card, cpu))
        r = r.cpu()
        if s != xs or not within_tol(r, x):
            raise AssertionError(f"gab_pr_view ranks at {t} differ from "
                                 f"the CPU run (steps {s} vs {xs})")
        if abs(float(r.double().sum()) - 1.0) > 1e-4:
            raise AssertionError(f"gab_pr_view ranks at {t} sum off 1")
        err = max(err, float((r - x).abs().max()))
    emit("gab_pr_view", n=sweep.n, m=sweep.m, n_pad=sweep.n_pad,
         m_pad=sweep.m_pad, views=len(times), cold_s_per_view=secs[0],
         warm_s_per_view=secs[1:],
         warm_median_s_per_view=float(np.median(secs[1:])),
         wall_s=wall, fold_s=sweep.fold_seconds,
         dispatch_s=sweep.dispatch_seconds, ship_bytes=sweep.ship_bytes,
         fold_s_per_view=[f for f, _ in split],
         dispatch_s_per_view=[d for _, d in split],
         supersteps=[r["steps"] for r in rows], launches=launches,
         max_abs_err_vs_cpu=err)
    return launches


def phase_bitcoin_range(torch, np, columns, dev):
    """bench.py:bench_bitcoin_range: PageRank over batched week/day/hour
    windows through DeviceSweep.run_sweep (serial)."""
    from raphtory_tpu_torch.algorithms import PageRank
    from raphtory_tpu_torch.engine.device_sweep import DeviceSweep
    from raphtory_tpu_torch.utils.synth import bitcoin_like_log

    log = bitcoin_like_log(n_addresses=20_000, n_txs=200_000,
                           t_span=BTC_SPAN)
    hops = [int(t) for t in
            np.linspace(0.5 * BTC_SPAN, BTC_SPAN, 10).astype(np.int64)]
    prog = PageRank(max_steps=20, tol=1e-7)
    # the warm-up run is the measured runs' twin: it tallies K7's calls in
    # the source direction (the per-window out-degrees, int32 through
    # out_perm: the kernels line's ``segment_combine_out_degree``)
    from raphtory_tpu_torch.engine import bsp

    combine, src_calls = bsp.segment_combine, []

    def tally(data, csr, op, mask, k=1):
        src_calls.append(csr.perm is not None)
        return combine(data, csr, op, mask, k)
    columns.reset_launches()
    bsp.segment_combine = tally
    try:
        DeviceSweep(log, device=dev).run_sweep(prog, hops,
                                               windows=BTC_WINDOWS)
    finally:
        bsp.segment_combine = combine
    torch.cuda.synchronize()
    if columns.LAUNCHES["segment_combine"] != len(src_calls):
        raise AssertionError(f"bitcoin_range: {len(src_calls)} K7 calls, "
                             f"{columns.LAUNCHES['segment_combine']} "
                             "launches")
    reps = []
    for _ in range(2):
        cold_fold()   # the sweep before left its checkpoints
        ds = DeviceSweep(log, device=dev)
        columns.reset_launches()
        t0 = time.perf_counter()
        res, steps = ds.run_sweep(prog, hops, windows=BTC_WINDOWS)
        torch.cuda.synchronize()
        reps.append(fold_stats(ds, time.perf_counter() - t0))
        launches = dict(columns.LAUNCHES)
    check_launched("bitcoin_range", launches, RESIDENT_KERNELS)
    cold_fold()
    ref, ref_steps = DeviceSweep(log, device="cpu").run_sweep(
        prog, hops, windows=BTC_WINDOWS)
    err = 0.0
    for T, r, x, s, xs in zip(hops, res, ref, steps, ref_steps):
        r = r.cpu()
        if s != xs or not within_tol(r, x):
            raise AssertionError(f"bitcoin_range at {T} differs from the "
                                 f"CPU run (steps {s} vs {xs})")
        err = max(err, float((r - x).abs().max()))
    best = min(reps, key=lambda r: r["sweep_s"])
    n_views = len(hops) * len(BTC_WINDOWS)
    emit("bitcoin_range", n=ds.n, m=ds.m, n_pad=ds.n_pad, m_pad=ds.m_pad,
         views=n_views, views_per_s=n_views / best["sweep_s"], **best,
         repeat_sweep_s=[r["sweep_s"] for r in reps], supersteps=steps,
         launches=launches, segment_combine_out_degree=sum(src_calls),
         max_abs_err_vs_cpu=err)
    return launches, sum(src_calls)


def split_run(bsp, prog, view, dev, **kw):
    """``bsp.run`` on the card with ``bsp.STAGE_SECONDS`` on: ``(result,
    steps, the dispatch's seconds by stage)``."""
    bsp.STAGE_SECONDS = split = {}
    try:
        got, steps = bsp.run(prog, view, device=dev, **kw)
    finally:
        bsp.STAGE_SECONDS = None
    return got, steps, split


def phase_view_programs(torch, np, columns, log, dev):
    """CC, DegreeBasic and undirected BFS Views on the resident route;
    weighted SSSP and a descending-time PageRank View on the cold route,
    each cold dispatch split by stage (``cold_split_s``: mask build, pack,
    the bits' upload + unpack, view edges, props, layout, supersteps)."""
    from raphtory_tpu_torch.algorithms import (BFS, SSSP, ConnectedComponents,
                                               DegreeBasic, PageRank)
    from raphtory_tpu_torch.core.snapshot import build_view
    from raphtory_tpu_torch.engine import bsp
    from raphtory_tpu_torch.engine.device_sweep import DeviceSweep
    from raphtory_tpu_torch.jobs.manager import ViewQuery

    T = [int(f * LDBC_SPAN) for f in (0.6, 0.7, 0.8, 0.9, 0.5)]
    W = (1_300_000, 604_800)
    cc, deg = ConnectedComponents(max_steps=50), DegreeBasic()
    bfs = BFS(seeds=LDBC_SEEDS, directed=False, max_steps=32)
    sssp = SSSP(seeds=LDBC_SEEDS, weight_prop="weight", directed=False,
                max_steps=32)
    pr = PageRank(max_steps=20, tol=1e-7)
    jobs = [(cc, ViewQuery(T[0], windows=W)), (deg, ViewQuery(T[1])),
            (bfs, ViewQuery(T[2], windows=W)),
            (sssp, ViewQuery(T[3], windows=W)),       # properties: cold
            (pr, ViewQuery(T[4], windows=W))]         # behind: cold
    columns.reset_launches()
    rows, secs, split, _ = run_view_jobs(log, dev, jobs)
    torch.cuda.synchronize()
    launches = dict(columns.LAUNCHES)
    # (the resident Views here are 10 % of the span apart: each delta
    # restages the full state, so K9a need not run)
    check_launched("view_programs", launches,
                   ("window_masks",) + COLD_KERNELS)
    want = run_view_jobs(log, "cpu", jobs)[0]
    compare_rows("view_programs", rows, want)
    # the result vectors, card against CPU, on each job's route
    card, cpu = DeviceSweep(log, device=dev), DeviceSweep(log, device="cpu")
    err, cold_split = 0.0, {}
    for prog, q in jobs:
        kw = dict(window=q.window, windows=q.windows)
        if prog in (sssp, pr):
            view = build_view(log, q.timestamp)
            # the cold dispatch split by stage (``bsp.run_async``)
            got, s, cold_split[type(prog).__name__] = split_run(
                bsp, prog, view, dev, **kw)
            ref, xs = bsp.run(prog, view, device="cpu", **kw)
        else:
            got, s = card.run(prog, q.timestamp, **kw)
            ref, xs = cpu.run(prog, q.timestamp, **kw)
        for a, b in zip(result_leaves(got), result_leaves(ref)):
            a = a.cpu()
            ok = within_tol(a, b) if prog is pr else torch.equal(a, b)
            if s != xs or not ok:
                raise AssertionError(f"view_programs {type(prog).__name__} "
                                     f"differs from the CPU run (steps {s} "
                                     f"vs {xs})")
            if prog is pr:
                err = max(err, float((a - b).abs().max()))
    emit("view_programs", rows=len(rows), view_s=secs,
         resident_fold_dispatch_s=split, cold_split_s=cold_split,
         supersteps=[r["steps"] for r in rows], launches=launches,
         pagerank_max_abs_err_vs_cpu=err)
    return launches


def phase_host_columns(torch, np, columns, log, ldbc, dev):
    """The host-column route (``RTPU_FOLD=host``: the host builds the
    ``[H, m_pad]`` fold columns, K3 the masks) of the headline PageRank,
    the cc_range CC and the LDBC BFS and SSSP, each held BITWISE, with
    equal steps, against the same engine's delta route on the card."""
    from raphtory_tpu_torch.engine.hopbatch import (HopBatchedBFS,
                                                    HopBatchedCC,
                                                    HopBatchedPageRank,
                                                    HopBatchedSSSP)

    hops, windows = headline_grid()
    ldbc_hops = [int(T) for T in
                 np.linspace(0.5 * LDBC_SPAN, LDBC_SPAN, 10).astype(np.int64)]
    ldbc_windows = [1_300_000, 604_800]
    runs = {
        "headline": (lambda: HopBatchedPageRank(log, tol=1e-7, max_steps=20,
                                                device=dev),
                     hops, windows, dict(chunks=3, warm_start=True),
                     PAGERANK_KERNELS),
        "cc_range": (lambda: HopBatchedCC(log, max_steps=50, device=dev),
                     hops, [GAB_SPAN], dict(chunks=1), CC_KERNELS),
        "ldbc_bfs": (lambda: HopBatchedBFS(ldbc, LDBC_SEEDS, directed=False,
                                           max_steps=32, device=dev),
                     ldbc_hops, ldbc_windows, dict(chunks=1),
                     ("minplus_superstep",)),
        "ldbc_sssp": (lambda: HopBatchedSSSP(
            ldbc, LDBC_SEEDS, "weight", directed=False, max_steps=32,
            device=dev), ldbc_hops, ldbc_windows, dict(chunks=1),
            ("minplus_superstep",)),
    }
    total = {k: 0 for k in columns.LAUNCHES}
    result = {}
    for name, (make, h, w, kw, kernels) in runs.items():
        with knobs(RTPU_FOLD="delta"):
            cold_fold()
            ref, ref_steps = make().run(h, w, **kw)
        with knobs(RTPU_FOLD="host"):
            got, steps, launches, stats = timed_sweep(
                torch, columns, make, h, w, **kw)
        if not torch.equal(got, ref) or steps != ref_steps:
            raise AssertionError(f"host_columns {name}: the host-column "
                                 f"route differs from the delta route "
                                 f"(steps {steps} vs {ref_steps})")
        kernels = tuple(k for k in kernels if k != "masks_from_deltas")
        check_launched(f"host_columns {name}", launches,
                       ("column_masks",) + kernels)
        if launches["masks_from_deltas"]:
            raise AssertionError(f"host_columns {name}: the delta route's "
                                 f"K1 launched ({launches})")
        for k, v in launches.items():
            total[k] += v
        result[name] = stats
    emit("host_columns", runs=result, launches=total)
    return total


class knobs:
    """Environment variables set inside the block (None: unset), restored
    after it."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.prev = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)

    def __exit__(self, *exc):
        for k, v in self.prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cold_fold() -> None:
    """Empty the fold cache: the next sweep folds cold (and a reference
    run folds for itself) instead of dispatching an earlier run's cached
    payloads."""
    from raphtory_tpu_torch.core.sweep import fold_cache

    cache = fold_cache()
    if cache is not None:
        cache.clear()


def cache_stats():
    """The fold cache's counters and bytes (None: the cache is off)."""
    from raphtory_tpu_torch.core.sweep import fold_cache

    cache = fold_cache()
    return None if cache is None else cache.stats()


def fold_stats(engine, sweep_s: float) -> dict:
    """A sweep's fold split: worker seconds (``fold_s``), the dispatch
    loop's wait (``fold_stall_s``), the seconds by mode, and the sweep
    less the wait (``device_s``: the dispatches and what they wait on)."""
    return dict(sweep_s=sweep_s, fold_s=engine.fold_seconds,
                fold_stall_s=engine.fold_stall_seconds,
                fold_mode_s=dict(engine.fold_mode_seconds),
                dispatch_s=engine.dispatch_seconds,
                device_s=sweep_s - engine.fold_stall_seconds,
                ship_bytes=engine.ship_bytes)


#: the fold pipeline's modes as (RTPU_FOLD_WORKERS, RTPU_PREFETCH); None:
#: the default worker count. ``cold`` empties the fold cache before each
#: sweep, ``warm`` sweeps over the checkpoints a first sweep left.
FOLD_MODES = {"serial": (1, 0), "prefetch": (1, 1), "cold": (None, 1),
              "warm": (None, 1)}


def check_mode(name: str, mode: str, hb) -> None:
    """Raise unless a sweep in pipeline mode ``mode`` folded as it must:
    forked only checkpoint-warm, and only where the engine's fold can
    fork."""
    forks = mode == "warm" and getattr(hb, "supports_parallel_fold", True)
    want = "parallel" if forks else "serial"
    if set(hb.fold_mode_seconds) != {want}:
        raise AssertionError(f"fold_pipeline {name}: a {mode} sweep folded "
                             f"{hb.fold_mode_seconds}, not {want}")


def median_row(rows: list) -> dict:
    """The row of the median sweep, every sweep's seconds beside it."""
    row = dict(sorted(rows, key=lambda r: r["sweep_s"])[len(rows) // 2])
    row["sweep_s_all"] = [r["sweep_s"] for r in rows]
    return row


def same_result(torch, got, want, exact: bool) -> bool:
    """``(result, steps)`` pairs equal: bitwise where ``exact``, else
    PageRank's tolerance with equal steps."""
    (g, gs), (w, ws) = got, want
    if gs != ws:
        return False
    if exact or torch.equal(g, w):
        return True
    return within_tol(g.cpu(), w.cpu())


def same_payload(a, b) -> bool:
    """Fold payload trees equal to the byte (a ``Staged`` buffer as the
    tuple of its arrays)."""
    import numpy as np

    if a is None or b is None:
        return a is b
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_payload(x, y)
                                        for x, y in zip(a, b))
    return a == b


def pipeline_case(torch, name, make, hops, windows, run_kw, exact,
                  modes, reps: int = 3) -> dict:
    """One engine's sweep under each fold mode (fresh engines, one warm-up
    a mode, ``reps`` timed sweeps; the cache off in ``serial`` and
    ``prefetch``), each against the serial loop's result and each sweep's
    fold mode checked. Then the fold alone through ``fold_payloads``.
    Medians; ratios against serial."""
    out, want = {}, None
    for mode in modes:
        workers, prefetch = FOLD_MODES[mode]
        cache_mb = None if mode in ("cold", "warm") else 0
        with knobs(RTPU_FOLD_WORKERS=workers, RTPU_PREFETCH=prefetch,
                   RTPU_FOLD_CACHE_MB=cache_mb):
            cold_fold()
            make().run(hops, windows, **run_kw)
            torch.cuda.synchronize()
            rows = []
            for _ in range(reps):
                if mode != "warm":
                    cold_fold()
                hb = make()
                t0 = time.perf_counter()
                got = hb.run(hops, windows, **run_kw)
                torch.cuda.synchronize()
                rows.append(fold_stats(hb, time.perf_counter() - t0))
                check_mode(name, mode, hb)
            cold_fold()
        if want is None:
            want = got
        elif not same_result(torch, got, want, exact):
            raise AssertionError(f"fold_pipeline {name}: {mode} differs "
                                 "from the serial loop")
        out[mode] = dict(median_row(rows),
                         bitwise=torch.equal(got[0], want[0]))
    if "warm" in modes:
        out["fold"] = fold_walls(name, make, hops, run_kw, reps)
    base = out["serial"]["sweep_s"]
    out["sweep_ratio"] = {m: out[m]["sweep_s"] / base for m in modes}
    return out


class InlinePool:
    """A stand-in for ``_vfold_pool()``: runs each vertex fold at once on
    the caller, the inline fold the overlap replaced."""

    def submit(self, fn, *args):
        from concurrent.futures import Future

        fut = Future()
        fut.set_result(fn(*args))
        return fut


def fold_walls(name, make, hops, run_kw, reps: int) -> dict:
    """The fold alone (``fold_payloads``, no dispatch): its wall serial
    (one worker, cache off), serial with the vertex fold inline instead of
    overlapped with the edge fold (``inline_vfold``), cold at the default
    workers (the serial lane leaving its checkpoints) and checkpoint-warm
    (forks seeded there), byte-equal the serial fold's; and the warm
    fold's worker seconds over its wall (the threads' overlap: 1 where the
    GIL serialises them)."""
    from raphtory_tpu_torch.core import sweep as core_sweep

    chunks = run_kw.get("chunks", 1)
    walls = {"serial": [], "inline_vfold": [], "cold": [], "warm": []}
    worker_s = []

    def fold(mode):
        hb = make()
        t0 = time.perf_counter()
        _, got = hb.fold_payloads(hops, chunks)
        walls[mode].append(time.perf_counter() - t0)
        check_mode(name, mode if mode in ("cold", "warm") else "serial", hb)
        if mode == "warm":
            worker_s.append(hb.fold_seconds)
        return got

    with knobs(RTPU_FOLD_WORKERS=1, RTPU_FOLD_CACHE_MB=0):
        for _ in range(reps):
            want = fold("serial")
            pool = core_sweep._vfold_pool
            core_sweep._vfold_pool = InlinePool
            try:
                got = fold("inline_vfold")
            finally:
                core_sweep._vfold_pool = pool
            if not same_payload(got, want):
                raise AssertionError(f"fold_pipeline {name}: the inline "
                                     "vertex fold's payloads differ")
    with knobs(RTPU_FOLD_WORKERS=None, RTPU_FOLD_CACHE_MB=None):
        for _ in range(reps):
            cold_fold()
            for mode in ("cold", "warm"):
                if not same_payload(fold(mode), want):
                    raise AssertionError(f"fold_pipeline {name}: the {mode} "
                                         "fold's payloads differ from the "
                                         "serial fold's")
        cold_fold()
    med = {m: sorted(v)[len(v) // 2] for m, v in walls.items()}
    return dict(wall_s=med, wall_s_all=walls,
                ratio={m: med[m] / med["serial"] for m in med},
                warm_worker_s=sorted(worker_s)[len(worker_s) // 2],
                overlap=sorted(w / t for w, t in zip(
                    worker_s, walls["warm"]))[len(worker_s) // 2])


def sweep_modes(torch, log, hops, prog, windows, dev, reps: int = 3):
    """``DeviceSweep.run_sweep`` under ``RTPU_PREFETCH=0`` (serial), the
    lookahead lane (1 worker), the defaults cold and checkpoint-warm
    (forked segments), each against the serial sweep's results, bitwise,
    and each sweep's fold mode checked. Medians."""
    from raphtory_tpu_torch.engine.device_sweep import DeviceSweep

    out, want = {}, None
    for mode, (workers, prefetch) in FOLD_MODES.items():
        cache_mb = None if mode in ("cold", "warm") else 0
        with knobs(RTPU_FOLD_WORKERS=workers, RTPU_PREFETCH=prefetch,
                   RTPU_FOLD_CACHE_MB=cache_mb):
            cold_fold()
            DeviceSweep(log, device=dev).run_sweep(prog, hops,
                                                   windows=windows)
            torch.cuda.synchronize()
            rows = []
            for _ in range(reps):
                if mode != "warm":
                    cold_fold()
                ds = DeviceSweep(log, device=dev)
                t0 = time.perf_counter()
                res, steps = ds.run_sweep(prog, hops, windows=windows)
                torch.cuda.synchronize()
                rows.append(fold_stats(ds, time.perf_counter() - t0))
                check_mode("bitcoin_range", mode, ds)
            cold_fold()
        leaves = [torch.utils._pytree.tree_leaves(r) for r in res]
        if want is None:
            want = (leaves, steps)
        elif steps != want[1] or not all(
                torch.equal(a, b) for ga, wa in zip(leaves, want[0])
                for a, b in zip(ga, wa)):
            raise AssertionError(f"fold_pipeline bitcoin_range: {mode} "
                                 "differs from RTPU_PREFETCH=0")
        out[mode] = median_row(rows)
    base = out["serial"]["sweep_s"]
    out["sweep_ratio"] = {m: out[m]["sweep_s"] / base for m in FOLD_MODES}
    return out


def phase_fold_pipeline(torch, np, columns, log, ldbc, dev):
    """The fold pipeline's modes (``core/sweep.py``): the headline PageRank
    on both fold routes, cc_range CC and LDBC BFS under the serial loop,
    the prefetch alone, and the defaults cold (the serial lane) and
    checkpoint-warm (forked folds); LDBC SSSP on the prefetch lane (its
    fold cannot fork); ``bitcoin_range`` on ``DeviceSweep.run_sweep``'s
    four modes. Every
    mode's result against the serial one's (bitwise, PageRank within its
    tolerance where not bitwise), every fold's payloads byte-equal the
    serial fold's. The host's cores beside the numbers. Then the headline
    and ``bitcoin_range`` sweeps with the ledger on, off and syncing every
    dispatch (``ledger_ab``)."""
    from raphtory_tpu_torch.algorithms import PageRank
    from raphtory_tpu_torch.core.sweep import fold_workers
    from raphtory_tpu_torch.engine.device_sweep import DeviceSweep
    from raphtory_tpu_torch.engine.hopbatch import (HopBatchedBFS,
                                                    HopBatchedCC,
                                                    HopBatchedPageRank,
                                                    HopBatchedSSSP)
    from raphtory_tpu_torch.utils.synth import bitcoin_like_log

    host = dict(cpu_count=os.cpu_count(),
                affinity=len(os.sched_getaffinity(0)),
                fold_workers=fold_workers())
    hops, windows = headline_grid()
    ldbc_hops = [int(T) for T in
                 np.linspace(0.5 * LDBC_SPAN, LDBC_SPAN, 10).astype(np.int64)]
    ldbc_windows = [1_300_000, 604_800]
    all_modes = tuple(FOLD_MODES)

    def headline():
        return HopBatchedPageRank(log, tol=1e-7, max_steps=20, device=dev)

    cases = {}
    cases["headline"] = pipeline_case(
        torch, "headline", headline, hops, windows,
        dict(chunks=3, warm_start=True), False, all_modes)
    with knobs(RTPU_FOLD="host"):
        cases["headline_host"] = pipeline_case(
            torch, "headline_host", headline, hops, windows,
            dict(chunks=3, warm_start=True), False, all_modes)
    cases["cc_range"] = pipeline_case(
        torch, "cc_range",
        lambda: HopBatchedCC(log, max_steps=50, device=dev), hops,
        [GAB_SPAN], dict(chunks=1), True, all_modes)
    cases["ldbc_bfs"] = pipeline_case(
        torch, "ldbc_bfs",
        lambda: HopBatchedBFS(ldbc, LDBC_SEEDS, directed=False, max_steps=32,
                              device=dev), ldbc_hops, ldbc_windows,
        dict(chunks=1), True, all_modes)
    cases["ldbc_sssp"] = pipeline_case(
        torch, "ldbc_sssp",
        lambda: HopBatchedSSSP(ldbc, LDBC_SEEDS, "weight", directed=False,
                               max_steps=32, device=dev), ldbc_hops,
        ldbc_windows, dict(chunks=2), True, ("serial", "prefetch"))
    btc = bitcoin_like_log(n_addresses=20_000, n_txs=200_000,
                           t_span=BTC_SPAN)
    btc_hops = [int(t) for t in
                np.linspace(0.5 * BTC_SPAN, BTC_SPAN, 10).astype(np.int64)]
    cases["bitcoin_range"] = sweep_modes(
        torch, btc, btc_hops, PageRank(max_steps=20, tol=1e-7), BTC_WINDOWS,
        dev)
    cold_fold()
    # the ledger's cost on these paths: its sampled dispatches sync the card
    ab = {"headline": ledger_ab(torch, lambda: headline().run(
        hops, windows, chunks=3, warm_start=True)),
        "bitcoin_range": ledger_ab(torch, lambda: DeviceSweep(
            btc, device=dev).run_sweep(PageRank(max_steps=20, tol=1e-7),
                                       btc_hops, windows=BTC_WINDOWS))}
    emit("fold_pipeline", host=host, cases=cases, cache=cache_stats(),
         ledger_ab=ab)


def ledger_ab(torch, sweep, reps: int = 2) -> dict:
    """One sweep (a fresh engine, the fold cache cold, the default fold
    knobs) under three arms: ``on``, the default, where ``instrument``
    syncs the card on a sampled dispatch (the first two of each shape,
    then one in 1/``RTPU_DEVICE_TIMING``); ``off``, ``RTPU_LEDGER=0``,
    where the wrapper passes straight through; and ``all``,
    ``RTPU_DEVICE_TIMING=1``, where every dispatch syncs (the stall's
    whole cost). In the order on, off, all, all, off, on, ``reps`` sweeps
    each after one warm-up. Medians against ``off``, and the instrumented
    dispatches and the synced ones a sweep of ``on`` and ``all``."""
    import statistics

    from raphtory_tpu_torch.obs import device as obs_device
    from raphtory_tpu_torch.obs import ledger as obs_ledger

    def counts():
        return (sum(r["dispatches"] for r in obs_ledger.REGISTRY.snapshot()),
                obs_device.TIMING.totals()["warm_samples"])

    arms = {"on": dict(RTPU_LEDGER=None, RTPU_DEVICE_TIMING=None),
            "off": dict(RTPU_LEDGER="0", RTPU_DEVICE_TIMING=None),
            "all": dict(RTPU_LEDGER=None, RTPU_DEVICE_TIMING="1")}
    sweep()
    torch.cuda.synchronize()
    secs = {k: [] for k in arms}
    seen = {k: [0, 0] for k in arms}
    for arm in ("on", "off", "all", "all", "off", "on"):
        with knobs(**arms[arm]):
            for _ in range(reps):
                cold_fold()
                c0 = counts()
                t0 = time.perf_counter()
                sweep()
                torch.cuda.synchronize()
                secs[arm].append(time.perf_counter() - t0)
                for i, (a, b) in enumerate(zip(counts(), c0)):
                    seen[arm][i] += a - b
    cold_fold()
    med = {k: statistics.median(v) for k, v in secs.items()}
    return dict(median_s=med, over_off={k: med[k] / med["off"]
                                        for k in ("on", "all")},
                sweeps=secs,
                dispatches_a_sweep={k: seen[k][0] / len(secs[k])
                                    for k in ("on", "all")},
                synced_a_sweep={k: seen[k][1] / len(secs[k])
                                for k in ("on", "all")})


def spec_of(lay) -> dict:
    s = lay.spec
    return dict(P=s.partitions, n_per=s.n_per, cap=s.cap, cap_u=s.cap_u,
                preagg=s.preagg, B=lay.B)


def phase_pcpm(torch, np, columns, log, ldbc, dev):
    """The destination-binned (PCPM) route with the knob UNSET (auto, the
    JAX package's default), on every path of the earlier phases whose
    table bins: the headline PageRank, cc_range CC, LDBC BFS / SSSP /
    SSSP chunks=2 (delta route), the same four on the host-column route,
    and a cold GAB View (the descending-time PageRank View at 0.90 x
    t_span, through the jobs layer and ``bsp.run``). Each run is held
    against the unbinned route on the card (``torch.equal``, equal steps:
    the binned walks keep the unbinned sum order, so PageRank too) and
    against the binned run on the CPU (CC / BFS / SSSP bitwise, PageRank
    within rtol 1e-5 / atol 1e-7, equal steps)."""
    from raphtory_tpu_torch.algorithms import PageRank
    from raphtory_tpu_torch.core.snapshot import build_view
    from raphtory_tpu_torch.engine import bsp
    from raphtory_tpu_torch.engine.hopbatch import (HopBatchedBFS,
                                                    HopBatchedCC,
                                                    HopBatchedPageRank,
                                                    HopBatchedSSSP)
    from raphtory_tpu_torch.jobs.manager import ViewQuery
    from raphtory_tpu_torch.ops import partition

    hops, windows = headline_grid()
    ldbc_hops = [int(T) for T in
                 np.linspace(0.5 * LDBC_SPAN, LDBC_SPAN, 10).astype(np.int64)]
    ldbc_windows = [1_300_000, 604_800]
    budget = partition.tile_budget_bytes()
    torch.cuda.reset_peak_memory_stats()
    layouts = {}
    with knobs(RTPU_PCPM=None):
        for name, lg in (("gab", log), ("ldbc", ldbc)):
            tables = HopBatchedCC(lg, device="cpu").tables
            t0 = time.perf_counter()
            lay = partition.resolve(lg, tables, budget)
            build_s = time.perf_counter() - t0
            if lay is None:
                raise AssertionError(f"pcpm: the {name} table does not bin "
                                     f"under auto (m_pad {tables.m_pad})")
            layouts[name] = dict(spec_of(lay), m_pad=tables.m_pad,
                                 layout_build_s=build_s)
        kinds = {
            "headline": (lambda d: HopBatchedPageRank(
                log, tol=1e-7, max_steps=20, device=d), hops, windows,
                dict(chunks=3, warm_start=True),
                ("column_out_degree", "binned_pull_sum", "pagerank_update")),
            "cc_range": (lambda d: HopBatchedCC(log, max_steps=50, device=d),
                         hops, [GAB_SPAN], dict(chunks=1),
                         ("binned_cc_superstep",)),
            "ldbc_bfs": (lambda d: HopBatchedBFS(
                ldbc, LDBC_SEEDS, directed=False, max_steps=32, device=d),
                ldbc_hops, ldbc_windows, dict(chunks=1),
                ("binned_minplus_superstep",)),
            "ldbc_sssp": (lambda d: HopBatchedSSSP(
                ldbc, LDBC_SEEDS, "weight", directed=False, max_steps=32,
                device=d), ldbc_hops, ldbc_windows, dict(chunks=1),
                ("binned_minplus_superstep", "weights_from_deltas")),
            "ldbc_sssp_chunks2": (lambda d: HopBatchedSSSP(
                ldbc, LDBC_SEEDS, "weight", directed=False, max_steps=32,
                device=d), ldbc_hops, ldbc_windows, dict(chunks=2),
                ("binned_minplus_superstep", "weights_from_deltas")),
        }
        total = {k: 0 for k in columns.LAUNCHES}
        result, binned = {}, {}
        for route in ("delta", "host"):
            for name, (make, h, w, kw, kernels) in kinds.items():
                if route == "host" and name == "ldbc_sssp_chunks2":
                    continue
                key = name if route == "delta" else f"host_{name}"
                with knobs(RTPU_FOLD=route):
                    got, steps, launches, stats = timed_sweep(
                        torch, columns, lambda: make(dev), h, w, **kw)
                    spec = make(dev)._resolve_layout().spec
                    with knobs(RTPU_PCPM="0"):
                        cold_fold()
                        flat, flat_steps = make(dev).run(h, w, **kw)
                    cold_fold()
                    ref, ref_steps = make("cpu").run(h, w, **kw)
                if not torch.equal(got, flat) or steps != flat_steps:
                    raise AssertionError(
                        f"pcpm {key}: the binned route differs from the "
                        f"unbinned one on the card (steps {steps} vs "
                        f"{flat_steps})")
                got_c = got.cpu()
                if name == "headline":
                    err = float((got_c - ref).abs().max())
                    if not within_tol(got_c, ref) or steps != ref_steps:
                        raise AssertionError(
                            f"pcpm {key} differs from the CPU run: max abs "
                            f"err {err}, steps {steps} vs {ref_steps}")
                    stats["max_abs_err_vs_cpu"] = err
                else:
                    bitwise_vs_cpu(f"pcpm {key}", got, steps, ref, ref_steps)
                if route == "delta":
                    binned[name] = got
                    check_launched(f"pcpm {key}", launches,
                                   ("masks_from_deltas",) + kernels)
                else:
                    if not torch.equal(got, binned[name]):
                        raise AssertionError(f"pcpm {key}: the host-column "
                                             "route differs from the delta "
                                             "route")
                    check_launched(f"pcpm {key}", launches,
                                   ("bin_masks",) + tuple(
                                       k for k in kernels
                                       if k != "weights_from_deltas"))
                step_kernel = {"cc_range": "binned_cc_superstep",
                               "ldbc_bfs": "binned_minplus_superstep",
                               "ldbc_sssp": "binned_minplus_superstep"}
                if name in step_kernel:           # chunks=1: one dispatch
                    one_launch_a_superstep(f"pcpm {key}", launches,
                                           step_kernel[name], steps)
                if name == "headline" and launches["binned_pull_sum"] != \
                        launches["pagerank_update"] - kw["chunks"]:
                    # a prime a chunk, then a pull and an update a superstep
                    raise AssertionError(
                        f"pcpm {key}: not one K2b-P launch a superstep "
                        f"({launches['binned_pull_sum']} K2b-P, "
                        f"{launches['pagerank_update']} K2c, "
                        f"{kw['chunks']} chunks)")
                flat_k = [k for k in ("column_pull_sum", "cc_superstep",
                                      "minplus_superstep", "column_masks")
                          if launches[k]]
                if flat_k:
                    raise AssertionError(f"pcpm {key}: unbinned kernels "
                                         f"launched: {flat_k}")
                for k, v in launches.items():
                    total[k] += v
                result[key] = dict(stats, spec=list(spec),
                                   bitwise_vs_unbinned=True)

        # the cold GAB View: a View at t_span, then one behind it at 0.90
        # (the cold route, binned), through the jobs layer; then the same
        # view through bsp.run, card binned against card unbinned and CPU
        pr = PageRank(max_steps=20, tol=1e-7)
        T0, T1 = GAB_SPAN, int(0.90 * GAB_SPAN)
        jobs = [(pr, ViewQuery(T0, window=2_600_000)),
                (pr, ViewQuery(T1, window=2_600_000))]
        columns.reset_launches()
        rows, secs, _, _ = run_view_jobs(log, dev, jobs)
        torch.cuda.synchronize()
        launches = dict(columns.LAUNCHES)
        check_launched("pcpm cold_view", launches,
                       ("partition_segment_reduce", "unpack_mask_bits"))
        compare_rows("pcpm cold_view", rows,
                     run_view_jobs(log, "cpu", jobs)[0])
        for k, v in launches.items():
            total[k] += v
        view = build_view(log, T1)
        lay = bsp._view_layout(view)
        t0 = time.perf_counter()
        got, steps = bsp.run(pr, view, window=2_600_000, device=dev)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        with knobs(RTPU_PCPM="0"):
            t0 = time.perf_counter()
            flat, flat_steps = bsp.run(pr, view, window=2_600_000,
                                       device=dev)
            torch.cuda.synchronize()
            flat_s = time.perf_counter() - t0
        ref, ref_steps = bsp.run(pr, view, window=2_600_000, device="cpu")
        if not torch.equal(got, flat) or steps != flat_steps:
            raise AssertionError("pcpm cold_view: the binned exchange differs "
                                 "from the flat one on the card")
        if not within_tol(got.cpu(), ref) or steps != ref_steps:
            raise AssertionError("pcpm cold_view differs from the CPU run")
        result["cold_view"] = dict(
            view_s=secs, T=[T0, T1], bsp_run_s=run_s,
            bsp_run_unbinned_s=flat_s, supersteps=steps,
            spec=spec_of(lay), m_pad=view.m_pad, m_active=view.m_active,
            launches=launches,
            max_abs_err_vs_cpu=float((got.cpu() - ref).abs().max()))
    emit("pcpm", layouts=layouts, runs=result, launches=total,
         peak_device_bytes=torch.cuda.max_memory_allocated())
    # each binned kernel's launches on the path that runs it
    runs = {k: v["launches"] for k, v in result.items()}
    return {
        "bin_masks": sum(v["bin_masks"] for k, v in runs.items()
                         if k.startswith("host_")),
        "binned_pull_sum": runs["headline"]["binned_pull_sum"],
        "binned_cc_superstep": runs["cc_range"]["binned_cc_superstep"],
        "binned_minplus_superstep": sum(
            runs[k]["binned_minplus_superstep"]
            for k in ("ldbc_bfs", "ldbc_sssp", "ldbc_sssp_chunks2")),
        "partition_segment_reduce":
            runs["cold_view"]["partition_segment_reduce"]}


#: the scale phase's edge events: 2^24, cut from 2^25 (its host fold took
#: ~130 s there) to pay for the serve phase within the run's time limit
SCALE_EVENTS = 1 << 24


def phase_scale(torch, np, columns, HopBatchedPageRank, dev):
    from raphtory_tpu_torch.core.sweep import fold_workers
    from raphtory_tpu_torch.utils.synth import gab_like_log

    t0 = time.perf_counter()
    log = gab_like_log(5_300_000, SCALE_EVENTS, seed=11, t_span=GAB_SPAN)
    gen_s = time.perf_counter() - t0
    # 2 hops (cut from 4, and from bench's 16 x 8, for the host fold's
    # time: this phase measures the fold, not the device)
    hops = [int(T) for T in
            np.linspace(0.45 * GAB_SPAN, GAB_SPAN, 2).astype(np.int64)]
    torch.cuda.reset_peak_memory_stats()
    columns.reset_launches()
    t0 = time.perf_counter()
    hb = HopBatchedPageRank(log, tol=1e-7, max_steps=20, device=dev)
    setup_s = time.perf_counter() - t0
    # K1's calls of the sweep, kept for ``scale_k1`` (a list append each)
    k1_calls = []
    own = columns.masks_from_deltas
    columns.masks_from_deltas = (
        lambda *a: k1_calls.append(a) or own(*a))
    cold_fold()
    try:
        t0 = time.perf_counter()
        ranks, steps = hb.run(hops, WINDOWS, chunks=2, warm_start=True)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
    finally:
        columns.masks_from_deltas = own
    launches = dict(columns.LAUNCHES)
    check_launched("scale", launches, PAGERANK_KERNELS)
    if not bool(torch.isfinite(ranks).all()):
        raise AssertionError("non-finite ranks at scale")
    sums = ranks.double().sum(1).cpu()
    if bool(((sums - 1.0).abs() > 1e-4).any()):
        raise AssertionError(f"scale rank sums off 1: {sums.tolist()}")
    n_views = len(hops) * len(WINDOWS)
    emit("scale", n_edge_events=SCALE_EVENTS, n=hb.tables.n, m=hb.tables.m,
         n_pad=hb.tables.n_pad, m_pad=hb.tables.m_pad, views=n_views,
         gen_s=gen_s, setup_s=setup_s, **fold_stats(hb, sweep_s),
         fold_workers=fold_workers(), fold_cache=cache_stats(),
         views_per_s=n_views / sweep_s, supersteps=steps,
         peak_device_bytes=torch.cuda.max_memory_allocated(),
         launches=launches,
         k1_edge=scale_k1(torch, columns, k1_calls, hb.tables.m_pad))


def scale_k1(torch, columns, calls, m_pad: int) -> dict:
    """K1 on the ``scale`` sweep's edge payload: the sweep's own edge calls
    (two dispatches of one hop, the second with ``h0`` and the hop's
    catch-up deltas) timed as they ran, and the two hops as one call of H 2
    without ``h0`` (the first dispatch's base, the second's deltas and
    column bounds), each bitwise its twin (and the parent's kernel, timed
    in turns, with ``--parent``), with its device time and bound."""
    edge = [c for c in calls if c[0].shape[0] == m_pad]
    if len(edge) != 2 or edge[0][9] or not edge[1][9]:
        raise AssertionError(f"scale: K1's edge calls were {len(edge)}, "
                             "not one without h0 and one with it")
    (bl, ba, p0, l0, a0, lo0, nw0, _, W, _), second = edge
    p1, l1, a1, lo1, nw1 = second[2:7]
    U = max(p0.shape[1], p1.shape[1])

    def two(first, row, fill):
        out = torch.full((2, U), fill, dtype=row.dtype, device=row.device)
        out[0, :first.shape[1]] = first[0]
        out[1, :row.shape[1]] = row[0]
        return out

    tbytes = bl.element_size()
    out = {}
    for key, args in (
            ("h0_call", second),
            ("H2", (bl, ba, two(p0, p1, 2**31 - 1), two(l0, l1, 0),
                    two(a0, a1, False), torch.cat([lo0, lo1]),
                    torch.cat([nw0, nw1]), 2, W, False))):
        H = args[7]
        got = columns.masks_from_deltas(*args)
        if not all(torch.equal(g, x) for g, x in zip(
                got, columns.masks_from_deltas_plain(*args))):
            raise AssertionError(f"scale: K1's {key} differs from its twin")
        del got
        pos = args[2]
        live = int(((pos >= 0) & (pos < m_pad))[0 if args[9] else 1:].sum())
        entry = dict(shape=f"len={m_pad} H={H} W={W} U={pos.shape[1]} "
                           f"h0={args[9]} live_updates={live}",
                     ms=cuda_ms(torch, lambda: columns.masks_from_deltas(
                         *args), iters=5),
                     bound_ms=k1_bound(m_pad, H * W, live, tbytes))
        entry["device_ms"], entry["device_by"] = device_ms(
            torch, lambda: columns.masks_from_deltas(*args), iters=5)
        out[key] = entry
    return out


#: ``bench.py:bench_scale_pagerank``'s sweep: 16 one-hour hops from
#: 0.8 t_span x 8 windows (month, 2 weeks, week, 3 days, day, 12 h, 6 h,
#: hour) = 128 columns, 10 supersteps (tol 0)
SCALE_WINDOWS = [2_600_000, 1_209_600, 604_800, 259_200, 86_400, 43_200,
                 21_600, 3_600]
SCALE_KERNELS = ("scale_hop_masks", "column_out_degree", "column_pull_sum",
                 "pagerank_update")


def scale_hops(k: int) -> list[int]:
    return [int(0.8 * GAB_SPAN) + 3_600 * j for j in range(1, k + 1)]


def phase_scale_bulk(torch, np, columns, dev):
    """``bench.py:bench_scale_pagerank``'s shape, nothing cut: the bulk
    loader over ``gab_like_arrays(5.3M, 2^25, seed 11)``, then
    ``run_scale_columns`` (K4, K2) over 128 columns, 10 supersteps. The
    load, the static uploads and ``prepare_scale_payload`` run once,
    outside the timed sweeps; one warm call, then two timed sweeps. K4 and
    K2a/b/c are then held against their twins at this shape, and a small
    stream over the same grid against the CPU and against the host-column
    route."""
    from raphtory_tpu_torch.core.bulk import (bulk_hop_columns,
                                              bulk_hop_deltas)
    from raphtory_tpu_torch.engine.hopbatch import (prepare_scale_payload,
                                                    run_columns,
                                                    run_scale_columns)
    from raphtory_tpu_torch.utils.synth import gab_like_arrays

    n_v, iters = 5_300_000, 10
    hops, windows = scale_hops(16), SCALE_WINDOWS
    n_views = len(hops) * len(windows)
    t0 = time.perf_counter()
    src, dst, times = gab_like_arrays(n_vertices=n_v, n_edges=1 << 25,
                                      seed=11, t_span=GAB_SPAN)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bulk, base_e, base_v, d_e, d_v = bulk_hop_deltas(src, dst, times, hops,
                                                     n_vertices=n_v)
    bulk_s = time.perf_counter() - t0
    del src, dst, times
    t0 = time.perf_counter()
    kw = dict(tol=0.0, max_steps=iters, device=dev,
              edges=tuple(torch.from_numpy(a).to(dev) for a in (
                  bulk.e_src, bulk.e_dst, bulk.in_indptr)),
              prepared=prepare_scale_payload(d_e, d_v, hops, windows,
                                             device=dev))
    base_e, base_v = (torch.from_numpy(a).to(dev) for a in (base_e, base_v))
    # K2a's source walk over the bulk graph: built on the card at the
    # first sweep's first call (here, so that its time shows apart) and
    # checked there once; both cached with the edge table
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    e_src = kw["edges"][0]
    walk = columns.source_walk(e_src, bulk.m, bulk.n_pad)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    columns._check_walk("column_out_degree", e_src, walk, bulk.n_pad)
    walk_check_s = time.perf_counter() - t1
    skew = dict(
        max_out_degree=int((walk[0][1:] - walk[0][:-1]).max()),
        max_in_degree=int((kw["edges"][2][1:] - kw["edges"][2][:-1]).max()),
        mean_degree=bulk.m / bulk.n)

    def sweep():
        return run_scale_columns(bulk, base_e, base_v, d_e, d_v, hops,
                                 windows, **kw)

    warm, _ = sweep()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    del warm
    torch.cuda.reset_peak_memory_stats()
    reps = []
    for _ in range(2):
        columns.reset_launches()
        t0 = time.perf_counter()
        ranks, steps = sweep()
        torch.cuda.synchronize()
        reps.append(time.perf_counter() - t0)
        launches = dict(columns.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_launched("scale_bulk", launches, SCALE_KERNELS)
    if launches["scale_hop_masks"] > 4:
        raise AssertionError(f"scale_bulk: K4 launched "
                             f"{launches['scale_hop_masks']} times in a "
                             "sweep (two calls, two launches each)")
    if steps != iters:
        raise AssertionError(f"scale_bulk ran {steps} supersteps, not "
                             f"{iters} (tol 0 never halts)")
    if ranks.shape != (n_views, bulk.n_pad) \
            or not bool(torch.isfinite(ranks).all()):
        raise AssertionError(f"scale_bulk: bad ranks {tuple(ranks.shape)}")
    sums = ranks.double().sum(1).cpu()
    if bool(((sums - 1.0).abs() > 1e-4).any()):
        raise AssertionError(f"scale_bulk rank sums off 1: {sums.tolist()}")
    # the sweep's last ranks, entity-major: uneven state for the kernel
    # checks below; the ranks themselves stay for the binned route's check
    r0 = ranks.t().contiguous()

    # K4, K2a, K2b and K2c at this shape, on this run's payload and ranks,
    # each against its twin on the same card tensors; K2b and K2c then
    # timed a superstep (these launches come after the counts were read).
    # The twins of K2a and K2b run 32 columns at a time (every column is
    # independent; their [m_pad, C] temporaries would take 34 GB whole).
    H, W = len(hops), len(windows)
    C = H * W
    prep = kw["prepared"]
    e_src, e_dst, indptr = kw["edges"]
    errs = {}
    me = columns.scale_hop_masks(base_e, *prep[2:4], prep[6], H, W)
    mv = columns.scale_hop_masks(base_v, *prep[4:7], H, W)
    for got, args in ((me, (base_e, *prep[2:4], prep[6])),
                      (mv, (base_v, *prep[4:7]))):
        if not torch.equal(got, columns.scale_hop_masks_plain(*args, H, W)):
            raise AssertionError("scale_bulk: K4 differs from its twin on "
                                 "the scale payload")
    errs["scale_hop_masks"] = 0.0

    def by_columns(fn):
        return torch.cat([fn(slice(c, c + 32)) for c in range(0, C, 32)],
                         dim=1)

    def hold(name, got, want):
        err = (got - want).abs()
        errs[name] = max(errs.get(name, 0.0), float(err.max()))
        if bool((err > 1e-7 + 1e-5 * want.abs()).any()):
            raise AssertionError(f"scale_bulk: {name} differs from its twin "
                                 f"at the scale shape: max abs err "
                                 f"{errs[name]}")

    n_pad, m_pad, m = bulk.n_pad, bulk.m_pad, bulk.m
    deg = columns.column_out_degree(me, e_src, n_pad, walk)
    if not torch.equal(deg, by_columns(
            lambda s: columns.column_out_degree_plain(me[:, s], e_src,
                                                      n_pad))):
        raise AssertionError("scale_bulk: K2a differs from its twin at the "
                             "scale shape")
    errs["column_out_degree"] = 0.0
    n_act = torch.clamp(mv.to(torch.float32).sum(0), min=1.0)
    states = []
    for update in (columns.pagerank_update, columns.pagerank_update_plain):
        st = columns.rank_state(r0.clone())
        update(st, None, deg, mv, n_act, 0.85, 0.0, prime=True)
        states.append(st)
    st, st_p = states
    hold("pagerank_update", st.rd, st_p.rd)
    hold("pagerank_update", st.dangling, st_p.dangling)
    agg = columns.column_pull_sum(me, st.rd, e_src, e_dst, indptr)
    hold("column_pull_sum", agg, by_columns(
        lambda s: columns.column_pull_sum_plain(me[:, s], st.rd[:, s],
                                                e_src, e_dst)))
    columns.pagerank_update(st, agg, deg, mv, n_act, 0.85, 0.0)
    columns.pagerank_update_plain(st_p, agg, deg, mv, n_act, 0.85, 0.0)
    for what in ("r", "rd", "dangling"):
        hold("pagerank_update", getattr(st, what), getattr(st_p, what))
    if not (torch.equal(st.halted, st_p.halted)
            and torch.equal(st.done, st_p.done)):
        raise AssertionError("scale_bulk: K2c halting differs from its twin")
    del st_p, r0, states
    repeat_bitwise(torch, columns, st, agg, deg, mv, n_act, 0.0,
                   "K2c at the scale shape")
    # K2b's input: the updated state's rd (agg above read the primed one)
    rd = st.rd.clone()
    agg = columns.column_pull_sum(me, rd, e_src, e_dst, indptr)
    k2a_ms = cuda_ms(torch, lambda: columns.column_out_degree(
        me, e_src, n_pad, walk), iters=3)
    k2b_ms = cuda_ms(torch, lambda: columns.column_pull_sum(
        me, rd, e_src, e_dst, indptr), iters=3)
    k2c_ms = cuda_ms(torch, lambda: columns.pagerank_update(
        st, agg, deg, mv, n_act, 0.85, 0.0), iters=3)
    # K4's two calls alone on this payload, with their device time
    U_e, U_v = prep[0], prep[1]
    k4 = {}
    for key, args, length, U in (
            ("edge", (base_e, *prep[2:4], prep[6], H, W), m_pad, U_e),
            ("vertex", (base_v, *prep[4:7], H, W), n_pad, U_v)):
        k4[f"k4_{key}_ms"] = cuda_ms(
            torch, lambda: columns.scale_hop_masks(*args), iters=3)
        k4[f"k4_{key}_device_ms"], _ = device_ms(
            torch, lambda: columns.scale_hop_masks(*args), iters=3)
        k4[f"k4_{key}_bound_ms"] = bound(length * 4 + H * U * 8 + C * 4
                                         + length * C)[0]
    # the bounds at this shape (inputs read once, outputs written once;
    # K2b's gathers also counted, as K2b-P's, on these masks)
    k2_bounds = dict(
        k2a_bound_ms=k2a_bound(m, n_pad, C)[0],
        k2b_bound_ms=k2b_bound(m, n_pad, C, 0)[0],
        k2c_bound_ms=k2c_bound(n_pad, C)[0],
        **{f"k2b_{k}": v for k, v in gather_bounds(
            torch, me, m, n_pad, C, 4).items()})
    k2a_lib_ms, k2a_lib_by = k2a_library_ms(torch, me, e_src, n_pad)
    del me, mv, deg, st, agg, rd
    best = min(reps)
    emit("scale_bulk", n_edge_events=1 << 25, n=bulk.n, m=m, n_pad=n_pad,
         m_pad=m_pad, hops=H, windows=W, views=n_views, U_e=U_e, U_v=U_v,
         gen_s=gen_s, bulk_s=bulk_s, setup_s=setup_s,
         source_walk_s=walk_s, source_walk_check_s=walk_check_s,
         source_walk_bytes=m * 4 + (n_pad + 1) * 8, **skew, sweep_s=best,
         repeat_sweep_s=reps, views_per_s=n_views / best, supersteps=steps,
         k2a_ms_per_call=k2a_ms, k2a_library_ms=k2a_lib_ms,
         k2a_library_by=k2a_lib_by, k2b_ms_per_superstep=k2b_ms,
         k2c_ms_per_superstep=k2c_ms, **k2_bounds, **k4,
         peak_device_bytes=peak, launches=launches,
         max_abs_err_vs_twins=errs)
    pcpm_launches, pcpm_errs = scale_bulk_pcpm(
        torch, np, columns, bulk, base_e, base_v, sweep, kw, ranks, steps)
    del kw, base_e, base_v, bulk, d_e, d_v, ranks
    torch.cuda.empty_cache()

    # ---- crosscheck: a small add-only stream over the same 16 x 8 grid,
    # on the card against the CPU (twins), and against the host-column
    # route
    src, dst, times = gab_like_arrays(n_vertices=30_000, n_edges=300_000,
                                      seed=7, t_span=GAB_SPAN)
    loaded = bulk_hop_deltas(src, dst, times, hops, n_vertices=30_000)
    ckw = dict(tol=0.0, max_steps=iters)
    got, steps = run_scale_columns(*loaded, hops, windows, device=dev, **ckw)
    ref, ref_steps = run_scale_columns(*loaded, hops, windows, device="cpu",
                                       **ckw)
    err = (got.cpu() - ref).abs()
    if bool((err > 1e-7 + 1e-5 * ref.abs()).any()) or steps != ref_steps:
        raise AssertionError(f"scale crosscheck differs from the CPU run: "
                             f"max abs err {float(err.max())}, steps "
                             f"{steps} vs {ref_steps}")
    host, host_steps = run_columns(*bulk_hop_columns(
        src, dst, times, hops, n_vertices=30_000), hops, windows,
        device=dev, **ckw)
    if not torch.equal(host, got) or host_steps != steps:
        raise AssertionError("scale crosscheck: run_columns over the bulk "
                             "host columns differs from run_scale_columns")
    t_phase = time.perf_counter()
    with knobs(RTPU_PCPM=None):
        from raphtory_tpu_torch.ops import partition

        lay = partition.resolve(loaded[0], loaded[0],
                                partition.tile_budget_bytes())
        if lay is None:
            raise AssertionError("scale crosscheck: the stream does not bin "
                                 "under auto")
        got_b, steps_b = run_scale_columns(*loaded, hops, windows,
                                           device=dev, **ckw)
        ref_b, ref_steps_b = run_scale_columns(*loaded, hops, windows,
                                               device="cpu", **ckw)
        bg, *cols = bulk_hop_columns(src, dst, times, hops,
                                     n_vertices=30_000)
        host_b, host_steps_b = run_columns(
            bg, *cols, hops, windows, device=dev,
            layout=partition.resolve(bg, bg, partition.tile_budget_bytes()),
            **ckw)
    err_b = (got_b.cpu() - ref_b).abs()
    if not within_tol(got_b.cpu(), ref_b) or steps_b != ref_steps_b:
        raise AssertionError(f"binned scale crosscheck differs from the CPU "
                             f"run: max abs err {float(err_b.max())}")
    if not torch.equal(got_b, got) or steps_b != steps:
        raise AssertionError("binned scale crosscheck differs from the "
                             "unbinned route on the card")
    if not torch.equal(host_b, got_b) or host_steps_b != steps_b:
        raise AssertionError("binned scale crosscheck: the bulk host "
                             "columns (KB1) differ from run_scale_columns")
    PHASE_S["scale_bulk_crosscheck_pcpm"] = time.perf_counter() - t_phase
    emit("scale_bulk_crosscheck", n=loaded[0].n, m=loaded[0].m,
         views=len(hops) * len(windows), supersteps=steps,
         max_abs_err_vs_cpu=float(err.max()),
         host_columns_bitwise=True, pcpm_spec=spec_of(lay),
         pcpm_max_abs_err_vs_cpu=float(err_b.max()),
         pcpm_bitwise_vs_unbinned=True, pcpm_host_columns_bitwise=True)
    return launches, errs, pcpm_launches, pcpm_errs


def binned_upload(torch, np, lay, dev, reverse: bool, reps: int = 3):
    """A binned layout's device tables as its dispatch ships them (the six
    ``device_args`` tables, then the walks, the source walk with
    ``reverse``) two ways in turns, ``reps`` rounds, the first in each
    round alternating: the parent tree's one pageable ``.to`` a table, and
    this tree's two ``put_many`` through the shared transfer engine; every
    table held bitwise. Seconds a round each way (synchronized), their
    medians' ratio, and the engine's stats over its rounds."""
    import statistics

    from raphtory_tpu_torch.utils.transfer import shared_engine

    eng = shared_engine()
    args = [lay.b_src, lay.b_dst, lay.valid, lay.slot, lay.u_src, lay.perm]
    walks = list(lay.walk(False)) + (list(lay.walk(True)) if reverse
                                     else [])

    def parent():
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in args + walks]

    def engine():
        return eng.put_many(args, dev) + eng.put_many(walks, dev)

    secs = {"parent": [], "engine": []}
    prior = eng.stats.as_dict()
    for r in range(reps):
        order = (("parent", parent), ("engine", engine))
        got = {}
        for name, fn in order if r % 2 == 0 else order[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[name] = fn()
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t0)
        if not all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got["parent"], got["engine"])):
            raise AssertionError("binned upload: the engine's tables differ "
                                 "from the parent's")
        del got
    return dict(bytes=int(sum(a.nbytes for a in args + walks)),
                tables=len(args + walks), parent_s=secs["parent"],
                engine_s=secs["engine"],
                ratio=statistics.median(secs["engine"])
                / statistics.median(secs["parent"]),
                engine_stats=eng.stats.delta_since(prior))


def scale_bulk_pcpm(torch, np, columns, bulk, base_e, base_v, sweep, kw,
                    flat_ranks, flat_steps):
    """The binned route (knob unset: auto) on ``scale_bulk``'s load: the
    layout built on the bulk graph (set-up, beside ``bulk_s``), one warm
    call and two timed sweeps, the ranks held bitwise against the
    unbinned sweep's; the binned K4 and K2b-P (no pre-aggregation at
    this shape) against their twins at this shape."""
    from raphtory_tpu_torch.ops import partition

    t_phase = time.perf_counter()
    prep = kw["prepared"]
    H, W = len(prep[7][0]), len(prep[7][1])
    C = H * W
    with knobs(RTPU_PCPM=None):
        t0 = time.perf_counter()
        lay = partition.resolve(bulk, bulk, partition.tile_budget_bytes())
        layout_build_s = time.perf_counter() - t0
        if lay is None:
            raise AssertionError("scale_bulk: the bulk table does not bin "
                                 "under auto")
        t0 = time.perf_counter()
        lay.walk(True)                 # K2a's source walk of the layout
        rev_walk_s = time.perf_counter() - t0
        be = lay.device_edges(kw["device"], reverse=True)
        warm, _ = sweep()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        del warm
        torch.cuda.reset_peak_memory_stats()
        reps = []
        for _ in range(2):
            columns.reset_launches()
            t0 = time.perf_counter()
            ranks, steps = sweep()
            torch.cuda.synchronize()
            reps.append(time.perf_counter() - t0)
            launches = dict(columns.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
    check_launched("scale_bulk pcpm", launches, (
        "scale_hop_masks", "column_out_degree", "binned_pull_sum",
        "pagerank_update"))
    if launches["column_pull_sum"] or launches["bin_masks"]:
        raise AssertionError("scale_bulk pcpm: the unbinned K2b or KB1 "
                             "launched")
    if launches["scale_hop_masks"] > 4:
        raise AssertionError(f"scale_bulk pcpm: K4 launched "
                             f"{launches['scale_hop_masks']} times a sweep")
    if not torch.equal(ranks, flat_ranks) or steps != flat_steps:
        raise AssertionError("scale_bulk pcpm: the binned ranks differ from "
                             "the unbinned sweep's")
    # the binned K4 and K2b-P against their twins at this shape (the
    # twins 32 columns at a time); K2b-P timed a superstep
    errs = {}
    k4_args = (base_e, *prep[2:4], prep[6], H, W)
    bins = dict(perm=be.perm, valid=be.valid)
    me = columns.scale_hop_masks(*k4_args, **bins)
    want = columns.scale_hop_masks_plain(*k4_args)
    if not torch.equal(me, want[be.perm.long()] & be.valid[:, None]):
        raise AssertionError("scale_bulk pcpm: the binned K4 differs from "
                             "its twin")
    del want
    k4 = dict(k4_binned_ms=cuda_ms(torch, lambda: columns.scale_hop_masks(
        *k4_args, **bins), iters=3))
    k4["k4_binned_device_ms"], _ = device_ms(
        torch, lambda: columns.scale_hop_masks(*k4_args, **bins), iters=3)
    # the edge call's bytes, perm and valid read once, B rows written
    k4["k4_binned_bound_ms"] = bound(
        bulk.m_pad * 4 + H * prep[0] * 8 + C * 4 + lay.B * (5 + C))[0]
    errs["scale_hop_masks"] = 0.0
    rd = (ranks.t() * 0.5).contiguous()
    del ranks
    agg = columns.binned_pull_sum(me, rd, be)
    want = torch.cat([columns.binned_pull_sum_plain(
        me[:, c:c + 32].contiguous(), rd[:, c:c + 32].contiguous(), be)
        for c in range(0, C, 32)], dim=1)
    err = (agg - want).abs()
    errs["binned_pull_sum"] = float(err.max())
    if bool((err > 1e-7 + 1e-5 * want.abs()).any()):
        raise AssertionError(f"scale_bulk pcpm: K2b-P differs from its twin "
                             f"at the scale shape: {errs['binned_pull_sum']}")
    del want, err
    # K2b over the same masks in engine order: bitwise K2b-P
    e_src, e_dst, indptr = kw["edges"]
    me_flat = columns.scale_hop_masks(base_e, *prep[2:4], prep[6], H, W)
    if not torch.equal(columns.column_pull_sum(me_flat, rd, e_src, e_dst,
                                               indptr), agg):
        raise AssertionError("scale_bulk pcpm: K2b-P differs from K2b over "
                             "the same masks at the scale shape")
    del me_flat
    # K2a on the binned masks, over the layout's source walk
    bwalk = (be.out_indptr, be.out_order)
    deg = columns.column_out_degree(me, be.b_src, bulk.n_pad, bwalk)
    if not torch.equal(deg, torch.cat([columns.column_out_degree_plain(
            me[:, c:c + 32], be.b_src, bulk.n_pad) for c in range(0, C, 32)],
            dim=1)):
        raise AssertionError("scale_bulk pcpm: K2a over the layout's source "
                             "walk differs from its twin")
    del deg
    errs["column_out_degree"] = 0.0
    k2a_ms = cuda_ms(torch, lambda: columns.column_out_degree(
        me, be.b_src, bulk.n_pad, bwalk), iters=3)
    k2bp_ms = cuda_ms(torch, lambda: columns.binned_pull_sum(me, rd, be),
                      iters=3)
    # the bounds: the table's (inputs read once) and the gathers' (the
    # cap-pad rows are masked, so the binned masks count as the m real
    # slots'), with the 8-byte walk pairs
    real, n_pad = bulk.m, bulk.n_pad
    k2bp = dict(k2bp_bound_ms=k2bp_bound(real, n_pad, C, int(me.sum()))[0],
                **{f"k2bp_{k}": v for k, v in gather_bounds(
                    torch, me, real, n_pad, C, 8).items()})
    del me, rd, agg, be
    upload = binned_upload(torch, np, lay, kw["device"], reverse=True)
    best = min(reps)
    PHASE_S["scale_bulk_pcpm"] = time.perf_counter() - t_phase
    emit("scale_bulk_pcpm", spec=spec_of(lay), layout_build_s=layout_build_s,
         source_walk_s=rev_walk_s, setup_s=setup_s, sweep_s=best,
         repeat_sweep_s=reps, views_per_s=C / best, supersteps=steps,
         k2a_ms_per_call=k2a_ms, k2bp_ms_per_superstep=k2bp_ms, **k2bp,
         bitwise_vs_k2b=True, peak_device_bytes=peak, **k4,
         launches=launches, bitwise_vs_unbinned=True,
         max_abs_err_vs_twins=errs, binned_upload=upload)
    return launches, errs


# ------------------------------------------------ slice 6: K10, K7-mode

#: ``bench.py:bench_scale_features``: twitter_like_log(2^22, 2^25, seed 11,
#: t_span 2.6M), F 128, 2 rounds, bf16 storage, self_weight 0.5
FEAT_V, FEAT_E, FEAT_F, FEAT_ROUNDS = 1 << 22, 1 << 25, 128, 2
FEAT_SPAN = 2_600_000


def feature_calls():
    """``bench_scale_features``'s set-up call and its four timed calls."""
    t0 = int(0.8 * FEAT_SPAN)
    return (t0, FEAT_SPAN), [(t0 + 3_600, FEAT_SPAN), (t0 + 3_600, 86_400),
                             (t0 + 7_200, FEAT_SPAN), (t0 + 7_200, 86_400)]


def bf16_ulps(torch, got, want):
    """|got - want| in bf16 ulps of ``want`` (float32 tensors holding bf16
    values); an element below its row's float32 noise floor (a
    cancellation residue) counts in float32 ulps of its row's largest
    element (``tests/test_torch_features._bf16_ulps``)."""
    _, e = torch.frexp(want.abs())
    ulp = torch.where(want == 0, 0.0,
                      torch.ldexp(torch.ones_like(want), e - 8))
    _, er = torch.frexp(want.abs().amax(dim=1, keepdim=True))
    floor = torch.ldexp(torch.ones_like(er, dtype=want.dtype), er - 24)
    return (got - want).abs() / torch.maximum(ulp, floor)


def feature_bounds(torch, fa, H, binned: bool):
    """(bytes, operations) of one round: H read and written once, the edge
    metadata of the real edges read once — the CSR, each edge's time and
    alive flag, and its source (K10: ``e_src``, 4 bytes) or its walk pair
    (K10-P: ``binned_walk``'s source row and edge, 8 bytes, which carry
    ``u_src[slot[s]]`` and ``perm[s]``) — one add a live edge and feature
    plus the per-row epilogue."""
    ds = fa.ds
    e_lat, e_alive = ds.edge_state
    fb, tb = H.element_size(), e_lat.element_size()
    nbytes = (2 * H.numel() * fb + (ds.n_pad + 1) * 8
              + ds.m * ((8 if binned else 4) + tb + 1))
    return nbytes, fa.flops(1)


def sparse_library_ms(torch, fa, lo, nowin, H):
    """``torch.sparse.mm`` of the window-masked CSR in-adjacency by an f32
    H: one round's sum, without the epilogue (the yardstick; the port
    never calls it)."""
    from raphtory_tpu_torch.ops.features import edge_mask

    ds = fa.ds
    e_lat, e_alive = ds.edge_state
    vals = edge_mask(e_lat, e_alive, lo, nowin)[: ds.m].float()
    A = torch.sparse_csr_tensor(ds.edges.in_indptr, ds.edges.e_src[: ds.m]
                                .long(), vals, size=(ds.n_pad, ds.n_pad),
                                check_invariants=False)
    Hf = H.float()
    ms = cuda_ms(torch, lambda: torch.sparse.mm(A, Hf), iters=5)
    del A, Hf
    return ms


def phase_features(torch, np, columns, dev):
    """``bench.py:bench_scale_features`` uncut, with ``RTPU_PCPM`` unset
    (auto): the set-up call at 0.8 t_span (full window), then the four
    timed calls, all on one ``DeviceSweep``; every row finite and unit
    norm; K10 and K10-P held against their twins at this shape (float32
    and bf16) and each other, timed at the last call's day and month
    windows beside their bounds ("H read once", and with every live edge's
    row gathered); with ``--parent``, each held bitwise against the
    parent's and timed in turns with it; then the four calls once more
    under ``RTPU_PCPM=0`` (``features_unbinned``: K10's 8 launches)."""
    from raphtory_tpu_torch.engine.device_sweep import DeviceSweep
    from raphtory_tpu_torch.engine.features import FeatureAggregator
    from raphtory_tpu_torch.ops import features as ops_features
    from raphtory_tpu_torch.utils.synth import twitter_like_log

    t0 = time.perf_counter()
    log = twitter_like_log(n_vertices=FEAT_V, n_edges=FEAT_E, seed=11,
                           t_span=FEAT_SPAN)
    gen_s = time.perf_counter() - t0
    first, calls = feature_calls()
    torch.cuda.reset_peak_memory_stats()
    with knobs(RTPU_PCPM=None):
        t0 = time.perf_counter()
        ds = DeviceSweep(log, device=dev)
        fa = FeatureAggregator(ds, feature_dim=FEAT_F, dtype="bfloat16",
                               self_weight=0.5)
        X = fa.random_features(0)
        H = fa.propagate(X, first[0], window=first[1], rounds=FEAT_ROUNDS)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        spec = fa._active_spec
        del H
        fold0, disp0 = ds.fold_seconds, ds.dispatch_seconds
        columns.reset_launches()
        t0 = time.perf_counter()
        outs = [fa.propagate(X, T, window=w, rounds=FEAT_ROUNDS)
                for T, w in calls]
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = dict(columns.LAUNCHES)
    kernel = "feature_propagate" if spec is None \
        else "feature_propagate_binned"
    check_launched("features", launches, (kernel, "apply_delta_chunk"))
    # K10 and K10-P: one launch a round each
    if launches[kernel] != len(calls) * FEAT_ROUNDS:
        raise AssertionError(f"features: {launches[kernel]} K10 launches "
                             f"for {len(calls)} calls")
    for H in outs:
        norms = torch.linalg.norm(H.float(), dim=1)
        if not bool(torch.isfinite(norms).all()) \
                or float((norms - 1.0).abs().max()) > 1e-2:
            raise AssertionError("features: rows not finite / unit norm")
    # K10 and K10-P alone, on the last call's state, at its day window
    # and at the month window of the same T (most edges live)
    e_lat, e_alive = ds.edge_state
    T, w = calls[-1]
    win = {"day": ops_features.window_bound(T, w, e_lat.dtype),
           "month": ops_features.window_bound(T, FEAT_SPAN, e_lat.dtype)}
    Hb = outs[-1]
    del outs[:-1]
    with knobs(RTPU_PCPM="1"):
        lay = fa._pcpm_layout()
    be = lay.device_edges(dev)
    k10 = {"feature_propagate": (
        lambda H, lo, nw: ops_features.propagate_round(
            H, ds.edges, e_lat, e_alive, lo, nw, 0.5),
        lambda H, lo, nw: ops_features.propagate_round_plain(
            H, ds.edges, e_lat, e_alive, lo, nw, 0.5), None),
        "feature_propagate_binned": (
        lambda H, lo, nw: ops_features.propagate_round_binned(
            H, be, e_lat, e_alive, lo, nw, 0.5),
        lambda H, lo, nw: ops_features.propagate_round_binned_plain(
            H, be, e_lat, e_alive, lo, nw, 0.5), be)}
    live = {k: int(ops_features.edge_mask(e_lat, e_alive, *v).sum())
            for k, v in win.items()}
    times, twin = {}, {}
    for name, (kern, plain, b_e) in k10.items():
        times[name] = {k: cuda_ms(torch, lambda: kern(Hb, *v), iters=10)
                       for k, v in win.items()}
        nbytes, ops = feature_bounds(torch, fa, Hb, b_e is not None)
        row = FEAT_F * Hb.element_size()
        # "H read once" plus every live edge's source row gathered: by
        # bytes, and in the 32-byte sectors a row spans
        gather = {k: bound(nbytes + live[k] * row, ops)[0] for k in win}
        sectors = {k: bound(nbytes + live[k] * -(-row // 32) * 32, ops)[0]
                   for k in win}
        times[name]["plain"] = cuda_ms(torch, lambda: plain(Hb, *win["day"]),
                                       iters=3)
        # the twin check at this shape: bf16 (the path's storage), then f32
        got = kern(Hb, *win["day"]).float()
        want = plain(Hb, *win["day"]).float()
        ulps = float(bf16_ulps(torch, got, want).max())
        differ = int((got != want).sum())
        del got, want
        Hf = Hb.float()
        got = kern(Hf, *win["day"])
        want = plain(Hf, *win["day"])
        f32_err = float((got - want).abs().max())
        del got, want, Hf
        torch.cuda.empty_cache()
        if f32_err > 1e-5 or ulps > 2:
            raise AssertionError(f"features: {name} differs from its twin "
                                 f"(f32 {f32_err}, bf16 {ulps} ulps)")
        twin[name] = dict(f32_max_abs_err=f32_err, bf16_elements_differ=differ,
                          bf16_max_ulps=ulps, bound=bound(nbytes, ops),
                          gather_bound_ms=gather,
                          gather_sector_bound_ms=sectors)
    # the two routes add in one order: equal on the card at both windows
    for v in win.values():
        if not torch.equal(k10["feature_propagate"][0](Hb, *v),
                           k10["feature_propagate_binned"][0](Hb, *v)):
            raise AssertionError("features: K10-P differs from K10")
    library_ms = sparse_library_ms(torch, fa, *win["day"], Hb)
    library_ms_month = sparse_library_ms(torch, fa, *win["month"], Hb)
    path_ms = times[kernel]
    unbinned = features_unbinned(torch, columns, ds, fa, X, calls)
    # the row gathers' rate: live edges x row bytes over a round
    gather_gbps = {name: {k: live[k] * FEAT_F * Hb.element_size()
                          / (t[k] * 1e6) for k in win}
                   for name, t in times.items()}
    emit("features", n_vertices=FEAT_V, n_edge_events=FEAT_E, n=ds.n,
         m=ds.m, n_pad=ds.n_pad, m_pad=ds.m_pad, F=FEAT_F,
         rounds=FEAT_ROUNDS, dtype="bfloat16", tdtype=str(e_lat.dtype),
         views=len(calls), views_per_s=len(calls) / elapsed,
         sweep_s=elapsed, gen_s=gen_s, setup_s=setup_s,
         fold_s=ds.fold_seconds - fold0,
         dispatch_s=ds.dispatch_seconds - disp0,
         spec=None if spec is None else spec._asdict(), path_kernel=kernel,
         ms_per_round=times, live_edges=live, gather_gb_per_s=gather_gbps,
         walk_bytes=ds.m * 8,
         # the path kernel's rounds over the timed sweep, half of the calls
         # at each window
         kernel_share_of_sweep=(path_ms["day"] + path_ms["month"])
         * len(calls) * FEAT_ROUNDS / 2e3 / elapsed,
         traffic_bytes_per_call=fa.traffic_bytes(FEAT_ROUNDS),
         flops_per_call=fa.flops(FEAT_ROUNDS),
         peak_device_bytes=torch.cuda.max_memory_allocated(),
         launches=launches, unbinned=unbinned, twin=twin,
         binned_equals_unbinned=True,
         library_ms=library_ms, library_ms_month_window=library_ms_month)
    entries = {name: dict(
        source="raphtory_tpu_torch/csrc/features.cu",
        replaces="raphtory_tpu/engine/features.py:36" if b_e is None
        else "raphtory_tpu/engine/features.py:62",
        max_abs_err=twin[name]["f32_max_abs_err"], ms=times[name]["day"],
        plain_ms=times[name]["plain"], library_ms=library_ms,
        shape=f"n_pad={ds.n_pad} m_pad={ds.m_pad} F={FEAT_F} bf16 "
              f"{e_lat.dtype} day window"
              + ("" if b_e is None else f" P={lay.spec.partitions} "
                 f"cap={lay.spec.cap} cap_u={lay.spec.cap_u} U={b_e.U}"),
        **dict(zip(("bound_ms", "bound_by"), twin[name]["bound"])))
        for name, (_, _, b_e) in k10.items()}
    del outs, X, Hb, fa, ds, log, be, lay
    torch.cuda.empty_cache()
    # K10's launches: the unbinned sweep's, one a round
    launches["feature_propagate"] = unbinned["launches"]["feature_propagate"]
    return launches, entries


def features_unbinned(torch, columns, ds, fa, X, calls) -> dict:
    """The ``features`` path's four calls once more under ``RTPU_PCPM=0``
    (K10, one launch a round), on the same sweep two hops on: each call's
    time moved by 7,200 s (the sweep cannot go back, and a fresh one
    would fold the whole log again), the same windows and rounds. Views/s,
    ``fold_s`` and ``dispatch_s`` beside the binned sweep's; every row
    finite and unit norm."""
    fold0, disp0 = ds.fold_seconds, ds.dispatch_seconds
    shifted = [(T + 7_200, w) for T, w in calls]
    with knobs(RTPU_PCPM="0"):
        columns.reset_launches()
        t0 = time.perf_counter()
        outs = [fa.propagate(X, T, window=w, rounds=FEAT_ROUNDS)
                for T, w in shifted]
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = dict(columns.LAUNCHES)
        spec = fa._active_spec
    if spec is not None:
        raise AssertionError("features: RTPU_PCPM=0 still binned")
    check_launched("features unbinned", launches,
                   ("feature_propagate", "apply_delta_chunk"))
    if launches["feature_propagate"] != len(calls) * FEAT_ROUNDS \
            or launches["feature_propagate_binned"]:
        raise AssertionError(f"features unbinned: {launches} launches")
    for H in outs:
        norms = torch.linalg.norm(H.float(), dim=1)
        if not bool(torch.isfinite(norms).all()) \
                or float((norms - 1.0).abs().max()) > 1e-2:
            raise AssertionError("features unbinned: rows not finite / "
                                 "unit norm")
    return dict(calls=shifted, views=len(calls),
                views_per_s=len(calls) / elapsed, sweep_s=elapsed,
                fold_s=ds.fold_seconds - fold0,
                dispatch_s=ds.dispatch_seconds - disp0, launches=launches)


def row_scale_ulps(torch, got, want):
    """|got - want| in bf16 ulps of each row's largest element: after a
    round whose bf16 output differs by an ulp (the two sum orders round
    apart), the next round mixes that difference into every row it
    reaches, so a 2-round bf16 result is held at its rows' scale."""
    _, e = torch.frexp(want.abs().amax(dim=1, keepdim=True))
    return (got - want).abs() / torch.ldexp(torch.ones_like(want), e - 8)


def phase_features_gab(torch, np, columns, log, dev):
    """The headline GAB log, F 128, f32 and bf16: ``FeatureAggregator``
    with ``RTPU_PCPM=0`` (K10) and ``=1`` (K10-P), 2 rounds, each against
    the CPU twin run (f32 within atol 1e-6; bf16 within 2 bf16 ulps of
    each row's largest element, cosine above 0.9999 a row), binned against
    unbinned on the card (``torch.equal``); one round of each kernel
    against its twin at this shape (bf16 2 ulps elementwise); K10-P at
    F 132 / 260 / 388 / 512, f32 and bf16, bitwise K10 and against its
    twin (f32 atol 1e-5, bf16 2 ulps); then
    ``TemporalEmbeddings`` ``nearest`` / ``drift`` on the card against the
    CPU."""
    from raphtory_tpu_torch.engine.device_sweep import DeviceSweep
    from raphtory_tpu_torch.engine.features import FeatureAggregator
    from raphtory_tpu_torch.examples.embeddings import TemporalEmbeddings
    from raphtory_tpu_torch.ops import features as ops_features

    times = [(int(0.9 * GAB_SPAN), 604_800), (GAB_SPAN, None)]
    X = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (DeviceSweep(log, device="cpu").n_pad, 128)).astype(np.float32))
    runs, specs = {}, {}
    errs = {"f32_max_abs_err": 0.0, "bf16_max_row_ulps": 0.0,
            "bf16_max_elem_ulps": 0.0, "bf16_min_cosine": 1.0}
    total = {k: 0 for k in columns.LAUNCHES}
    for dt in ("float32", "bfloat16"):
        per_mode = {}
        for mode in ("0", "1"):
            with knobs(RTPU_PCPM=mode):
                fas = {d: FeatureAggregator(DeviceSweep(log, device=d), 128,
                                            dtype=dt) for d in (dev, "cpu")}
                columns.reset_launches()
                outs = []
                for T, w in times:
                    t0 = time.perf_counter()
                    H = fas[dev].propagate(X, T, window=w, rounds=2)
                    torch.cuda.synchronize()
                    card_s = time.perf_counter() - t0
                    ref = fas["cpu"].propagate(X, T, window=w,
                                               rounds=2).float()
                    got = H.float().cpu()
                    if dt == "float32":
                        err = float((got - ref).abs().max())
                        errs["f32_max_abs_err"] = max(
                            errs["f32_max_abs_err"], err)
                        ok = err <= 1e-6
                    else:
                        err = float(row_scale_ulps(torch, got, ref).max())
                        cos = float((torch.sum(got * ref, 1) / (
                            torch.linalg.norm(got, dim=1)
                            * torch.linalg.norm(ref, dim=1))).min())
                        errs["bf16_max_row_ulps"] = max(
                            errs["bf16_max_row_ulps"], err)
                        errs["bf16_max_elem_ulps"] = max(
                            errs["bf16_max_elem_ulps"],
                            float(bf16_ulps(torch, got, ref).max()))
                        errs["bf16_min_cosine"] = min(
                            errs["bf16_min_cosine"], cos)
                        ok = err <= 2 and cos > 0.9999
                    if not ok:
                        raise AssertionError(
                            f"features_gab {dt} PCPM={mode} at {T}: card "
                            f"differs from the CPU ({err})")
                    outs.append((H, card_s))
                launches = dict(columns.LAUNCHES)
                kernel = "feature_propagate_binned" if mode == "1" \
                    else "feature_propagate"
                check_launched(f"features_gab {dt} PCPM={mode}", launches,
                               (kernel,))
                for k, v in launches.items():
                    total[k] += v
                spec = fas[dev]._active_spec
                if (spec is None) != (mode == "0"):
                    raise AssertionError(f"features_gab: PCPM={mode} gave "
                                         f"spec {spec}")
                specs[mode] = None if spec is None else spec._asdict()
                per_mode[mode] = outs
        for (a, _), (b, _) in zip(per_mode["0"], per_mode["1"]):
            if not torch.equal(a, b):
                raise AssertionError(f"features_gab {dt}: binned differs "
                                     "from unbinned on the card")
        runs[dt] = {m: [s for _, s in o] for m, o in per_mode.items()}
    # one round of each kernel against its twin at this shape, and timed
    with knobs(RTPU_PCPM="1"):
        fa = FeatureAggregator(DeviceSweep(log, device=dev), 128,
                               dtype="bfloat16")
        T, w = times[0]
        H = fa.propagate(X, T, window=w, rounds=1)
        lay = fa._pcpm_layout()
    ds = fa.ds
    be = lay.device_edges(dev)
    e_lat, e_alive = ds.edge_state
    lo, nowin = ops_features.window_bound(T, w, e_lat.dtype)
    pairs = {"feature_propagate": (
        lambda: ops_features.propagate_round(H, ds.edges, e_lat, e_alive, lo,
                                             nowin, 0.5),
        lambda: ops_features.propagate_round_plain(H, ds.edges, e_lat,
                                                   e_alive, lo, nowin, 0.5)),
        "feature_propagate_binned": (
        lambda: ops_features.propagate_round_binned(H, be, e_lat, e_alive,
                                                    lo, nowin, 0.5),
        lambda: ops_features.propagate_round_binned_plain(
            H, be, e_lat, e_alive, lo, nowin, 0.5))}
    round_check = {}
    for name, (kern, plain) in pairs.items():
        ulps = float(bf16_ulps(torch, kern().float(), plain().float()).max())
        if ulps > 2:
            raise AssertionError(f"features_gab: {name} differs from its "
                                 f"twin ({ulps} ulps)")
        # the GAB shape's bound (one round, this H and layout)
        bnd = bound(*feature_bounds(torch, fa, H,
                                    name == "feature_propagate_binned"))
        round_check[name] = dict(
            bf16_max_ulps_vs_twin=ulps, ms=cuda_ms(torch, kern),
            plain_ms=cuda_ms(torch, plain, iters=5),
            **dict(zip(("bound_ms", "bound_by"), bnd)))
        round_check[name]["device_ms"] = device_ms(torch, kern)[0]
    # every ring depth of K10-P (F 132 / 260 / 388 / 512: 2, 3 and 4
    # groups of 4 features a lane; F 512 float32 holds the widest ring),
    # float32 and bfloat16: bitwise K10, and equal to its twin
    widths = {}
    g = torch.Generator(device=dev).manual_seed(7)
    for F in (132, 260, 388, 512):
        for dt in (torch.float32, torch.bfloat16):
            Hw = torch.randn((ds.n_pad, F), generator=g, device=dev).to(dt)
            got = ops_features.propagate_round_binned(
                Hw, be, e_lat, e_alive, lo, nowin, 0.5)
            k10w = ops_features.propagate_round(Hw, ds.edges, e_lat, e_alive,
                                                lo, nowin, 0.5)
            want = ops_features.propagate_round_binned_plain(
                Hw, be, e_lat, e_alive, lo, nowin, 0.5)
            if dt == torch.float32:
                err = float((got - want).abs().max())
                ok = err <= 1e-5
            else:
                err = float(bf16_ulps(torch, got.float(), want.float()).max())
                ok = err <= 2
            if not torch.equal(got, k10w) or not ok:
                raise AssertionError(
                    f"features_gab: K10-P at F {F} {dt} differs from K10 "
                    f"({torch.equal(got, k10w)}) or its twin ({err})")
            widths[f"F{F}_{str(dt).split('.')[-1]}"] = err
    # the embeddings example on the card against the CPU (same seed: the
    # features are drawn on the host)
    with knobs(RTPU_PCPM=None):
        emb = {d: TemporalEmbeddings(log, dim=64, device=d)
               for d in (dev, "cpu")}
        vid = int(emb["cpu"].ds.uv[7])
        near = {d: e.nearest(vid, int(0.95 * GAB_SPAN), window=604_800,
                             k=5) for d, e in emb.items()}
        drift = {d: e.drift(int(0.96 * GAB_SPAN), GAB_SPAN, 604_800)
                 for d, e in emb.items()}
    nsims = [[s for _, s in near[d]] for d in (dev, "cpu")]
    drift_err = float(np.abs(drift[dev] - drift["cpu"]).max())
    if len(nsims[0]) != len(nsims[1]) or drift_err > 1e-5 or max(
            abs(a - b) for a, b in zip(*nsims)) > 1e-5:
        raise AssertionError("features_gab: embeddings differ from the CPU")
    emit("features_gab", n=ds.n, m=ds.m, n_pad=ds.n_pad, m_pad=ds.m_pad,
         F=128, specs=specs, call_s=runs, vs_cpu=errs,
         binned_equals_unbinned=True, one_round_bf16=round_check,
         wide_vs_twin=widths,
         layout=spec_of(lay), nearest=[(v, s) for v, s in near[dev]],
         nearest_cpu=[(v, s) for v, s in near["cpu"]],
         drift_max_abs_err_vs_cpu=drift_err, launches=total)
    return total


def mode_kernel_check(torch, np, segment, dev):
    """K7-mode against its twin on a synthetic case: one segment of 100,003 rows with ties,
    rows of 1, 32, 33, 4,096 and 4,097, runs at the short rows' lane
    widths (1-9, 15-17, 31-33, 64, 65; a warp's 16 rows of 32, of 31 and
    1, of 8), masked and negative values, empty segments, k = 1, 2 and 3,
    both CSR forms, with and without a mask (pad rows negative)."""
    rng = np.random.default_rng(0)
    lens = [100_003, 1, 32, 33, 4_096, 4_097, 0, 0, 5, 200]
    lens += [2, 3, 4, 6, 7, 8, 9, 15, 16, 17, 31, 32, 33, 64, 65]
    lens += [32] * 16 + [31, 1] * 8 + [8] * 16 + [16] * 16
    lens += [int(x) for x in rng.integers(0, 40, 3_000)]
    n, m_real = len(lens), int(sum(lens))
    m = m_real + 17                              # pad rows, masked
    ids = np.concatenate([np.repeat(np.arange(n), lens),
                          np.full(m - m_real, n - 1)]).astype(np.int32)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    cases = 0
    for k in (1, 2, 3):
        vals = rng.integers(0, 50, k * m).astype(np.int32)
        vals[:100_003] = rng.integers(0, 4, 100_003)   # big tied runs
        vals[rng.random(k * m) < 0.05] = -7
        vals.reshape(k, m)[:, m_real:] = -1             # pads: no message
        mask = rng.random(k * m) < 0.9
        mask.reshape(k, m)[:, m_real:] = False
        for permuted in (False, True):
            if permuted:
                p = rng.permutation(m_real).astype(np.int32)
                pid = np.full(m, n - 1, np.int32)
                pid[p] = ids[:m_real]
                seg = (pid, indptr, p)
            else:
                seg = (ids, indptr, None)
            dseg = segment.SegmentCSR(*(None if a is None else
                                        torch.from_numpy(a).to(dev)
                                        for a in seg))
            v = torch.from_numpy(vals).to(dev)
            for mk in (torch.from_numpy(mask).to(dev), None):
                got = segment.segment_mode(v, dseg, k * n, mk, -1, k)
                want = segment.segment_mode_plain(v, dseg, k * n, mk, -1, k)
                what = f"k={k}, permuted={permuted}, mask={mk is not None}"
                if not torch.equal(got, want):
                    raise AssertionError(f"K7-mode differs from its twin "
                                         f"({what})")
                cases += 1
    return dict(cases=cases, longest_row=max(lens), rows=n)


def mode_at(torch, np, segment, bsp, view, windows, dev, seed: int,
            key: str) -> dict:
    """K7-mode alone at a cold View's shape: its destination CSR, labels
    in [0, n_pad), the view's window masks; bitwise its twin, timed with
    its device time and bound. Returns the entry (with ``got`` / ``want``)."""
    e = bsp.view_edges(view, dev)
    seg = segment.SegmentCSR(e.e_dst, e.in_indptr, None)
    k, m, n = len(windows), view.m_pad, view.n_pad
    rng = np.random.default_rng(seed)
    emasks = np.stack([view.e_mask & (view.e_latest_time >= view.time - w)
                       for w in windows]).reshape(-1)
    vals = torch.from_numpy(rng.integers(0, n, k * m).astype(np.int32)) \
        .to(dev)
    mk = torch.from_numpy(emasks).to(dev)
    args = (vals, seg, k * n, mk, -1, k)
    got = segment.segment_mode(*args)
    want = segment.segment_mode_plain(*args)
    if not torch.equal(got, want):
        raise AssertionError(f"K7-mode differs from its twin at the {key} "
                             "shape")
    m_real = int(view.m_active)
    lens = torch.diff(e.in_indptr)
    shape = (f"dst n_pad={n} m_pad={m} k={k} int32 labels, "
             f"{int((lens > 32).sum())} runs past 32 (longest "
             f"{int(lens.max())})")
    entry = dict(
        got=got, want=want, shape=shape,
        ms=cuda_ms(torch, lambda: segment.segment_mode(*args)),
        plain_ms=cuda_ms(torch, lambda: segment.segment_mode_plain(*args),
                         iters=5),
        # the real rows' values and masks a window, the CSR, the output
        **dict(zip(("bound_ms", "bound_by"), bound(
            k * m_real * 5 + (n + 1) * 8 + k * n * 4, k * m_real))))
    entry["device_ms"], entry["device_by"] = device_ms(
        torch, lambda: segment.segment_mode(*args))
    return entry



def phase_lpa(torch, np, columns, segment, log, ldbc, dev):
    """LabelPropagation on the card, each run BITWISE equal to the CPU's
    with equal steps: a cold View job on the GAB log at 0.90 t_span over
    (month, week, day), a hop-by-hop Range job over the LDBC log (10 hops
    x 2 windows) and ``DeviceSweep.run`` on the GAB log; K7-mode against
    its twin on the synthetic inboxes and timed at the GAB View's shape
    (the ``kernels`` entry) and at the LDBC Range's (``mode_at``)."""
    from raphtory_tpu_torch.algorithms import LabelPropagation
    from raphtory_tpu_torch.core.snapshot import build_view
    from raphtory_tpu_torch.engine import bsp
    from raphtory_tpu_torch.engine.device_sweep import DeviceSweep
    from raphtory_tpu_torch.jobs.manager import RangeQuery, ViewQuery

    prog = LabelPropagation(max_steps=30)
    T = int(0.90 * GAB_SPAN)
    view_job = [(prog, ViewQuery(T, windows=tuple(WINDOWS)))]
    columns.reset_launches()
    rows, secs, _, g = run_view_jobs(log, dev, view_job)
    torch.cuda.synchronize()
    launches = dict(columns.LAUNCHES)
    check_launched("lpa view", launches, ("segment_mode",) + COLD_KERNELS)
    if g._resident is not None:
        raise AssertionError("lpa: the View rode the resident sweep")
    compare_rows("lpa view", rows, run_view_jobs(log, "cpu", view_job)[0])
    jump = (LDBC_SPAN // 2) // 9
    q = RangeQuery(start=LDBC_SPAN // 2, end=LDBC_SPAN // 2 + 9 * jump,
                   jump=jump, windows=(1_300_000, 604_800))
    hops = list(range(q.start, q.end + 1, q.jump))
    range_job = [(prog, q)]
    columns.reset_launches()
    t0 = time.perf_counter()
    rrows, _, _, _ = run_view_jobs(ldbc, dev, range_job)
    range_s = time.perf_counter() - t0
    range_launches = dict(columns.LAUNCHES)
    check_launched("lpa range", range_launches,
                   ("segment_mode",) + COLD_KERNELS)
    if len(rrows) != len(range(q.start, q.end + 1, q.jump)) * 2:
        raise AssertionError(f"lpa range: {len(rrows)} rows")
    compare_rows("lpa range", rrows, run_view_jobs(ldbc, "cpu",
                                                   range_job)[0])
    # the resident route, directly
    card, cpu = DeviceSweep(log, device=dev), DeviceSweep(log, device="cpu")
    columns.reset_launches()
    got, s = card.run(prog, T, windows=WINDOWS)
    torch.cuda.synchronize()
    sweep_launches = dict(columns.LAUNCHES)
    check_launched("lpa DeviceSweep", sweep_launches,
                   ("segment_mode", "window_masks", "segment_combine"))
    ref, xs = cpu.run(prog, T, windows=WINDOWS)
    if s != xs or not torch.equal(got.cpu(), ref):
        raise AssertionError(f"lpa DeviceSweep differs from the CPU (steps "
                             f"{s} vs {xs})")
    synthetic = mode_kernel_check(torch, np, segment, dev)
    # K7-mode alone at the cold GAB View's shape (3 windows) and at the
    # LDBC Range's (its last hop's View, 2 windows)
    view = build_view(log, T)
    gab = mode_at(torch, np, segment, bsp, view, WINDOWS, dev, 9, "GAB View")
    ldbc_view = build_view(ldbc, hops[-1])
    at_ldbc = mode_at(torch, np, segment, bsp, ldbc_view, list(q.windows),
                      dev, 10, "LDBC Range")
    got, want = gab.pop("got"), gab.pop("want")
    del at_ldbc["got"], at_ldbc["want"]
    emit("lpa", view=dict(time=T, windows=WINDOWS, view_s=secs[0],
                          viewTime_ms=[r["viewTime"] for r in rows],
                          steps=rows[0]["steps"],
                          communities=[r["result"]["communities"]
                                       for r in rows], launches=launches),
         range=dict(hops=len(hops), windows=2, rows=len(rrows),
                    wall_s=range_s,
                    viewTime_ms=[r["viewTime"] for r in rrows],
                    steps=[r["steps"] for r in rrows],
                    launches=range_launches),
         device_sweep=dict(steps=s, launches=sweep_launches),
         synthetic=synthetic, ldbc_range_shape=at_ldbc, bitwise_vs_cpu=True)
    entry = dict(
        source="raphtory_tpu_torch/csrc/segment.cu",
        replaces="raphtory_tpu/ops/segment.py:155",
        max_abs_err=exact_err(got, want), library_ms=None, **gab,
        ldbc_range_shape=at_ldbc)
    return launches, entry


K12_KERNELS = ("column_masks", "column_out_degree", "column_pull_sum",
               "pagerank_update", "cc_superstep")
#: the taint deployment: the reference's Ethereum taint tracking
#: (EthereumTaintTracking.scala:93-127, exchange stop-list) over one week
#: of payment events, at the volume of a week of Ethereum mainnet
TAINT_LOG = dict(n_addresses=1 << 21, n_txs=1 << 23, seed=11,
                 t_span=604_800)
TAINT_T, TAINT_WINDOWS = 604_800, (604_800, 86_400, 3_600)
TAINT_RANGE = dict(start=345_600, end=604_800, jump=86_400,
                   windows=(86_400, 3_600))
TAINT_START = 86_400
#: the taint path's kernels besides its exchange: the per-window degrees
#: (int32 K7) and the mask unpack (K8u)
TAINT_KERNELS = ("segment_combine", "unpack_mask_bits")
IMAX = (1 << 63) - 1


def nonzero(launches: dict) -> dict:
    """The kernels a run launched, with their counts."""
    return {k: v for k, v in launches.items() if v}


def taint_program(np, log, start_time: int, max_steps: int = 50):
    """TaintTracking on ``log``: the 8 addresses with the most sends as
    the exchange stop-list; 16 other addresses that send at least once,
    drawn with ``default_rng(11)``, as the seeds."""
    from raphtory_tpu_torch.algorithms import TaintTracking

    ids, sends = np.unique(log.column("src"), return_counts=True)
    stop = ids[np.argsort(-sends, kind="stable")[:8]]
    seeds = np.random.default_rng(11).choice(np.setdiff1d(ids, stop), 16,
                                             replace=False)
    return TaintTracking(seeds=tuple(sorted(int(s) for s in seeds)),
                         start_time=int(start_time),
                         stop_list=tuple(sorted(int(s) for s in stop)),
                         max_steps=max_steps)


def taint_edge_cases(torch, np, segment, partition, dev) -> int:
    """K7 and K7-P on int64 against their twins, bitwise: empty segments,
    a fully masked window, INT64_MIN / INT64_MAX and wrapping sums, k = 1
    and 3, an unaligned edge count, a feature axis; K7 in both directions,
    K7-P through a layout's perm / valid. Returns the cases held."""
    rng = np.random.default_rng(3)
    n, n_real, m_real, m_pad = 1_000, 977, 4_099, 4_104
    src = rng.integers(0, n_real, m_real)
    dst = rng.integers(0, n_real - 40, m_real)      # rows that get nothing
    order = np.lexsort((src, dst))
    e_src = np.full(m_pad, n - 1, np.int32)
    e_dst = np.full(m_pad, n - 1, np.int32)
    e_src[:m_real], e_dst[:m_real] = src[order], dst[order]

    def indptr(ids):
        out = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(ids, minlength=n), out=out[1:])
        return out

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    csrs = {"dst": segment.SegmentCSR(put(e_dst), put(indptr(e_dst[:m_real])),
                                      None),
            "src": segment.SegmentCSR(
                put(e_src), put(indptr(e_src[:m_real])),
                put(np.argsort(e_src[:m_real], kind="stable").astype(
                    np.int32)))}
    lay = partition.build_layout(e_src, e_dst, n, m_real, 3)
    be = lay.device_edges(dev)
    walk = segment.PartitionWalk(be.in_indptr, be.in_order, be.perm,
                                 be.valid)
    extremes = np.array([-(1 << 63), -(1 << 63) + 1, -1, 0, 1, IMAX - 1,
                         IMAX])
    cases = 0
    for k in (1, 3):
        for F in (0, 2):
            shape = (k * m_pad,) + ((F,) if F else ())
            x = rng.integers(-(1 << 62), 1 << 62, shape)
            pick = rng.random(shape) < 0.3
            x[pick] = rng.choice(extremes, int(pick.sum()))
            mask = rng.random(k * m_pad) < 0.7
            mask.reshape(k, m_pad)[:, m_real:] = False
            if k > 1:
                mask.reshape(k, m_pad)[1] = False     # a window with nothing
            xd, md = put(x), put(mask)
            for op in ("sum", "min", "max"):
                for name, csr in csrs.items():
                    got = segment.segment_combine(xd, csr, op, md, k)
                    want = segment.segment_combine_plain(xd, csr, op, md, k)
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"K7 int64 differs from its twin ({op}, {name}, "
                            f"k={k}, F={F})")
                    cases += 1
                got = segment.partition_reduce(xd, walk, op, md, k)
                want = segment.partition_reduce_plain(xd, walk, op, md, k)
                flat = segment.segment_combine_plain(xd, csrs["dst"], op, md,
                                                     k)
                if not (torch.equal(got, want) and torch.equal(got, flat)):
                    raise AssertionError(f"K7-P int64 differs from its twin "
                                         f"({op}, k={k}, F={F})")
                cases += 1
    return cases


def taint_kernels(torch, np, segment, bsp, view, lay, k, dev) -> dict:
    """K7 and K7-P on int64 at the taint View's shape: the exchange of a
    superstep (k windows' min over the occurrence rows, the windows'
    masks, messages that are taint times where the sender is tainted and
    IMAX elsewhere), each bitwise against its twin and timed beside the
    twin and the one PyTorch call of the same function,
    ``scatter_reduce_(..., "amin", include_self=True)`` over the flat
    payload. Bounds from this view's real rows and this layout's bytes."""
    e = bsp.view_edges(view, dev, occurrences=True)
    be = lay.device_edges(dev)
    csr = segment.SegmentCSR(e.e_dst, e.in_indptr, None)
    walk = segment.PartitionWalk(be.in_indptr, be.in_order, be.perm,
                                 be.valid)
    n, m = view.n_pad, len(view.occ_src)
    o = bsp._occ_count(view)
    rng = np.random.default_rng(5)
    lo = np.array([TAINT_T - w for w in TAINT_WINDOWS[:k]])[:, None]
    mask = view.occ_mask[None, :] & (view.occ_time[None, :] >= lo)
    occ_t = np.broadcast_to(view.occ_time, (k, m))
    msg = np.where(rng.random((k, m)) < 0.1, occ_t, IMAX).reshape(-1)
    x = torch.from_numpy(np.ascontiguousarray(msg)).to(dev)
    mk = torch.from_numpy(np.ascontiguousarray(mask.reshape(-1))).to(dev)
    flat_dst = (e.e_dst.long()[None, :]
                + torch.arange(k, device=dev)[:, None] * n).reshape(-1)
    imax = torch.tensor(IMAX, dtype=torch.int64, device=dev)

    def library():
        return torch.full((k * n,), IMAX, dtype=torch.int64,
                          device=dev).scatter_reduce_(
            0, flat_dst, torch.where(mk, x, imax), "amin", include_self=True)

    ref = library()
    live = int(mk.sum())
    # the kernels read a row's payload only where its window's mask is
    # set: count the 32-byte sectors of the flat [k*m] payload that hold a
    # live row (4 int64 rows a sector)
    pad = torch.zeros((-mk.numel()) % 4, dtype=torch.bool, device=dev)
    payload = 32 * int(torch.cat([mk, pad]).view(-1, 4).any(1).sum())
    out = {}
    for name, run, plain, nbytes in (
            ("segment_combine_i64",
             lambda: segment.segment_combine(x, csr, "min", mk, k),
             lambda: segment.segment_combine_plain(x, csr, "min", mk, k),
             # the live payload's sectors, the real rows' mask in every
             # window, the CSR, the output
             payload + k * o + (n + 1) * 8 + k * n * 8),
            ("partition_segment_reduce_i64",
             lambda: segment.partition_reduce(x, walk, "min", mk, k),
             lambda: segment.partition_reduce_plain(x, walk, "min", mk, k),
             # the live payload's sectors, the real slots' mask in every
             # window, the walk (indptr, order), perm and valid over every
             # binned slot, the output
             payload + k * o + (n + 1) * 8 + walk.order.numel() * 4
             + walk.perm.numel() * 5 + k * n * 8)):
        got, want = run(), plain()
        if not (torch.equal(got, want) and torch.equal(got, ref)):
            raise AssertionError(f"{name} differs from its twin at the "
                                 "taint shape")
        out[name] = dict(
            source="raphtory_tpu_torch/csrc/segment.cu",
            replaces=("raphtory_tpu/ops/segment.py:35" if "combine" in name
                      else "raphtory_tpu/ops/segment.py:116"),
            max_abs_err=exact_err(got, want),
            ms=cuda_ms(torch, run), device_ms=device_ms(torch, run)[0],
            plain_ms=cuda_ms(torch, plain, iters=5),
            library_ms=cuda_ms(torch, library),
            shape=f"min int64 k={k} n_pad={n} o_pad={m} o={o} live={live}"
                  f" live_payload_bytes={payload}",
            **dict(zip(("bound_ms", "bound_by"), bound(nbytes, live))))
    return out


def phase_taint(torch, np, columns, segment, dev):
    """TaintTracking over the edge-event multigraph at the week-of-Ethereum
    scale: a View job (k = 3) and a hop-by-hop Range job (4 hops x 2
    windows) through ``AnalysisManager``, binned (``RTPU_PCPM`` unset: K7-P
    on int64) and unbinned (``=0``: K7 on int64), bitwise equal with equal
    supersteps; the View bitwise equal to the CPU job, the Range's first
    hop to the CPU run. K7 / K7-P int64 against their twins at this shape
    and on edge cases. Returns ``(launches, kernel entries)``."""
    from raphtory_tpu_torch.core import sweep as _sweep
    from raphtory_tpu_torch.core.service import TemporalGraph
    from raphtory_tpu_torch.core.snapshot import build_view
    from raphtory_tpu_torch.engine import bsp
    from raphtory_tpu_torch.jobs.manager import (AnalysisManager,
                                                 RangeQuery, ViewQuery)
    from raphtory_tpu_torch.ops import partition
    from raphtory_tpu_torch.utils.synth import bitcoin_like_log
    from raphtory_tpu_torch.utils.transfer import shared_engine

    xfer = shared_engine().stats

    def knob(value):
        if value is None:
            os.environ.pop("RTPU_PCPM", None)
        else:
            os.environ["RTPU_PCPM"] = value

    def job_rows(mgr, q):
        job = mgr.submit(prog, q)
        if not job.wait(900) or job.status != "done":
            raise AssertionError(f"taint job {job.status}: {job.error}")
        return mgr.results(job.id)

    def same_rows(what, got, want):
        keys = ("time", "windowsize", "steps", "result")
        if len(got) != len(want) or any(g[kk] != w[kk] for g, w in
                                        zip(got, want) for kk in keys):
            raise AssertionError(f"taint {what}: rows differ")

    t0 = time.perf_counter()
    log = bitcoin_like_log(**TAINT_LOG)
    gen_s = time.perf_counter() - t0
    prog = taint_program(np, log, TAINT_START)
    try:
        # ---- the View: fold, layout and dispatch on their own clocks
        t0 = time.perf_counter()
        view = build_view(log, TAINT_T, include_occurrences=True)
        fold_s = time.perf_counter() - t0
        knob(None)
        t0 = time.perf_counter()
        lay = bsp._view_layout(view, True)      # cached for the view
        layout_s = time.perf_counter() - t0
        if lay is None:
            raise AssertionError("taint: RTPU_PCPM auto did not bin the "
                                 "occurrence rows")
        g, cpu_g = TemporalGraph(log, device=dev), TemporalGraph(
            log, device="cpu")
        for graph in (g, cpu_g):               # the jobs reuse the fold
            graph.cache_put(TAINT_T, view, True)
        mgr, cpu_mgr = AnalysisManager(g, device=dev), AnalysisManager(
            cpu_g, device="cpu")
        q = ViewQuery(TAINT_T, windows=TAINT_WINDOWS)
        view_runs, results = {}, {}
        for route, value in (("binned", None), ("unbinned", "0")):
            knob(value)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            columns.reset_launches()
            prior = xfer.as_dict()
            t0 = time.perf_counter()
            res, steps = bsp.run(prog, view, windows=list(TAINT_WINDOWS),
                                 device=dev)
            torch.cuda.synchronize()
            dispatch_s = time.perf_counter() - t0
            # the binned layout's device tables through the transfer
            # engine (bytes, slices, stage / wire seconds)
            transfer = xfer.delta_since(prior)
            launches = dict(columns.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            columns.reset_launches()
            t0 = time.perf_counter()
            rows = job_rows(mgr, q)
            job_s = time.perf_counter() - t0
            job_launches = dict(columns.LAUNCHES)
            results[route] = (res.cpu(), steps, rows)
            view_runs[route] = dict(
                dispatch_s=dispatch_s, transfer=transfer, job_s=job_s,
                supersteps=steps,
                tainted=[int(v) for v in (res < IMAX).sum(dim=1).cpu()],
                launches=nonzero(launches),
                job_launches=nonzero(job_launches), peak_device_bytes=peak)
        exchange = {"binned": "partition_segment_reduce_i64",
                    "unbinned": "segment_combine_i64"}
        for route, r in view_runs.items():
            for what in ("launches", "job_launches"):
                ks = (exchange[route],) + TAINT_KERNELS
                check_launched(f"taint View {route} ({what})",
                               {kk: r[what].get(kk, 0) for kk in ks}, ks)
        if view_runs["binned"]["launches"].get("segment_combine_i64"):
            raise AssertionError("taint: the binned View ran K7 on int64")
        if view_runs["binned"]["transfer"]["bytes_shipped"] <= 0:
            raise AssertionError("taint: the binned View's device tables "
                                 "did not go through the transfer engine")
        (b, bs, brows), (u, us, urows) = results["binned"], \
            results["unbinned"]
        if not torch.equal(b, u) or bs != us:
            raise AssertionError(f"taint View: binned != unbinned on the "
                                 f"card (steps {bs} vs {us})")
        same_rows("View binned vs unbinned jobs", brows, urows)
        # the View's dispatch split by stage (``bsp.run_async``), once
        # more on each route, its layout cached for the view
        for route, value in (("binned", None), ("unbinned", "0")):
            knob(value)
            prior = xfer.as_dict()
            again, _, view_runs[route]["split_s"] = split_run(
                bsp, prog, view, dev, windows=list(TAINT_WINDOWS))
            view_runs[route]["split_transfer"] = xfer.delta_since(prior)
            if not torch.equal(again.cpu(), results[route][0]):
                raise AssertionError(f"taint View {route}: the split run "
                                     "differs")
        knob("0")
        t0 = time.perf_counter()
        cpu_rows = job_rows(cpu_mgr, q)
        cpu_view_s = time.perf_counter() - t0
        same_rows("View card vs CPU jobs", brows, cpu_rows)
        if [r["steps"] for r in brows] != [bs] * len(TAINT_WINDOWS) or [
                r["result"]["tainted"] for r in brows] \
                != view_runs["binned"]["tainted"]:
            raise AssertionError("taint View: the job's rows do not match "
                                 "its dispatch")
        kernels = taint_kernels(torch, np, segment, bsp, view, lay,
                                len(TAINT_WINDOWS), dev)
        upload = binned_upload(torch, np, lay, dev, reverse=False)
        edge_cases = taint_edge_cases(torch, np, segment, partition, dev)
        occ_shape = dict(n=view.n_active, n_pad=view.n_pad,
                         o=bsp._occ_count(view), o_pad=len(view.occ_src),
                         k=len(TAINT_WINDOWS), spec=spec_of(lay))
        del view, lay, g, mgr, res, b, u

        # ---- the Range, hop by hop over SweepBuilder(include_occurrences)
        knob(None)
        g = TemporalGraph(log, device=dev)
        mgr = AnalysisManager(g, device=dev)
        rq = RangeQuery(**TAINT_RANGE)
        hops = list(range(rq.start, rq.end + 1, rq.jump))
        fold_clock = []
        real_view_at = _sweep.SweepBuilder.view_at

        def view_at(self, t):
            t0 = time.perf_counter()
            out = real_view_at(self, t)
            fold_clock.append(time.perf_counter() - t0)
            return out

        columns.reset_launches()
        _sweep.SweepBuilder.view_at = view_at
        try:
            t0 = time.perf_counter()
            rows = job_rows(mgr, rq)
            range_s = time.perf_counter() - t0
        finally:
            _sweep.SweepBuilder.view_at = real_view_at
        range_launches = dict(columns.LAUNCHES)
        check_launched("taint Range", range_launches,
                       ("partition_segment_reduce_i64",) + TAINT_KERNELS)
        range_launches = nonzero(range_launches)
        if len(fold_clock) != len(hops) or len(rows) != len(hops) * len(
                rq.windows):
            raise AssertionError("taint Range: not hop by hop over the "
                                 "sweep builder")
        knob("0")
        hop_steps, hop_tainted = [], []
        for j, T in enumerate(hops):
            hv = g.view_at(T, include_occurrences=True)  # the job's fold
            res, steps = bsp.run(prog, hv, windows=list(rq.windows),
                                 device=dev)
            res = res.cpu()
            want = reduced_rows(prog, res.numpy(), T, rq.windows, steps, hv)
            same_rows(f"Range hop {T} binned vs unbinned",
                      [{kk: r[kk] for kk in want[0]} for r in
                       rows[j * len(rq.windows):(j + 1) * len(rq.windows)]],
                      want)
            if j == 0:
                cpu, cpu_steps = bsp.run(prog, hv, windows=list(rq.windows),
                                         device="cpu")
                if not torch.equal(res, cpu) or steps != cpu_steps:
                    raise AssertionError(f"taint Range hop {T}: card != CPU "
                                         f"(steps {steps} vs {cpu_steps})")
            hop_steps.append(steps)
            hop_tainted.append([int(v) for v in (res < IMAX).sum(dim=1)])
    finally:
        os.environ["RTPU_PCPM"] = "0"
    launches = {"segment_combine_i64":
                view_runs["unbinned"]["launches"]["segment_combine_i64"],
                "partition_segment_reduce_i64":
                view_runs["binned"]["launches"][
                    "partition_segment_reduce_i64"]}
    fold_share = sum(fold_clock) / range_s
    emit("taint", log=TAINT_LOG, events=int(TAINT_LOG["n_txs"]),
         gen_s=gen_s, **occ_shape,
         seeds=len(prog.seeds), stop_list=len(prog.stop_list),
         start_time=prog.start_time, max_steps=prog.max_steps,
         view=dict(T=TAINT_T, windows=TAINT_WINDOWS, fold_s=fold_s,
                   layout_s=layout_s, cpu_job_s=cpu_view_s,
                   binned_upload=upload, **view_runs),
         range=dict(hops=hops, windows=rq.windows, views=len(rows),
                    seconds=range_s, views_per_s=len(rows) / range_s,
                    fold_s=fold_clock, fold_share=fold_share,
                    supersteps=hop_steps, tainted=hop_tainted,
                    launches=range_launches),
         kernels={kk: {x: v[x] for x in ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by",
                                         "max_abs_err", "shape")}
                  for kk, v in kernels.items()},
         edge_cases_bitwise=edge_cases)
    return launches, kernels


# ---------------------------------------------------- slice 20: the live path

LIVE_BATCHES = 12
LIVE_NEW_VERTEX = 3      # the batch that brings a new vertex id (a rebase)
LIVE_DELETES = 7         # the batch with deletes (CC's warm gate closes)
LDBC_WINDOWS = [1_300_000, 604_800]


def live_stream(np, log, seed: int, weighted: bool):
    """The live phase's stream over a time-sorted ``log``: the events up to
    half its last time start the graph (``first()``, a new log each call);
    ``LIVE_BATCHES`` batches, batch i at times in ``(t0 + i*step, t0 +
    (i+1)*step]``, each as many events as the second half held a batch,
    re-drawn from the first half's edge adds (a pair the pin has not seen
    rebuilds the preseeded engines, as in the reference): batch
    ``LIVE_NEW_VERTEX`` adds one edge to a new vertex id, batch
    ``LIVE_DELETES`` deletes 10 % of its pairs. Returns ``(first, t0,
    step, batches)``, a batch the ``append_batch`` arguments."""
    from raphtory_tpu_torch.core.events import EDGE_ADD, EDGE_DELETE, EventLog
    from raphtory_tpu_torch.interop import numeric_prop_payloads

    t, k = log.column("time"), log.column("kind")
    s, d = log.column("src"), log.column("dst")
    h = int(np.searchsorted(t, int(t[-1]) // 2, side="right"))
    cols = tuple(c[:h].copy() for c in (t, k, s, d))
    props = ([(r, p) for r, p in numeric_prop_payloads(log.props) if r < h]
             if weighted else None)

    def first():
        out = EventLog()
        out.append_batch(*cols, props=props)
        return out

    t0 = int(t[h - 1])
    step = (int(t[-1]) - t0) // LIVE_BATCHES
    per = (len(t) - h) // LIVE_BATCHES
    adds = np.flatnonzero(k[:h] == EDGE_ADD)
    rng = np.random.default_rng(seed)
    new_id = int(max(s.max(), d.max())) + 1
    batches = []
    for i in range(LIVE_BATCHES):
        rows = adds[rng.integers(0, len(adds), per)]
        bt = np.sort(rng.integers(t0 + i * step + 1, t0 + (i + 1) * step + 1,
                                  per)).astype(np.int64)
        bk = np.full(per, EDGE_ADD, np.uint8)
        bs, bd = s[rows].copy(), d[rows].copy()
        if i == LIVE_DELETES:
            bk[rng.random(per) < 0.1] = EDGE_DELETE
        if i == LIVE_NEW_VERTEX:
            bt, bk = np.append(bt, bt[-1]), np.append(bk, EDGE_ADD)
            bs, bd = np.append(bs, bs[0]), np.append(bd, new_id)
        bp = None
        if weighted:
            w = np.round(rng.uniform(0.5, 5.0, len(bt)), 2)
            bp = [(int(j), {"weight": float(w[j])})
                  for j in np.flatnonzero(bk == EDGE_ADD)]
        batches.append((bt, bk, bs, bd, bp))
    return first, t0, step, batches


def serve_live(columns, stream, prog, windows, dev, live: bool):
    """A ``LiveQuery`` job in event-time mode on the card over ``stream``:
    the batches appended on this thread, each once the previous epoch's
    rows are out, the watermark advanced past it. ``RTPU_LIVE`` is 1 or 0
    (the full re-sweep every epoch); ``windows`` None is the unwindowed
    subscription. Returns ``(rows, the job's LiveEpochState, launches,
    wall seconds, the grown log)``."""
    from raphtory_tpu_torch.core.service import TemporalGraph
    from raphtory_tpu_torch.ingestion.watermark import WatermarkRegistry
    from raphtory_tpu_torch.jobs.manager import AnalysisManager, LiveQuery

    first, t0, step, batches = stream
    os.environ["RTPU_LIVE"] = "1" if live else "0"
    try:
        log, wm = first(), WatermarkRegistry()
        wm.register("feed")
        wm.advance("feed", t0)
        mgr = AnalysisManager(TemporalGraph(log, watermarks=wm, device=dev),
                              device=dev)
        cold_fold()
        columns.reset_launches()
        w0 = time.perf_counter()
        job = mgr.submit(prog, LiveQuery(repeat=step, event_time=True,
                                         max_runs=len(batches) + 1,
                                         windows=None if windows is None
                                         else tuple(windows)),
                         wait_timeout=600)
        for i, (bt, bk, bs, bd, bp) in enumerate(batches):
            while len(mgr.results(job.id)) < (i + 1) * len(windows or [0]):
                if job.wait(0.0005):
                    break
            log.append_batch(bt, bk, bs, bd, props=bp)
            wm.advance("feed", t0 + (i + 1) * step)
        wm.finish("feed")
        if not job.wait(900) or job.status != "done":
            raise AssertionError(f"live {type(prog).__name__}: "
                                 f"{job.status}: {job.error}")
        wall = time.perf_counter() - w0
        launches = dict(columns.LAUNCHES)
    finally:
        os.environ.pop("RTPU_LIVE", None)
    rows = [{k: v for k, v in r.items() if k != "viewTime"}
            for r in mgr.results(job.id)]
    return rows, job.live, launches, wall, log


def same_live_rows(what, got, want, pagerank: bool) -> None:
    """A live epoch's rows against the scratch Range's at the same times:
    time and window equal (steps differ where an epoch is warm-seeded);
    PageRank's rank sums within 1e-5 and its top-10 ranks within rtol
    1e-5 / atol 1e-7, an id out of place only where its rank ties its
    neighbour's within that tolerance; every other result equal."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} rows vs {len(want)}")
    for g, w in zip(got, want):
        if (g["time"], g["windowsize"]) != (w["time"], w["windowsize"]):
            raise AssertionError(f"{what}: row {g} vs {w}")
        r, x = g["result"], w["result"]
        if not pagerank:
            if r != x:
                raise AssertionError(f"{what} at {g['time']}: {r} vs {x}")
            continue
        ok = abs(r["sum"] - x["sum"]) <= 1e-5 and len(r["top10"]) == len(
            x["top10"])
        wrank = dict(x["top10"])
        for (gi, gv), (wi, wv) in zip(r["top10"], x["top10"]):
            tol = 1e-7 + 1e-5 * abs(wv)
            ok &= abs(gv - wv) <= tol and (
                gi == wi or (gi in wrank and abs(wrank[gi] - wv) <= tol))
        if not ok:
            raise AssertionError(f"{what} at {g['time']}: {r} vs {x}")


def phase_transfer(torch, np, dev, reps: int = 5):
    """The chunked transfer engine on the card: a 96 MiB int32 array and a
    ``put_many`` of mixed tables (int64, bool, f32, a 0-d), each bitwise
    one plain ``.to``; the put timed in turns with one pageable ``.to``
    (``reps`` rounds, the first in each round alternating), after a first
    put that allocates the engine's pinned staging buffers (timed on its
    own)."""
    from raphtory_tpu_torch.utils import transfer

    rng = np.random.default_rng(23)
    big = rng.integers(0, 1 << 30, 24 << 20).astype(np.int32)
    mixed = [rng.integers(0, 1 << 40, 5_000_000),
             rng.random(3_000_001) < 0.5,
             rng.random((1_000_003, 3)).astype(np.float32), np.int64(7)]
    eng = transfer.TransferEngine()

    def timed_call(fn):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, time.perf_counter() - s0

    want, _ = timed_call(lambda: torch.from_numpy(big).to(dev))
    _, first_s = timed_call(lambda: eng.put(big, dev))
    prior = eng.stats.as_dict()
    secs = {"plain": [], "engine": []}
    calls = (("plain", lambda: torch.from_numpy(big).to(dev)),
             ("engine", lambda: eng.put(big, dev)))
    for r in range(reps):
        for name, fn in calls if r % 2 == 0 else calls[::-1]:
            got, sec = timed_call(fn)
            secs[name].append(sec)
            if not torch.equal(got, want):
                raise AssertionError(f"transfer: the {name} copy differs")
    stats = eng.stats.delta_since(prior)
    many = eng.put_many(mixed, dev)
    torch.cuda.synchronize()
    if not all(g.dtype == torch.as_tensor(a).dtype
               and torch.equal(g, torch.as_tensor(a).to(dev))
               for g, a in zip(many, mixed)):
        raise AssertionError("transfer: put_many differs from plain copies")
    emit("transfer", bytes=int(big.nbytes), reps=reps,
         depth=transfer.DEPTH, chunk_bytes=transfer.CHUNK_BYTES,
         intra_op_threads=torch.get_num_threads(), first_put_s=first_s,
         plain_s=secs["plain"], engine_s=secs["engine"],
         engine_gb_per_s=big.nbytes / min(secs["engine"]) / 1e9,
         plain_gb_per_s=big.nbytes / min(secs["plain"]) / 1e9,
         stats_of_the_puts=stats)


def phase_live(torch, np, columns, log, ldbc, dev):
    """Standing ``LiveQuery`` subscriptions on the card: PageRank and CC
    on the headline's GAB log (month / week / day), BFS and weighted SSSP
    on the LDBC log, each over a stream of 12 batches after half the span
    (``live_stream``), each epoch held against a scratch Range over the
    grown log at the same times, and the same stream under ``RTPU_LIVE=0``
    (every epoch the full re-sweep, the View routes). Then CC unwindowed
    on the GAB stream, where the min-merge gate opens: every incremental
    epoch of an add-only batch must be warm-seeded, the rest cold, its
    rows bitwise the scratch Range's. Prints each epoch's mode, seconds,
    delta rows, ship bytes and warm seed beside the re-sweep arm's
    seconds; returns each program's launches."""
    from raphtory_tpu_torch.algorithms import (SSSP, ConnectedComponents,
                                               PageRank)
    from raphtory_tpu_torch.core.service import TemporalGraph
    from raphtory_tpu_torch.jobs.manager import AnalysisManager, RangeQuery

    gab = live_stream(np, log, 20, weighted=False)
    ldbc_s = live_stream(np, ldbc, 21, weighted=True)
    cases = {
        # converged (a warm epoch and a cold scratch Range then agree to
        # float noise, where 20 supersteps would stop each short of the
        # fixed point at a different place)
        "pagerank": (PageRank(tol=1e-9, max_steps=300), gab, WINDOWS,
                     PAGERANK_KERNELS, RESIDENT_KERNELS),
        "cc": (ConnectedComponents(max_steps=100), gab, WINDOWS, CC_KERNELS,
               RESIDENT_KERNELS),
        "bfs": (SSSP(seeds=LDBC_SEEDS, directed=False, max_steps=32),
                ldbc_s, LDBC_WINDOWS,
                ("masks_from_deltas", "minplus_superstep"),
                RESIDENT_KERNELS),
        "sssp": (SSSP(seeds=LDBC_SEEDS, weight_prop="weight",
                      directed=False, max_steps=32), ldbc_s, LDBC_WINDOWS,
                 SSSP_KERNELS, COLD_KERNELS),
    }
    modes = ["rebase"] + ["incremental"] * LIVE_BATCHES
    modes[LIVE_NEW_VERTEX + 1] = "rebase"
    # the min-merge seed: every incremental epoch but the one that folds
    # the deletes (epoch i + 1 folds batch i)
    warm_cc = [m == "incremental" for m in modes]
    warm_cc[LIVE_DELETES + 1] = False
    out, all_launches = {}, {}
    for name, (prog, stream, windows, kern, kern_off) in cases.items():
        rows, state, launches, wall, grown = serve_live(
            columns, stream, prog, windows, dev, live=True)
        check_launched(f"live {name}", launches, kern)
        eps = list(state.epochs)
        if [e["mode"] for e in eps] != modes:
            raise AssertionError(f"live {name}: epoch modes "
                                 f"{[e['mode'] for e in eps]}")
        if name != "pagerank" and any(e["warm"] for e in eps):
            raise AssertionError(f"live {name}: a windowed epoch was "
                                 "warm-seeded")
        rows0, state0, launches0, wall0, _ = serve_live(
            columns, stream, prog, windows, dev, live=False)
        check_launched(f"live {name} (RTPU_LIVE=0)", launches0, kern_off)
        if state0.mode_counts != {"resweep": LIVE_BATCHES + 1}:
            raise AssertionError(f"live {name} RTPU_LIVE=0: "
                                 f"{state0.mode_counts}")
        _, t0, step, _ = stream
        mgr = AnalysisManager(TemporalGraph(grown, device=dev), device=dev)
        s0 = time.perf_counter()
        job = mgr.submit(prog, RangeQuery(t0, t0 + LIVE_BATCHES * step,
                                          step, windows=tuple(windows)))
        if not job.wait(900) or job.status != "done":
            raise AssertionError(f"live {name} scratch Range: {job.error}")
        scratch_s = time.perf_counter() - s0
        want = mgr.results(job.id)
        same_live_rows(f"live {name}", rows, want, name == "pagerank")
        same_live_rows(f"live {name} RTPU_LIVE=0", rows0, want,
                       name == "pagerank")
        all_launches[name] = nonzero(launches)
        out[name] = dict(
            t0=t0, step=step, windows=windows, wall_s=wall,
            wall_live0_s=wall0, scratch_range_s=scratch_s,
            mode_counts=state.mode_counts,
            epochs=[dict(e, live0_seconds=e0["seconds"])
                    for e, e0 in zip(eps, state0.epochs)],
            launches=nonzero(launches), launches_live0=nonzero(launches0))
    # CC unwindowed: the warm gate open on add-only epochs
    prog = ConnectedComponents(max_steps=100)
    rows, state, launches, wall, grown = serve_live(
        columns, gab, prog, None, dev, live=True)
    check_launched("live cc unwindowed", launches, CC_KERNELS)
    eps = list(state.epochs)
    if [e["mode"] for e in eps] != modes \
            or [e["warm"] for e in eps] != warm_cc:
        raise AssertionError(f"live cc unwindowed: epochs {eps}")
    _, t0, step, _ = gab
    mgr = AnalysisManager(TemporalGraph(grown, device=dev), device=dev)
    job = mgr.submit(prog, RangeQuery(t0, t0 + LIVE_BATCHES * step, step))
    if not job.wait(900) or job.status != "done":
        raise AssertionError(f"live cc unwindowed scratch Range: "
                             f"{job.error}")
    same_live_rows("live cc unwindowed", rows, mgr.results(job.id), False)
    all_launches["cc_unwindowed"] = nonzero(launches)
    out["cc_unwindowed"] = dict(
        t0=t0, step=step, windows=None, wall_s=wall,
        mode_counts=state.mode_counts, epochs=eps,
        launches=nonzero(launches))
    emit("live", batches=LIVE_BATCHES, new_vertex_batch=LIVE_NEW_VERTEX,
         deletes_batch=LIVE_DELETES, runs=out)
    return all_launches


def phase_repin_view(torch, np, columns, log, dev):
    """The resident route adopts a suffix: the warm GAB View at 0.9 of the
    span, then 1 % more events (re-drawn edge adds of known pairs) after
    the pin; the next View must extend the sweep (``DeviceSweep.repin``
    "extended", no new ``DeviceSweep``) and its rows equal, bitwise, those
    of a fresh sweep's View and of the cold route's. Prints the extended
    View's seconds beside the fresh sweep's and the cold route's."""
    from raphtory_tpu_torch.algorithms import ConnectedComponents, PageRank
    from raphtory_tpu_torch.core.events import EDGE_ADD, EventLog
    from raphtory_tpu_torch.core.service import TemporalGraph
    from raphtory_tpu_torch.engine import device_sweep
    from raphtory_tpu_torch.jobs.manager import AnalysisManager, ViewQuery

    t, k = log.column("time"), log.column("kind")
    s, d = log.column("src"), log.column("dst")
    t1 = int(0.9 * GAB_SPAN)
    t2 = t1 + int(0.05 * GAB_SPAN)
    h = int(np.searchsorted(t, t1, side="right"))
    part = EventLog()
    part.append_batch(t[:h].copy(), k[:h].copy(), s[:h].copy(), d[:h].copy())
    rng = np.random.default_rng(22)
    adds = np.flatnonzero(k[:h] == EDGE_ADD)
    n_suffix = len(t) // 100
    rows = adds[rng.integers(0, len(adds), n_suffix)]
    suffix = (np.sort(rng.integers(t1 + 1, t2 + 1, n_suffix)).astype(
        np.int64), np.full(n_suffix, EDGE_ADD, np.uint8), s[rows].copy(),
        d[rows].copy())
    progs = (PageRank(tol=1e-7, max_steps=20),
             ConnectedComponents(max_steps=100))
    statuses, built = [], []
    repin, init = device_sweep.DeviceSweep.repin, \
        device_sweep.DeviceSweep.__init__

    def counting_repin(self, live_log):
        statuses.append(repin(self, live_log))
        return statuses[-1]

    def counting_init(self, *a, **kw):
        built.append(1)
        init(self, *a, **kw)

    def views(mgr, T):
        got, secs = [], []
        for prog in progs:
            s0 = time.perf_counter()
            job = mgr.submit(prog, ViewQuery(T, windows=tuple(WINDOWS)))
            if not job.wait(600) or job.status != "done":
                raise AssertionError(f"repin_view: {job.error}")
            secs.append(time.perf_counter() - s0)
            got += [{kk: v for kk, v in r.items() if kk != "viewTime"}
                    for r in mgr.results(job.id)]
        return got, secs

    device_sweep.DeviceSweep.repin = counting_repin
    device_sweep.DeviceSweep.__init__ = counting_init
    try:
        g = TemporalGraph(part, device=dev)
        mgr = AnalysisManager(g, device=dev)
        _, warm_s = views(mgr, t1)
        sweep = g._resident
        part.append_batch(*suffix)
        columns.reset_launches()
        got, ext_s = views(mgr, t2)
        launches = dict(columns.LAUNCHES)
        n_built = len(built)
        if statuses != ["extended"] or n_built != 1 \
                or g._resident is not sweep:
            raise AssertionError(f"repin_view: statuses {statuses}, "
                                 f"{len(built)} sweeps built")
        check_launched("repin_view", launches, RESIDENT_KERNELS)
        fresh, fresh_s = views(AnalysisManager(
            TemporalGraph(part, device=dev), device=dev), t2)
        cold_g = TemporalGraph(part, device=dev)
        cold_g._resident_broken = True        # the resident route declines
        cold, cold_s = views(AnalysisManager(cold_g, device=dev), t2)
    finally:
        device_sweep.DeviceSweep.repin = repin
        device_sweep.DeviceSweep.__init__ = init
    if got != fresh:
        raise AssertionError("repin_view: the extended View's rows differ "
                             "from a fresh sweep's")
    if got != cold:
        raise AssertionError("repin_view: the extended View's rows differ "
                             "from the cold route's")
    emit("repin_view", t1=t1, t2=t2, pinned_events=h,
         suffix_events=n_suffix, status=statuses, sweeps_built=n_built,
         programs=[type(p).__name__ for p in progs], warm_view_s=warm_s,
         extended_view_s=ext_s, fresh_sweep_view_s=fresh_s,
         cold_view_s=cold_s, launches=nonzero(launches))
    return nonzero(launches)


def phase_programs(torch, np, columns, log, ldbc, dev):
    """The five programs of slice 20 through ``AnalysisManager`` on the
    card, each as a View and as a Range (the cold route: their reducers
    read the whole view), rows held against the same jobs on the CPU
    through the twins, bitwise: DegreeRanking, StarNode, Density and
    BinaryDiffusion on the GAB log, FlowGraph over the LDBC log's
    ``weight``. Returns each program's launches."""
    from raphtory_tpu_torch.algorithms import (BinaryDiffusion,
                                               DegreeRanking, Density,
                                               FlowGraph, StarNode)
    from raphtory_tpu_torch.core.service import TemporalGraph
    from raphtory_tpu_torch.jobs.manager import (AnalysisManager,
                                                 RangeQuery, ViewQuery)

    def queries(span, windows):
        return (ViewQuery(int(0.9 * span), windows=tuple(windows)),
                RangeQuery(int(0.8 * span), int(0.9 * span),
                           int(0.05 * span), windows=tuple(windows)))

    cases = {
        "DegreeRanking": (DegreeRanking(top_k=10), log, GAB_SPAN, WINDOWS),
        "StarNode": (StarNode(), log, GAB_SPAN, WINDOWS),
        "Density": (Density(), log, GAB_SPAN, WINDOWS),
        "BinaryDiffusion": (BinaryDiffusion(spread_prob=0.3, max_steps=50),
                            log, GAB_SPAN, WINDOWS),
        "FlowGraph": (FlowGraph(flow_prop="weight"), ldbc, LDBC_SPAN,
                      LDBC_WINDOWS),
    }
    out, all_launches = {}, {}
    for name, (prog, lg, span, windows) in cases.items():
        mgrs = {where: AnalysisManager(TemporalGraph(lg, device=where),
                                       device=where)
                for where in (dev, "cpu")}
        entry = {}
        for q in queries(span, windows):
            kind = type(q).__name__
            res = {}
            for where, mgr in mgrs.items():
                columns.reset_launches()
                s0 = time.perf_counter()
                job = mgr.submit(prog, q)
                if not job.wait(900) or job.status != "done":
                    raise AssertionError(f"programs {name} {kind} on "
                                         f"{where}: {job.error}")
                res[str(where)] = (
                    [{kk: v for kk, v in r.items() if kk != "viewTime"}
                     for r in mgr.results(job.id)],
                    time.perf_counter() - s0, dict(columns.LAUNCHES))
            (got, secs, launches), (want, cpu_s, _) = res[str(dev)], \
                res["cpu"]
            if got != want:
                raise AssertionError(f"programs {name} {kind}: card rows "
                                     "differ from the CPU's")
            check_launched(f"programs {name} {kind}", launches,
                           COLD_KERNELS)
            entry[kind] = dict(rows=len(got), seconds=secs, cpu_s=cpu_s,
                               steps=sorted({r["steps"] for r in got}),
                               launches=nonzero(launches))
            if name == "BinaryDiffusion":
                entry[kind]["infected"] = [r["result"]["infected"]
                                           for r in got]
        out[name] = entry
        all_launches[name] = entry["ViewQuery"]["launches"]
    if max(out["BinaryDiffusion"]["ViewQuery"]["infected"]) <= 1:
        raise AssertionError("programs: BinaryDiffusion never spread")
    emit("programs", runs=out)
    return all_launches


#: the serve phase: the headline's 12 hops (0.45 .. 1.0 x t_span, 130,000
#: apart) and the LDBC server's 11 (0.5 .. 1.0 x its span)
SERVE_HOP0, SERVE_STEP = 1_170_000, 130_000
LDBC_HOP0 = 1_300_000
#: the coalescing window of the serve phase's servers, a harness choice (a
#: deployment's default is 3 ms): long enough that a burst posted from
#: concurrent threads lands in one window. The phase ends with traffic at
#: the default window
SERVE_WINDOW_MS = 250
#: converged, as the live phase's: a coalesced batch solves its columns
#: cold in one dispatch where a solo Range warm-starts chunk by chunk, and
#: the two agree to the tolerance only at the fixed point
SERVE_PR = {"tol": 1e-9, "max_steps": 300}
SERVE_CC = {"max_steps": 50}
SERVE_SSSP = {"seeds": list(LDBC_SEEDS), "weight_prop": "weight",
              "directed": False, "max_steps": 32}
#: (first hop index, last hop index, stride, window indices): subsets of
#: every other hop (6 of the 12, each union grid 6 hops x the windows, so
#: the CPU comparisons fit the phase's time)
SERVE_PR_REQS = [(0, 10, 2, (0,)), (0, 8, 4, (1, 2)), (2, 10, 4, (0, 1, 2)),
                 (6, 10, 2, (2,)), (4, 8, 2, (1,)), (0, 10, 10, (0, 2)),
                 (4, 6, 2, (0, 1)), (8, 10, 2, (2, 0))]
SERVE_CC_REQS = [(0, 8, 4, (0,)), (2, 10, 8, (0, 1)), (6, 10, 2, (2,))]
SERVE_SSSP_REQS = [(0, 10, 2, (0, 1)), (2, 10, 4, (0,)), (6, 10, 2, (1,))]
SERVE_KERNELS = ("masks_from_deltas", "column_out_degree", "column_pull_sum",
                 "pagerank_update", "cc_superstep", "minplus_superstep",
                 "weights_from_deltas", "apply_delta_chunk", "window_masks",
                 "segment_combine", "unpack_mask_bits")
SERVE_GETS = ("/Jobs", "/Analysers", "/healthz", "/statusz", "/costz",
              "/devicez", "/freshz", "/slz?n=5", "/journalz", "/workloadz",
              "/faultz")


def http(port: int, path: str, body=None, timeout: float = 120.0):
    """``(status, JSON document)`` of one request to a local server."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_range(name, params, reqs, hop0, step, windows, tag):
    """REST Range bodies of ``reqs``: hops ``hop0 + step * i`` for i in
    ``range(first, last + 1, stride)``, the windows by index."""
    return [dict(analyserName=name, params=dict(params),
                 start=hop0 + step * a, end=hop0 + step * b,
                 jump=step * k, windowType="batched",
                 windowSet=[windows[i] for i in w],
                 jobID=f"{tag}{j}", sinkName=f"{tag}{j}.jsonl")
            for j, (a, b, k, w) in enumerate(reqs)]


def query_of(body):
    """The manager query a REST body asks for."""
    from raphtory_tpu_torch.jobs.manager import RangeQuery, ViewQuery

    ws = tuple(body["windowSet"]) if "windowSet" in body else None
    if "timestamp" in body:
        return ViewQuery(int(body["timestamp"]), windows=ws)
    return RangeQuery(int(body["start"]), int(body["end"]),
                      int(body["jump"]), windows=ws)


def post_all(port: int, path: str, bodies) -> None:
    """Every body posted at once, from a thread each (concurrent
    clients)."""
    import threading

    codes = [None] * len(bodies)

    def one(i):
        codes[i] = http(port, path, bodies[i])

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    bad = [c for c in codes if c[0] != 200]
    if bad:
        raise AssertionError(f"serve: POST {path} answered {bad}")


def await_done(port: int, job_ids, timeout: float = 300.0) -> dict:
    """``/AnalysisResults`` of each job once it has ended; fails unless it
    ended ``done``."""
    out, deadline = {}, time.monotonic() + timeout
    for jid in job_ids:
        while True:
            code, res = http(port, f"/AnalysisResults?jobID={jid}")
            if code != 200:
                raise AssertionError(f"serve: {jid}: {code} {res}")
            if res["status"] not in ("running", "pending"):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"serve: {jid} still {res['status']}")
            time.sleep(0.005)
        if res["status"] != "done":
            raise AssertionError(f"serve: {jid} {res['status']}: "
                                 f"{res.get('error')}")
        out[jid] = res
    return out


def cpu_rows(log, bodies, coalesce: bool, windows_ms: int = 0):
    """The rows of each body's query on the CPU through the twins: solo
    (each on its own hops, ``RTPU_BATCH_WINDOW_MS=0``), or, with
    ``coalesce``, submitted together under the serve window, so the CPU's
    scheduler packs them as the card's did. Returns ``{jobID: rows}`` and
    each job's coalesced block."""
    import threading

    from raphtory_tpu_torch.core.service import TemporalGraph
    from raphtory_tpu_torch.jobs import registry
    from raphtory_tpu_torch.jobs.manager import AnalysisManager

    os.environ["RTPU_BATCH_WINDOW_MS"] = str(
        SERVE_WINDOW_MS if coalesce else windows_ms)
    mgr = AnalysisManager(TemporalGraph(log, device="cpu"), device="cpu")
    jobs = {}

    def one(body):
        jobs[body["jobID"]] = mgr.submit(
            registry.resolve(body["analyserName"], body.get("params")),
            query_of(body), job_id=body["jobID"])

    if coalesce:
        threads = [threading.Thread(target=one, args=(b,)) for b in bodies]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    else:
        for b in bodies:
            one(b)
            jobs[b["jobID"]].wait(900)
    out, blocks = {}, {}
    for jid, job in jobs.items():
        if not job.wait(900) or job.status != "done":
            raise AssertionError(f"serve CPU {jid}: {job.status}: "
                                 f"{job.error}")
        # as the REST answer carries them: through JSON
        out[jid] = json.loads(json.dumps(
            [{k: v for k, v in r.items() if k != "viewTime"}
             for r in mgr.results(jid)]))
        blocks[jid] = {k: v for k, v in (job.ledger.coalesced or {}).items()
                       if k not in ("batch_id",)}
    return out, blocks


def values_match(what, got, want) -> None:
    """Rows of a coalesced member against the same query run solo: equal
    time / windowsize and results (PageRank within rtol 1e-5 / atol 1e-7
    and its top-10 ids), whatever the supersteps (a coalesced row reports
    its batch's, as in the reference)."""
    compare_rows(what, [dict(r, steps=0) for r in got],
                 [dict(r, steps=0) for r in want])


def span_seconds(spans, name) -> list:
    return [s["dur"] / 1e6 for s in spans
            if s.get("ph") == "X" and s["name"] == name]


def live_split(spans) -> list:
    """Each live epoch's seconds split into repin (``live.repin``), fold
    (``hop.fold``) and dispatch (``hop.compute``) from the job's spans,
    an epoch the spans that start inside its ``live.repin`` ..
    ``live.epoch`` interval."""
    xs = sorted((s for s in spans if s.get("ph") == "X"),
                key=lambda s: s["ts"])
    epochs = [s for s in xs if s["name"] == "live.epoch"]
    repins = [s for s in xs if s["name"] == "live.repin"]
    out = []
    for e in epochs:
        lo, hi = e["ts"], e["ts"] + e["dur"]
        rep = [r for r in repins if r["ts"] + r["dur"] <= lo
               and all(not (r["ts"] + r["dur"] <= o["ts"] < lo)
                       for o in epochs)]
        inside = [s for s in xs if lo <= s["ts"] < hi]
        out.append(dict(
            mode=e["args"].get("mode"), time=e["args"].get("time"),
            epoch_s=e["dur"] / 1e6,
            repin_s=rep[-1]["dur"] / 1e6 if rep else 0.0,
            fold_s=sum(s["dur"] for s in inside
                       if s["name"] == "hop.fold") / 1e6,
            dispatch_s=sum(s["dur"] for s in inside
                           if s["name"] == "hop.compute") / 1e6))
    return out


def latency_stats(secs) -> dict:
    import statistics

    return {"n": len(secs), "median_s": statistics.median(secs),
            "max_s": max(secs)}


def phase_serve(torch, np, columns, log, ldbc, dev):
    """The REST serving stack on the card (``jobs/rest.RestServer`` over
    ``AnalysisManager``, in process, port 0): a server over the headline
    GAB log and one over the LDBC log, each with a sink directory, and a
    third over the ``live`` phase's GAB stream; the serving scheduler's
    coalescing window ``SERVE_WINDOW_MS``. Over HTTP: a burst of 8
    concurrent PageRank Range requests (each its own subset of the 12
    hops and of the 3 windows), 3 concurrent CC Ranges, 3 concurrent
    weighted SSSP Ranges on the LDBC server (its 2 windows); a PageRank
    View warm (the resident route: K9a, K9b, K7) and cold (behind the
    resident clock: K8u, K7), a ``DegreeBasic`` View, an ``explain=1``
    Range (its ledger back), a ``KillTask`` on a long Range; every ported
    GET route and ``/tracez`` of one request's trace id; the metrics text
    of a ``MetricsServer``; a Live PageRank subscription over 3 batches of
    the live stream. Checks: every row against the same query on the CPU
    through the twins (each request solo on its own hops: results;
    and the burst coalesced on the CPU the same way: the same batches and
    equal supersteps; PageRank rtol 1e-5 / atol 1e-7, the rest equal);
    every sink file equal to its rows; a coalesced PageRank batch of 8,
    a CC batch and an SSSP batch, none declined; K1, K2a/b/c, K5, K6,
    K6w, K9a, K9b, K7 and K8u launched. Then one injected
    ``sched.dispatch`` failure: the batch's members take their own routes
    on the card, rows equal to the CPU's, equal supersteps. Last, at the
    default window (3 ms): 3 PageRank Ranges one after another and the
    burst of 8 again, rows against the solo CPU rows. Prints each
    request kind's submit-to-done seconds at both windows, the batches, the
    ``sched.dispatch`` spans and the Live epochs split into repin, fold
    and dispatch. ``RTPU_PCPM=0``, as every phase before ``pcpm`` pins it:
    the binned kernels (KB1, K2b-P, K5-P) are not on this path."""
    import tempfile

    from raphtory_tpu_torch.algorithms import PageRank
    from raphtory_tpu_torch.core.service import TemporalGraph
    from raphtory_tpu_torch.ingestion.watermark import WatermarkRegistry
    from raphtory_tpu_torch.jobs.manager import AnalysisManager, LiveQuery
    from raphtory_tpu_torch.jobs.rest import RestServer
    from raphtory_tpu_torch.obs.metrics import MetricsServer
    from raphtory_tpu_torch.obs.trace import TRACER
    from raphtory_tpu_torch.resilience import faults

    tmp = tempfile.mkdtemp(prefix="rtpu_serve_")
    stream = live_stream(np, log, 20, weighted=False)   # the live phase's
    first, t0, step, batches = stream
    live_log, wm = first(), WatermarkRegistry()
    wm.register("feed")
    wm.advance("feed", t0)
    os.environ["RTPU_BATCH_WINDOW_MS"] = str(SERVE_WINDOW_MS)
    mgrs = {"gab": AnalysisManager(TemporalGraph(log, device=dev),
                                   device=dev, sink_dir=f"{tmp}/gab"),
            "ldbc": AnalysisManager(TemporalGraph(ldbc, device=dev),
                                    device=dev, sink_dir=f"{tmp}/ldbc"),
            "live": AnalysisManager(TemporalGraph(live_log, watermarks=wm,
                                                  device=dev), device=dev)}
    servers = {k: RestServer(m, port=0).start() for k, m in mgrs.items()}
    port = {k: s.port for k, s in servers.items()}
    metrics = MetricsServer(port=0, addr="127.0.0.1").start()
    was_tracing = TRACER.enabled
    try:
        if http(port["gab"], "/tracez?enable=1")[0] != 200:
            raise AssertionError("serve: /tracez?enable=1")
        pr = serve_range("PageRank", SERVE_PR, SERVE_PR_REQS, SERVE_HOP0,
                         SERVE_STEP, WINDOWS, "pr")
        cc = serve_range("ConnectedComponents", SERVE_CC, SERVE_CC_REQS,
                         SERVE_HOP0, SERVE_STEP, WINDOWS, "cc")
        sssp = serve_range("SSSP", SERVE_SSSP, SERVE_SSSP_REQS, LDBC_HOP0,
                           SERVE_STEP, LDBC_WINDOWS, "sssp")
        views = [dict(analyserName="PageRank", params=dict(SERVE_PR),
                      timestamp=int(f * GAB_SPAN), windowType="batched",
                      windowSet=WINDOWS, jobID=name, sinkName=f"{name}.jsonl")
                 for name, f in (("pr_view_pin", 0.95),
                                 ("pr_view_warm", 0.98),
                                 ("pr_view_cold", 0.90))]
        views.append(dict(analyserName="DegreeBasic",
                          timestamp=int(0.97 * GAB_SPAN),
                          windowType="batched", windowSet=WINDOWS,
                          jobID="degree_view", sinkName="degree_view.jsonl"))
        explain = dict(analyserName="PageRank", params=dict(SERVE_PR),
                       start=SERVE_HOP0 + 9 * SERVE_STEP,
                       end=SERVE_HOP0 + 11 * SERVE_STEP, jump=SERVE_STEP,
                       windowType="batched", windowSet=WINDOWS[:1],
                       jobID="explain", explain=1)
        cold_fold()
        columns.reset_launches()
        w0 = time.perf_counter()
        post_all(port["gab"], "/RangeAnalysisRequest", pr)
        post_all(port["gab"], "/RangeAnalysisRequest", cc)
        post_all(port["ldbc"], "/RangeAnalysisRequest", sssp)
        res = await_done(port["gab"], [b["jobID"] for b in pr + cc])
        res.update(await_done(port["ldbc"], [b["jobID"] for b in sssp]))
        burst_s = time.perf_counter() - w0
        # the batches' spans, before later traffic rolls them off the ring
        dispatch = [dict(args={k: s["args"].get(k) for k in (
            "family", "jobs", "hops", "windows", "cols")},
            seconds=s["dur"] / 1e6) for s in TRACER.recent(4096)
            if s.get("ph") == "X" and s["name"] == "sched.dispatch"]
        for body in views:
            post_all(port["gab"], "/ViewAnalysisRequest", [body])
            res.update(await_done(port["gab"], [body["jobID"]]))
        post_all(port["gab"], "/RangeAnalysisRequest", [explain])
        res.update(await_done(port["gab"], ["explain"]))
        led = res["explain"].get("ledger")
        if not led or led["views"] != len(res["explain"]["results"]) \
                or led["device"]["dispatches"] < 1:
            raise AssertionError(f"serve: explain ledger {led}")
        long = dict(analyserName="DegreeBasic", start=int(0.5 * GAB_SPAN),
                    end=GAB_SPAN, jump=1_000, jobID="long")
        post_all(port["gab"], "/RangeAnalysisRequest", [long])
        code, k = http(port["gab"], "/KillTask?jobID=long")
        while True:
            c2, kres = http(port["gab"], "/AnalysisResults?jobID=long")
            if kres["status"] not in ("running", "pending"):
                break
            time.sleep(0.01)
        if code != 200 or kres["status"] != "killed":
            raise AssertionError(f"serve: KillTask {code} {k} -> "
                                 f"{kres['status']}")
        # the Live subscription over 3 batches of the live stream
        live_body = dict(analyserName="PageRank",
                         params={"tol": 1e-9, "max_steps": 300},
                         repeatTime=step, eventTime=True,
                         maxRuns=len(batches[:3]) + 1, windowType="batched",
                         windowSet=WINDOWS, jobID="live")
        post_all(port["live"], "/LiveAnalysisRequest", [live_body])
        live_job = mgrs["live"].get("live")
        deadline = time.monotonic() + 300.0
        for i, (bt, bk, bs, bd, bp) in enumerate(batches[:3]):
            while len(mgrs["live"].results("live")) < (i + 1) * len(WINDOWS):
                if live_job.wait(0.0005):
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"serve: Live epoch {i} never "
                                         f"came ({live_job.status})")
            live_log.append_batch(bt, bk, bs, bd, props=bp)
            wm.advance("feed", t0 + (i + 1) * step)
        wm.finish("feed")
        res.update(await_done(port["live"], ["live"]))
        serve_s = time.perf_counter() - w0
        launches = dict(columns.LAUNCHES)
        check_launched("serve", launches, SERVE_KERNELS)
        # every GET route
        gets = {}
        for path in SERVE_GETS:
            code, doc = http(port["gab"], path)
            if code != 200:
                raise AssertionError(f"serve: GET {path}: {code} {doc}")
            gets[path] = doc
        trace_id = res["explain"]["traceID"]
        code, tz = http(port["gab"], f"/tracez?trace_id={trace_id}")
        names = {s["name"] for s in tz.get("spans", [])}
        if code != 200 or not {"rest.request", "job", "sweep.columnar",
                               "hop.compute"} <= names:
            raise AssertionError(f"serve: /tracez of {trace_id}: {names}")
        for path in ("/advisez", "/profilez", "/clusterz"):
            if http(port["gab"], path)[0] != 404:
                raise AssertionError(f"serve: {path} is not unknown")
        import urllib.request

        with urllib.request.urlopen(
                f"http://127.0.0.1:{metrics.port}/metrics",
                timeout=60) as resp:
            text = resp.read().decode()
        if 'raphtory_scheduler_batches_total{family="pagerank"}' not in text:
            raise AssertionError("serve: metrics text lacks the batches")
        sched = {k: m.scheduler.status_block() for k, m in mgrs.items()}
        hist = sched["gab"]["coalesced_jobs_hist"]
        if (hist.get(str(len(pr)), 0) < 1 or hist.get(str(len(cc)), 0) < 1
                or sched["ldbc"]["coalesced_jobs_hist"].get(
                    str(len(sssp)), 0) < 1
                or sched["gab"]["batch_declined"]
                or sched["ldbc"]["batch_declined"]):
            raise AssertionError(f"serve: batches {sched}")
        # sink files equal their rows
        for k, bodies in (("gab", pr + cc + views), ("ldbc", sssp)):
            for b in bodies:
                with open(f"{tmp}/{k}/{b['sinkName']}") as f:
                    disk = [json.loads(x) for x in f]
                if disk != res[b["jobID"]]["results"]:
                    raise AssertionError(f"serve: sink {b['sinkName']} "
                                         "differs from its rows")
        split = live_split(TRACER.for_trace(res["live"]["traceID"]))
        kinds = {**{b["jobID"]: ("gab", "pagerank_range") for b in pr},
                 **{b["jobID"]: ("gab", "cc_range") for b in cc},
                 **{b["jobID"]: ("ldbc", "sssp_range") for b in sssp},
                 **{b["jobID"]: ("gab", b["jobID"]) for b in views},
                 "explain": ("gab", "explain_range"),
                 "live": ("live", "live_subscription")}
        lat = {}
        for jid, (srv, kind) in kinds.items():
            lat.setdefault(kind, []).append(
                mgrs[srv].get(jid).ledger.wall_seconds)
        blocks = {jid: mgrs["ldbc" if jid.startswith("sssp") else "gab"].get(
            jid).ledger.coalesced for jid in
            [b["jobID"] for b in pr + cc + sssp]}
        # one injected sched.dispatch failure: the members' own routes
        fails = pr[:3]
        fails = [dict(b, jobID=f"f{b['jobID']}", sinkName=None)
                 for b in fails]
        faults.arm("sched.dispatch=error:1.0:1")
        try:
            post_all(port["gab"], "/RangeAnalysisRequest", fails)
            fres = await_done(port["gab"], [b["jobID"] for b in fails])
            code, fz = http(port["gab"], "/faultz")
        finally:
            faults.disarm()
        declined = mgrs["gab"].scheduler.status_block()["batch_declined"]
        if fz["sites"].get("sched.dispatch", {}).get("injected") != 1 \
                or declined != 1:
            raise AssertionError(f"serve: failpoint {fz} declined "
                                 f"{declined}")
        fail_launches = dict(columns.LAUNCHES)
        # the default window (RTPU_BATCH_WINDOW_MS unset: 3 ms), as a
        # deployment runs: 3 PageRank Ranges one after another (each a
        # solo request, held for the window and passed through), then
        # the burst of 8 posted at once; the fold cache emptied first
        os.environ.pop("RTPU_BATCH_WINDOW_MS")
        dflt = {"solo": [dict(b, jobID=f"d{b['jobID']}", sinkName=None)
                         for b in pr[:3]],
                "burst": [dict(b, jobID=f"db{b['jobID']}", sinkName=None)
                          for b in pr]}
        before = mgrs["gab"].scheduler.status_block()
        cold_fold()
        dres = {}
        for body in dflt["solo"]:
            post_all(port["gab"], "/RangeAnalysisRequest", [body])
            dres.update(await_done(port["gab"], [body["jobID"]]))
        post_all(port["gab"], "/RangeAnalysisRequest", dflt["burst"])
        dres.update(await_done(port["gab"],
                               [b["jobID"] for b in dflt["burst"]]))
        after = mgrs["gab"].scheduler.status_block()
        os.environ["RTPU_BATCH_WINDOW_MS"] = str(SERVE_WINDOW_MS)
        if after["window_ms"] != 3.0 \
                or after["batch_declined"] != before["batch_declined"]:
            raise AssertionError(f"serve: default window {after}")
        dflt_out = dict(
            window_ms=after["window_ms"],
            latency_s={k: latency_stats([
                mgrs["gab"].get(b["jobID"]).ledger.wall_seconds
                for b in v]) for k, v in dflt.items()},
            coalesced={b["jobID"]: (mgrs["gab"].get(
                b["jobID"]).ledger.coalesced or {}).get("jobs")
                for k in dflt.values() for b in k},
            batches={k: after[k] - before[k] for k in (
                "batches_formed", "jobs_coalesced", "solo_passthrough")})
    finally:
        if not was_tracing:
            TRACER.disable()
        for s in servers.values():
            s.stop()
        metrics.stop()
    # the CPU: each request solo on its own hops, and the bursts coalesced
    # the same way
    cpu_s = {}
    c0 = time.perf_counter()
    solo, _ = cpu_rows(log, pr + cc + views[:3] + [views[3], explain],
                       coalesce=False)
    solo.update(cpu_rows(ldbc, sssp, coalesce=False)[0])
    cpu_s["solo"] = time.perf_counter() - c0
    c0 = time.perf_counter()
    batch, cpu_blocks = cpu_rows(log, pr + cc, coalesce=True)
    b2, b2_blocks = cpu_rows(ldbc, sssp, coalesce=True)
    batch.update(b2)
    cpu_blocks.update(b2_blocks)
    os.environ["RTPU_BATCH_WINDOW_MS"] = "0"
    cpu_s["coalesced"] = time.perf_counter() - c0
    def strip(rows):
        return [{k: v for k, v in r.items() if k != "viewTime"}
                for r in rows]

    for jid, want in solo.items():
        got = strip(res[jid]["results"])
        if jid in batch:
            values_match(f"serve {jid} vs solo", got, want)
            compare_rows(f"serve {jid} vs the CPU batch", got, batch[jid])
            mine = {k: v for k, v in (blocks[jid] or {}).items()
                    if k != "batch_id"}
            if mine != cpu_blocks[jid]:
                raise AssertionError(f"serve {jid}: batch {mine} vs the "
                                     f"CPU's {cpu_blocks[jid]}")
        else:
            compare_rows(f"serve {jid}", got, want)
    # the failpoint's members ask pr[:3]'s queries again
    for body, src in zip(fails, pr):
        compare_rows(f"serve {body['jobID']} (own route)",
                     strip(fres[body["jobID"]]["results"]),
                     solo[src["jobID"]])
    # the default window's rows: a request that passed through against
    # its solo CPU rows, a coalesced one as the 250 ms burst's members
    for body, src in zip(dflt["solo"] + dflt["burst"], pr[:3] + pr):
        jid = body["jobID"]
        got, want = strip(dres[jid]["results"]), solo[src["jobID"]]
        if dflt_out["coalesced"][jid]:
            values_match(f"serve {jid} (3 ms window) vs solo", got, want)
        else:
            compare_rows(f"serve {jid} (3 ms window)", got, want)
    # the Live subscription against the same one on the CPU
    c0 = time.perf_counter()
    cpu_live = serve_live(columns, (first, t0, step, batches[:3]),
                          PageRank(tol=1e-9, max_steps=300), WINDOWS,
                          "cpu", live=True)[0]
    cpu_s["live"] = time.perf_counter() - c0
    same_live_rows("serve live", strip(res["live"]["results"]),
                   json.loads(json.dumps(cpu_live)), True)
    emit("serve", burst_s=burst_s, serve_s=serve_s, cpu_compare_s=cpu_s,
         window_ms=SERVE_WINDOW_MS,
         default_window=dflt_out,
         latency_s={k: latency_stats(v) for k, v in lat.items() if v},
         batches={k: {kk: sched[k][kk] for kk in (
             "batches_formed", "jobs_coalesced", "coalesced_jobs_hist",
             "batch_declined", "solo_passthrough")} for k in sched},
         members=blocks, sched_dispatch=dispatch,
         live_epochs=split, launches=nonzero(launches),
         failpoint=dict(declined=declined, launches=nonzero({
             k: fail_launches[k] - launches[k] for k in launches})),
         routes={p: sorted(d) if isinstance(d, dict) else len(d)
                 for p, d in gets.items()},
         costz_kernels=sorted({k["kernel"] for k in gets["/costz"][
             "kernels"]}),
         device_memory=gets["/devicez"]["memory"])
    return launches


MESH_TARGET = "raphtory_tpu_torch.cluster.tasks:run_requests"
ZIPF = dict(n_vertices=4096, n_events=160_000, seed=11)
ZIPF_T, ZIPF_WINDOWS = 1000, [800, 400, 200, 100]


def run_jobs(mgr, jobs):
    """Rows of each ``(program, query)`` job, submitted one after another,
    each folding cold."""
    out = []
    for prog, q in jobs:
        cold_fold()
        job = mgr.submit(prog, q)
        if not job.wait(900) or job.status != "done":
            raise AssertionError(f"{type(prog).__name__} job {job.status}: "
                                 f"{job.error}")
        out.append(mgr.results(job.id))
    return out


def reduced_rows(prog, vectors, T, windows, steps, view):
    """The job rows ``prog.reduce`` makes of per-window result vectors."""
    return [{"time": T, "windowsize": w, "steps": steps,
             "result": prog.reduce(vectors[i], view, window=w)}
            for i, w in enumerate(windows)]


def phase_mesh_one(torch, np, columns, log, dev):
    """The mesh path on one rank through ``AnalysisManager(..., mesh=)``:
    K12 Ranges, a K11 Range (columnar route declined) and K11 Views, each
    against the single-device port on the card. Returns the K12 vectors
    (PageRank, CC month) for ``mesh_ranks``."""
    import types

    from raphtory_tpu_torch.algorithms import ConnectedComponents, PageRank
    from raphtory_tpu_torch.core.service import TemporalGraph
    from raphtory_tpu_torch.core.snapshot import build_view
    from raphtory_tpu_torch.engine import bsp, hopbatch
    from raphtory_tpu_torch.jobs import manager
    from raphtory_tpu_torch.jobs.manager import (AnalysisManager,
                                                 RangeQuery, ViewQuery)
    from raphtory_tpu_torch.parallel import sharded
    from raphtory_tpu_torch.parallel.columns import run_columns_sharded

    mesh = sharded.make_mesh(1, 1, device=dev)
    hops, _ = headline_grid()
    pr, cc = PageRank(max_steps=20, tol=1e-7), ConnectedComponents(
        max_steps=50)
    span = dict(start=hops[0], end=hops[-1], jump=hops[1] - hops[0])
    q_pr = RangeQuery(windows=tuple(WINDOWS), **span)
    q_cc = RangeQuery(window=WINDOWS[0], **span)
    if list(range(q_pr.start, q_pr.end + 1, q_pr.jump)) != hops:
        raise AssertionError("mesh_one: the Range is not the headline grid")
    T = int(0.90 * GAB_SPAN)
    q_view = ViewQuery(T, windows=tuple(WINDOWS))
    mgr = AnalysisManager(TemporalGraph(log, device=dev), mesh=mesh)
    out = {}
    columns.reset_launches()
    t0 = time.perf_counter()
    pr_rows, cc_rows = run_jobs(mgr, [(pr, q_pr), (cc, q_cc)])
    torch.cuda.synchronize()
    out["k12_jobs_s"] = time.perf_counter() - t0
    out["k12_launches"] = dict(columns.LAUNCHES)
    check_launched("mesh_one K12", out["k12_launches"], K12_KERNELS)
    # the columnar route declined: on the mesh the static-partition sweep
    # (K11 a hop), on one device the resident DeviceSweep (its rows carry
    # each hop's own steps)
    mgr1 = AnalysisManager(TemporalGraph(log, device=dev), device=dev)
    orig = manager.Job._columnar_range_prep
    manager.Job._columnar_range_prep = lambda self, q: None
    try:
        columns.reset_launches()
        t0 = time.perf_counter()
        (cc_k11_rows,) = run_jobs(mgr, [(cc, q_cc)])
        torch.cuda.synchronize()
        out["k11_range_s"] = time.perf_counter() - t0
        out["k11_range_launches"] = dict(columns.LAUNCHES)
        (one_hops_rows,) = run_jobs(mgr1, [(cc, q_cc)])
    finally:
        manager.Job._columnar_range_prep = orig
    check_launched("mesh_one K11 Range", out["k11_range_launches"],
                   ("segment_combine",))
    columns.reset_launches()
    t0 = time.perf_counter()
    pr_view_rows, cc_view_rows = run_jobs(mgr, [(pr, q_view), (cc, q_view)])
    torch.cuda.synchronize()
    out["k11_views_s"] = time.perf_counter() - t0
    out["k11_view_launches"] = dict(columns.LAUNCHES)
    check_launched("mesh_one K11 Views", out["k11_view_launches"],
                   ("segment_combine",))

    # the single-device port on the card
    hb = hopbatch.HopBatchedPageRank(log, tol=1e-7, max_steps=20,
                                     device=dev)
    _, cols = hb._fold_columns(hops)
    want_pr, s_pr = hopbatch.run_columns(hb.tables, *cols, hops, WINDOWS,
                                         tol=1e-7, max_steps=20, device=dev)
    got_pr, g_pr = run_columns_sharded(hb.tables, *cols, hops, WINDOWS, mesh,
                                       kind="pagerank", tol=1e-7,
                                       max_steps=20)
    if g_pr != s_pr or not within_tol(got_pr, want_pr):
        raise AssertionError(f"mesh_one K12 PageRank differs from "
                             f"run_columns (steps {g_pr} vs {s_pr})")
    shell = types.SimpleNamespace(vids=hb.tables.vids)
    W = len(WINDOWS)
    want_rows = [row for j, T_ in enumerate(hops) for row in reduced_rows(
        pr, want_pr[j * W:(j + 1) * W].cpu().numpy(), T_, WINDOWS, s_pr,
        shell)]
    compare_rows("mesh_one PageRank Range", pr_rows, want_rows)
    want_cc, s_cc = hopbatch.run_cc_columns(hb.tables, *cols, hops,
                                            [WINDOWS[0]], max_steps=50,
                                            device=dev)
    got_cc, g_cc = run_columns_sharded(hb.tables, *cols, hops, [WINDOWS[0]],
                                       mesh, kind="cc", max_steps=50)
    if g_cc != s_cc or not torch.equal(got_cc, want_cc):
        raise AssertionError("mesh_one K12 CC differs from run_cc_columns")
    (one_cc_rows,) = run_jobs(mgr1, [(cc, q_cc)])
    compare_rows("mesh_one CC Range", cc_rows, one_cc_rows)
    compare_rows("mesh_one CC Range on K11", cc_k11_rows, one_hops_rows)
    view = build_view(log, T)
    for prog, rows in ((pr, pr_view_rows), (cc, cc_view_rows)):
        res, steps = bsp.run(prog, view, windows=WINDOWS, device=dev)
        compare_rows(f"mesh_one {type(prog).__name__} View", rows,
                     reduced_rows(prog, res.cpu().numpy(), T, WINDOWS,
                                  steps, view))
    out.update(
        rows=dict(pagerank_range=len(pr_rows), cc_range=len(cc_rows),
                  cc_range_k11=len(cc_k11_rows), views=len(pr_view_rows)
                  + len(cc_view_rows)),
        steps=dict(pagerank_range=g_pr, cc_range=g_cc,
                   cc_range_k11=[r["steps"] for r in cc_k11_rows],
                   pagerank_view=pr_view_rows[0]["steps"],
                   cc_view=cc_view_rows[0]["steps"]),
        k12_max_abs_err_vs_run_columns=exact_err(got_pr, want_pr))
    emit("mesh_one", **out)
    return {"pagerank": (got_pr, g_pr), "cc_month": (got_cc, g_cc)}


def device_ms(torch, fn, iters: int = 20) -> tuple[float, str]:
    """Device milliseconds of one ``fn()``: the summed durations of the
    device's activities (kernels, copies, sets) in a ``torch.profiler``
    trace of ``iters`` calls, over ``iters`` ("profiler"); where the trace
    holds fewer device activities than calls (none, or a trace that lost
    some: every call launches at least one kernel), CUDA events around
    single calls with a sync each ("events": this counts the launch
    latency in)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    acts = [e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == DeviceType.CUDA]
    if len(acts) >= iters and sum(acts) > 0:
        return sum(acts) / iters / 1e3, "profiler"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters, "events"


def bits_equal(torch, got, want) -> bool:
    """``torch.equal`` of the bit patterns; NaNs must sit at the same
    places, whatever their payload (``np.minimum``'s rule: a NaN wins)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if not got.dtype.is_floating_point:
        return torch.equal(got, want)
    nan = torch.isnan(want)
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    gb, wb = (t.contiguous().view(ints[t.element_size()])
              for t in (got, want))
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(gb[~nan], wb[~nan]))


#: calls a batch of ``paired_ms`` times, and the rounds it takes the
#: median of: at the mesh path's shape a call is a few µs of host time,
#: and one batch of 20 calls left the host's jitter in the number
EXCHANGE_ITERS = 200
EXCHANGE_ROUNDS = 7


def paired_ms(torch, kern, lib) -> dict:
    """The kernel's and the library call's ``ms`` and ``host_ms``, taken
    in the same loops: ``EXCHANGE_ROUNDS`` rounds, each a batch of
    ``EXCHANGE_ITERS`` calls of the kernel and then one of the library
    call, CUDA events around each batch (``ms``, a call's share of the
    card's timeline) and the host clock over the same batch up to its last
    launch (``host_ms``, what the caller's thread spends: checks,
    allocation, the launch); each the median of its rounds. The rounds
    alternate, so both calls are timed under the same host load, which at
    a few µs a call decides which is faster; ``ms`` is at least
    ``host_ms`` but for the first launch's latency. ``device_ms`` is the
    device's own time (``device_ms``)."""
    import statistics

    fns = {"": kern, "library_": lib}
    for fn in fns.values():
        for _ in range(3):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    got = {p: ([], []) for p in fns}
    for _ in range(EXCHANGE_ROUNDS):
        for p, fn in fns.items():
            torch.cuda.synchronize()
            start.record()
            t0 = time.perf_counter()
            for _ in range(EXCHANGE_ITERS):
                fn()
            host = time.perf_counter() - t0
            end.record()
            torch.cuda.synchronize()
            got[p][0].append(start.elapsed_time(end) / EXCHANGE_ITERS)
            got[p][1].append(host / EXCHANGE_ITERS * 1e3)
    out = {}
    for p, fn in fns.items():
        out[f"{p}ms"] = statistics.median(got[p][0])
        out[f"{p}host_ms"] = statistics.median(got[p][1])
        out[f"{p}device_ms"], by = device_ms(torch, fn)
        if not p:
            out["device_by"] = by
    return out


def halo_entry(torch, exchange, a, send, what: str) -> dict:
    """``halo_pack`` at one shape: held bitwise against its twin, timed
    beside the twin and ``index_select`` on the transposed leaf (the same
    function), each call split into host and device time; the bound from
    the bytes this page needs (the referenced rows read once, the page
    written once, the index read once) and, beside it, the same with each
    read counted as the 32-byte sectors the referenced rows fall in."""
    got = exchange.halo_pack(a, send)
    want = exchange.halo_pack_plain(a, send)
    if not bits_equal(torch, got, want):
        raise AssertionError(f"halo_pack differs from its twin ({what})")
    send_l = send.long()
    k = a.shape[0]
    row_b = a[0, 0].numel() * a.element_size()
    uniq = torch.unique(send_l)
    sectors = torch.unique(uniq * row_b // 32).numel() \
        if row_b < 32 else 0
    page_b = got.numel() * got.element_size()
    idx_b = send.numel() * 4
    bound_ms, bound_by = bound(k * uniq.numel() * row_b + page_b + idx_b)
    kern = lambda: exchange.halo_pack(a, send)
    lib = lambda: torch.index_select(a.transpose(0, 1), 0, send_l)
    return dict(
        source="raphtory_tpu_torch/csrc/exchange.cu",
        replaces="raphtory_tpu/parallel/sharded.py:704",
        max_abs_err=exact_err(got, want),
        plain_ms=cuda_ms(torch, lambda: exchange.halo_pack_plain(a, send)),
        **paired_ms(torch, kern, lib),
        bound_ms=bound_ms, bound_by=bound_by,
        sector_bound_ms=(bound(k * sectors * 32 + page_b + idx_b)[0]
                         if sectors else bound_ms),
        shape=f"state {tuple(a.shape)} {a.dtype}, S*h {send.shape[0]}, "
              f"{uniq.numel()} rows referenced ({what})")


def merge_entry(torch, exchange, rep, idx, val, counts, what: str) -> dict:
    """``frontier_merge_min`` at one shape: bitwise against its twin,
    timed beside the twin and ``scatter_reduce_`` amin over the live slots,
    host / device split; the bound from the live slots (index and value
    read once, the row they name read and written once) and, beside it,
    the same with the rows counted as the 32-byte sectors they fall in."""
    got, want = rep.clone(), rep.clone()
    exchange.frontier_merge_min(got, idx, val, counts)
    exchange.frontier_merge_min_plain(want, idx, val, counts)
    if not bits_equal(torch, got, want):
        raise AssertionError(f"frontier_merge_min differs from its twin "
                             f"({what})")
    R = counts.shape[0]
    bucket = idx.shape[0] // R
    live = (torch.arange(bucket, device=idx.device)[None, :]
            < counts[:, None]).reshape(-1)
    live_idx, live_val = idx[live], val[live]
    n_live = live_idx.numel()
    row_b = rep[0].numel() * rep.element_size()
    sectors = torch.unique(live_idx * row_b // 32).numel() \
        if row_b < 32 else 0
    slots_b = n_live * (8 + row_b) + R * 8
    work = rep.clone()
    kern = lambda: exchange.frontier_merge_min(work, idx, val, counts)
    lib = lambda: work.scatter_reduce_(0, live_idx, live_val, "amin")
    bound_ms, bound_by = bound(slots_b + 2 * n_live * row_b)
    return dict(
        source="raphtory_tpu_torch/csrc/exchange.cu",
        replaces="raphtory_tpu/parallel/frontier.py:499",
        max_abs_err=exact_err(got, want),
        plain_ms=cuda_ms(torch, lambda: exchange.frontier_merge_min_plain(
            work, idx, val, counts)),
        **paired_ms(torch, kern, lib),
        bound_ms=bound_ms, bound_by=bound_by,
        sector_bound_ms=(bound(slots_b + 2 * sectors * 32)[0]
                         if sectors else bound_ms),
        shape=f"replica {tuple(rep.shape)} {rep.dtype}, R {R} x B "
              f"{bucket}, {n_live} live ({what})")


def compact_entry(torch, exchange, vals, changed, B, ident,
                  what: str) -> dict:
    """``frontier_compact`` at one shape as the sparse route calls it (the
    count-and-compact pass, then the pad): bitwise against its twin and,
    over the set rows, against ``nonzero`` + ``index_select`` (the library
    call, which reads its count back); timed beside the twin, and beside
    the library call in one ``paired_ms`` loop, the count pass included;
    the bound from the bytes (the mask read once, the set rows' values read
    once, the bucket written once) and, beside it, the same with the set
    rows' values counted as the 32-byte sectors they fall in."""
    counted = exchange.frontier_count(changed, vals)
    gi, gv = exchange.frontier_compact(vals, changed, B, ident, counted)
    wi, wv = exchange.frontier_compact_plain(vals, changed, B, ident)
    li = torch.nonzero(changed).reshape(-1)
    lv = torch.index_select(vals, 0, li)
    cnt = li.numel()
    if not (counted.total == cnt and torch.equal(gi, wi)
            and bits_equal(torch, gv, wv) and torch.equal(gi[:cnt], li)
            and bits_equal(torch, gv[:cnt], lv)):
        raise AssertionError(f"frontier_compact differs from its twin or "
                             f"nonzero + index_select ({what})")
    n = changed.shape[0]
    row_b = vals[0].numel() * vals.element_size() if n else 0
    sectors = torch.unique(li * row_b // 32).numel() if row_b < 32 else 0
    out_b = B * (8 + row_b)
    bound_ms, bound_by = bound(n + cnt * row_b + out_b)

    def kern():
        # the count on the host, as the sparse route holds it from the
        # all-gathered counts: the pad's bucket check reads nothing back
        return exchange.frontier_compact(
            vals, changed, B, ident,
            exchange.frontier_count(changed, vals)._replace(host=cnt))

    def lib():
        idx = torch.nonzero(changed).reshape(-1)
        return idx, torch.index_select(vals, 0, idx)

    return dict(
        source="raphtory_tpu_torch/csrc/exchange.cu",
        replaces="raphtory_tpu/parallel/frontier.py:459",
        max_abs_err=max(exact_err(gi, wi), exact_err(gv, wv)),
        plain_ms=cuda_ms(torch, lambda: exchange.frontier_compact_plain(
            vals, changed, B, ident)),
        **paired_ms(torch, kern, lib),
        bound_ms=bound_ms, bound_by=bound_by,
        sector_bound_ms=(bound(n + sectors * 32 + out_b)[0]
                         if sectors else bound_ms),
        shape=f"N {n} {vals.dtype}, {cnt} changed, bucket {B} ({what})")


def exchange_edge_cases(torch, exchange, dev) -> int:
    """``halo_pack``, ``frontier_compact`` and ``frontier_merge_min`` held
    bitwise against their twins on the card in the cases the mesh shapes
    do not reach: every
    word width (16, 8, 4, 2 and 1 bytes), a trailing dimension, rows too
    wide to stage, a leaf that is not 16-byte aligned, pad slots naming
    row n-1, empty pages; int32 / int64 / float32 / float64 merges with a
    trailing dimension, NaN on either side, a slice with count 0, a
    bucket of 0 and strided counts; compactions of count 0 and count N,
    into a bucket of exactly the count, with trailing dimensions, a mask
    that is not 16-byte aligned, back to back, with the count held on the
    host or read back, and past the bucket (which raises). Returns the
    cases checked."""
    from raphtory_tpu_torch.ops.partition import frontier_bucket

    g = torch.Generator(device=dev).manual_seed(5)
    checked = 0

    def leaf(shape, dtype):
        if dtype == torch.bool:
            return torch.rand(shape, generator=g, device=dev) < 0.5
        if dtype.is_floating_point:
            return torch.randn(shape, generator=g, device=dev).to(dtype)
        return torch.randint(-1000, 1000, shape, generator=g, device=dev,
                             dtype=torch.int64).to(dtype)

    for k, n, trail, dtype in ((3, 5000, (), torch.float32),
                               (2, 4096, (), torch.int64),
                               (3, 777, (3,), torch.float64),
                               (4, 1000, (4,), torch.float32),
                               (2, 999, (), torch.float16),
                               (3, 1001, (3,), torch.int8),
                               (1, 500, (), torch.bool),
                               (2, 64, (8192,), torch.float32),
                               (8, 3000, (), torch.int32)):
        a = leaf((k, n) + trail, dtype)
        sh = 4 * 300
        send = torch.randint(0, n, (sh,), generator=g, device=dev,
                             dtype=torch.int32)
        send[-17:] = n - 1                     # pad slots
        for src in (a, torch.cat([a.reshape(-1)[:1], a.reshape(-1)])[1:]
                    .reshape(a.shape)):        # aligned, then offset
            if not bits_equal(torch, exchange.halo_pack(src, send),
                              exchange.halo_pack_plain(src, send)):
                raise AssertionError(f"halo_pack differs from its twin: k "
                                     f"{k}, n {n}, trail {trail}, {dtype}")
            checked += 1
    empty = exchange.halo_pack(leaf((3, 10), torch.float32),
                               torch.zeros(0, dtype=torch.int32, device=dev))
    if empty.shape != (0, 3):
        raise AssertionError("halo_pack of an empty page")
    checked += 1

    for dtype, trail in ((torch.int32, ()), (torch.float32, ()),
                         (torch.float64, (3,)), (torch.int64, (2,)),
                         (torch.float32, (40,))):
        N, R, B = 6000, 4, 700
        rep = leaf((N,) + trail, dtype)
        owner = torch.randint(0, R, (N,), generator=g, device=dev)
        counts = torch.zeros(R, 2, dtype=torch.int64, device=dev)
        idx = torch.zeros(R, B, dtype=torch.int64, device=dev)
        val = leaf((R, B) + trail, dtype)
        for r in range(R):
            rows = torch.nonzero(owner == r).reshape(-1)[:B if r else 0]
            counts[r, 0] = rows.numel()         # slice 0: count 0
            idx[r, :rows.numel()] = rows
        if dtype.is_floating_point:
            rep[::7] = float("nan")             # NaN in the replica
            val[1, ::5] = float("nan")          # and in the slices
        for cnt in (counts[:, 0], counts[:, 0].contiguous()):
            got, want = rep.clone(), rep.clone()
            exchange.frontier_merge_min(got, idx.reshape(-1),
                                        val.reshape((-1,) + trail), cnt)
            exchange.frontier_merge_min_plain(want, idx.reshape(-1),
                                              val.reshape((-1,) + trail),
                                              cnt)
            if not bits_equal(torch, got, want):
                raise AssertionError(f"frontier_merge_min differs from its "
                                     f"twin: {dtype}, trail {trail}")
            checked += 1
    # the compaction: count 0, count N, a bucket of exactly the count,
    # trailing dimensions, a mask off 16 bytes (the flags' byte loads), and
    # two calls back to back on one scratch (a new epoch each)
    for n, trail, dtype, density, offset in (
            (98_304, (), torch.int32, 0.0, 0),
            (98_304, (), torch.int32, 1.0, 0),
            (100_003, (3,), torch.float32, 0.3, 1),
            (4_097, (2,), torch.int64, 0.5, 0),
            (77_777, (), torch.float64, 0.05, 7)):
        ch = (torch.rand(n + offset, generator=g, device=dev)
              < density)[offset:]
        vals = leaf((n,) + trail, dtype)
        ident = exchange.min_identity(dtype)
        cnt = int(ch.sum())
        for B in (cnt, frontier_bucket(cnt, cap=n)):
            for host in (None, cnt):
                got = exchange.frontier_compact(
                    vals, ch, B, ident, exchange.frontier_count(
                        ch, vals)._replace(host=host))
                want = exchange.frontier_compact_plain(vals, ch, B, ident)
                if not (torch.equal(got[0], want[0])
                        and bits_equal(torch, got[1], want[1])):
                    raise AssertionError(
                        f"frontier_compact differs from its twin: N {n}, "
                        f"trail {trail}, {dtype}, {cnt} set, bucket {B}")
                checked += 1
        # more set rows than the bucket holds: raises, the count read back
        # or held on the host
        for host in ((None, cnt) if cnt else ()):
            try:
                exchange.frontier_compact(
                    vals, ch, cnt - 1, ident, exchange.frontier_count(
                        ch, vals)._replace(host=host))
            except ValueError as e:
                if "> bucket" not in str(e):
                    raise
            else:
                raise AssertionError(f"frontier_compact took {cnt} set rows "
                                     f"into a bucket of {cnt - 1}")
            checked += 1
    rep = leaf((100,), torch.int32)
    got = rep.clone()
    exchange.frontier_merge_min(
        got, torch.zeros(0, dtype=torch.int64, device=dev),
        torch.zeros(0, dtype=torch.int32, device=dev),
        torch.zeros(4, dtype=torch.int64, device=dev))   # a bucket of 0
    if not torch.equal(got, rep):
        raise AssertionError("frontier_merge_min changed the replica with a "
                             "bucket of 0")
    torch.cuda.synchronize()
    return checked + 1


#: the scale_bulk graph (``bench.py:bench_scale_pagerank``) with its
#: vertex state sharded over 4 ranks: the deployment shape of the mesh
#: kernels
DEPLOY = dict(n_vertices=5_300_000, n_edges=1 << 25, seed=11, n_pad=5_308_416,
              ranks=4, windows=8)


def deploy_halo_page(np):
    """Rank 0's halo send page for the scale_bulk edge list on 4 vertex
    shards: the dst-partitioned blocks' source references through
    ``sharded._build_halo``, as ``partition_view`` builds them (pads name
    row n_pad - 1). Returns ``(page int32 [S*h], h, seconds)``."""
    from raphtory_tpu_torch.parallel import sharded
    from raphtory_tpu_torch.utils.synth import gab_like_arrays

    t0 = time.perf_counter()
    src, dst, _ = gab_like_arrays(DEPLOY["n_vertices"], DEPLOY["n_edges"],
                                  seed=DEPLOY["seed"])
    S, n_pad = DEPLOY["ranks"], DEPLOY["n_pad"]
    n_loc = n_pad // S
    owner = dst // n_loc
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=S)
    idx_g = np.full((S, sharded._pow2(int(counts.max()))), n_pad - 1,
                    np.int32)
    off = 0
    for sh in range(S):
        c = int(counts[sh])
        idx_g[sh, :c] = src[order[off:off + c]]
        off += c
    del src, dst, order
    h, _, send, _ = sharded._build_halo(idx_g, n_loc, S)
    return send[0], h, time.perf_counter() - t0


def deploy_merge(torch, np, exchange, density: float, dev):
    """A CC replica of k * n_pad int32 rows and R = 4 gathered slices, each
    rank's slice the ascending flat indices of about ``density`` of the
    rows it owns (its vertex block in every window), as
    ``frontier_compact`` writes them, in a bucket of
    ``frontier_bucket(max count)`` slots."""
    from raphtory_tpu_torch.ops.partition import frontier_bucket

    k, n_pad, R = DEPLOY["windows"], DEPLOY["n_pad"], DEPLOY["ranks"]
    n_loc = n_pad // R
    g = torch.Generator(device=dev).manual_seed(int(density * 1000))
    rep = torch.randint(0, 1 << 30, (k * n_pad,), generator=g, device=dev,
                        dtype=torch.int32)
    rows = []
    for r in range(R):
        kk, i = torch.nonzero(torch.rand(k, n_loc, generator=g, device=dev)
                              < density, as_tuple=True)
        rows.append(kk * n_pad + r * n_loc + i)
    counts = torch.tensor([x.numel() for x in rows], dtype=torch.int64,
                          device=dev)
    B = frontier_bucket(int(counts.max()), cap=k * n_pad)
    idx = torch.zeros(R, B, dtype=torch.int64, device=dev)
    val = torch.full((R, B), exchange.min_identity(torch.int32),
                     dtype=torch.int32, device=dev)
    for r, x in enumerate(rows):
        idx[r, :x.numel()] = x
        val[r, :x.numel()] = torch.randint(0, 1 << 30, (x.numel(),),
                                           generator=g, device=dev,
                                           dtype=torch.int32)
    return rep, idx.reshape(-1), val.reshape(-1), counts


def deploy_compact(torch, exchange, density: float, dev):
    """A rank's CC state at the deployment shape, as the sparse route
    compacts it: ``k * n_loc`` = 8 x 1,327,104 int32 rows, about
    ``density`` of them changed, into a bucket of ``frontier_bucket(count,
    cap=N)`` slots. Returns ``(values, changed, bucket, identity)``."""
    from raphtory_tpu_torch.ops.partition import frontier_bucket

    N = DEPLOY["windows"] * (DEPLOY["n_pad"] // DEPLOY["ranks"])
    g = torch.Generator(device=dev).manual_seed(int(density * 1000) + 1)
    vals = torch.randint(0, 1 << 30, (N,), generator=g, device=dev,
                         dtype=torch.int32)
    changed = torch.rand(N, generator=g, device=dev) < density
    return (vals, changed, frontier_bucket(int(changed.sum()), cap=N),
            exchange.min_identity(torch.int32))


def mesh_kernels(torch, np, samples, dev):
    """``halo_pack``, ``frontier_compact`` and ``frontier_merge_min`` at
    the largest inputs rank 0 gave them in ``mesh_ranks``, against their
    twins (bitwise) and one library call each, and at the deployment shape
    (``DEPLOY``), with each call split into host and device time, and in
    their edge cases.
    Returns ``(kernel entries, the deployment entries, edge cases
    checked, page build seconds)``."""
    from raphtory_tpu_torch.ops import exchange

    if set(samples) != {"halo_pack", "frontier_compact",
                        "frontier_merge_min"}:
        raise AssertionError(f"mesh_ranks kept samples of {sorted(samples)}")
    out = {}
    a, send = (t.to(dev) for t in samples["halo_pack"][1])
    out["halo_pack"] = halo_entry(torch, exchange, a, send, "mesh path")
    vals, changed, B, ident = samples["frontier_compact"][1]
    out["frontier_compact"] = compact_entry(
        torch, exchange, vals.to(dev), changed.to(dev), B, ident,
        "mesh path")
    rep, idx, val, counts = (t.to(dev) for t in
                             samples["frontier_merge_min"][1])
    out["frontier_merge_min"] = merge_entry(torch, exchange, rep, idx, val,
                                            counts, "mesh path")
    checked = exchange_edge_cases(torch, exchange, dev)

    page, h, page_s = deploy_halo_page(np)
    k, n_loc = DEPLOY["windows"], DEPLOY["n_pad"] // DEPLOY["ranks"]
    leaf = torch.randn(k, n_loc, generator=torch.Generator(device=dev)
                       .manual_seed(11), device=dev)
    deploy = {"halo_pack": halo_entry(torch, exchange, leaf,
                                      torch.from_numpy(page).to(dev),
                                      f"scale_bulk on 4 ranks, h {h}")}
    del leaf
    for density in (0.01, 0.20):
        args = deploy_merge(torch, np, exchange, density, dev)
        deploy[f"frontier_merge_min_{int(density * 100)}pct"] = merge_entry(
            torch, exchange, *args,
            f"scale_bulk CC replica on 4 ranks, {density:.0%} live")
        args = deploy_compact(torch, exchange, density, dev)
        deploy[f"frontier_compact_{int(density * 100)}pct"] = compact_entry(
            torch, exchange, *args,
            f"a rank's scale_bulk CC state, {density:.0%} changed")
        del args
    torch.cuda.empty_cache()
    return out, deploy, checked, page_s


def phase_mesh_ranks(torch, np, columns, log, one, dev):
    """4 ranks on the card under gloo, one spawned group: K11 over
    all_gather / halo / sparse, the K11 sweep and K12, each against the
    single-device port on the card (and ``mesh_one``'s K12 vectors); the
    mesh kernels against their twins at the ranks' inputs. Returns
    ``(launches, kernel entries)``."""
    from raphtory_tpu_torch.algorithms import BFS, ConnectedComponents
    from raphtory_tpu_torch.algorithms import PageRank
    from raphtory_tpu_torch.cluster.bootstrap import spawn
    from raphtory_tpu_torch.core.snapshot import build_view
    from raphtory_tpu_torch.engine import bsp
    from raphtory_tpu_torch.engine.device_sweep import DeviceSweep
    from raphtory_tpu_torch.utils.synth import (bitcoin_like_log,
                                                zipf_hub_log, zipf_hubs)

    hops, _ = headline_grid()
    T = int(0.90 * GAB_SPAN)
    hubs = zipf_hubs(**ZIPF)
    progs = {"pagerank": PageRank(max_steps=20, tol=1e-7),
             "cc": ConnectedComponents(max_steps=50),
             "bfs": BFS(seeds=hubs, directed=False)}

    import dataclasses

    def spec(name):
        p = progs[name]
        return (type(p).__name__, dataclasses.asdict(p))

    cases = ([("gab", "pagerank", m, c) for m in ((2, 2), (4, 1))
              for c in ("all_gather", "halo")]
             + [("gab", "cc", (4, 1), c)
                for c in ("all_gather", "halo", "sparse")]
             + [("zipf", p, (4, 1), c) for p in ("cc", "bfs")
                for c in ("all_gather", "sparse")])
    def case_req(case):
        lg, p, m, c = case
        return dict(op="sharded", log=lg, program=spec(p), mesh=m, comm=c,
                    T=T if lg == "gab" else ZIPF_T,
                    windows=WINDOWS if lg == "gab" else ZIPF_WINDOWS)

    reqs = [case_req(c) for c in cases]
    reqs.append(dict(op="sweep", log="gab", times=hops,
                     program=spec("pagerank"), mesh=(4, 1),
                     windows=WINDOWS))
    for kind, params in (("pagerank", dict(tol=1e-7, max_steps=20)),
                         ("cc", dict(max_steps=50))):
        reqs.append(dict(op="columns", log="gab", kind=kind, hops=hops,
                         windows=WINDOWS, mesh=(4, 1), params=params))
    n_timed = len(reqs)
    # measuring replays after the timed requests, so that neither the
    # kernels' input copies (sample) nor the syncs around each collective
    # (collectives) reach a timed dispatch
    replays = ([(c, dict(sample=True)) for c in
                (("gab", "pagerank", (2, 2), "halo"),
                 ("gab", "cc", (4, 1), "sparse"))]
               + [(c, dict(collectives=True)) for c in
                  (("gab", "pagerank", (4, 1), "all_gather"),
                   ("gab", "pagerank", (4, 1), "halo"),
                   ("gab", "cc", (4, 1), "all_gather"),
                   ("gab", "cc", (4, 1), "sparse"))])
    reqs += [dict(case_req(c), **flags) for c, flags in replays]
    # TaintTracking over the occurrence partition: (mesh, comm, windowed)
    btc_kw = dict(n_addresses=20_000, n_txs=200_000, t_span=BTC_SPAN)
    btc = bitcoin_like_log(**btc_kw)
    taint = taint_program(np, btc, BTC_SPAN // 2)
    taint_cases = [((4, 1), "all_gather", False), ((4, 1), "halo", True),
                   ((2, 2), "all_gather", True), ((2, 2), "halo", False)]
    reqs += [dict(op="sharded", log="btc", program=(
        "TaintTracking", dataclasses.asdict(taint)), mesh=m, comm=c,
        T=BTC_SPAN, **({"windows": BTC_WINDOWS} if windowed else {}))
        for m, c, windowed in taint_cases]
    logs = {"gab": {"synth": "gab_like_log",
                    "kwargs": dict(n_vertices=30_000, n_edges=300_000,
                                   t_span=GAB_SPAN)},
            "zipf": {"synth": "zipf_hub_log", "kwargs": ZIPF},
            "btc": {"synth": "bitcoin_like_log", "kwargs": btc_kw}}
    t0 = time.perf_counter()
    out = spawn(MESH_TARGET, 4, ({"logs": logs, "requests": reqs},),
                timeout=480, device="cuda", share_card=True)
    spawn_s = time.perf_counter() - t0
    res = out[0]["results"]
    for other in out[1:]:
        for a, b in zip(res, other["results"]):
            for key in ("result", "hops"):
                if key in a and not _same_tree(np, a[key], b[key]):
                    raise AssertionError("mesh_ranks: the ranks disagree")

    # the single-device port on the card
    gab_view = build_view(log, T)
    zipf_view = build_view(zipf_hub_log(**ZIPF), ZIPF_T)
    refs = {}
    report = []
    for (lg, p, m, c), r in zip(cases, res):
        view, windows = ((gab_view, WINDOWS) if lg == "gab"
                         else (zipf_view, ZIPF_WINDOWS))
        if (lg, p) not in refs:
            want, ws = bsp.run(progs[p], view, windows=windows, device=dev)
            refs[(lg, p)] = (want.cpu(), ws)
        want, ws = refs[(lg, p)]
        got = torch.from_numpy(r["result"])
        ok = (within_tol(got, want) if p == "pagerank"
              else torch.equal(got, want))
        if not ok or r["steps"] != ws:
            raise AssertionError(f"mesh_ranks {lg} {p} {m} {c} differs from "
                                 f"bsp.run on the card (steps {r['steps']} "
                                 f"vs {ws})")
        report.append(dict(log=lg, program=p, mesh=f"{m[1]}x{m[0]}",
                           shards=m[0], window_groups=m[1],
                           route=c, steps=r["steps"],
                           seconds=r["seconds"], routes=r["routes"],
                           launches=r["launches"]))
    sweep_r, pr_cols, cc_cols = res[len(cases):n_timed]
    btc_view = build_view(btc, BTC_SPAN, include_occurrences=True)
    taint_report = []
    for (m, c, windowed), r in zip(taint_cases, res[-len(taint_cases):]):
        kw = {"windows": BTC_WINDOWS} if windowed else {}
        want, ws = bsp.run(taint, btc_view, device=dev, **kw)
        if r["steps"] != ws or not torch.equal(
                torch.from_numpy(r["result"]), want.cpu()):
            raise AssertionError(f"mesh_ranks taint {m} {c} windowed="
                                 f"{windowed} differs from bsp.run on the "
                                 f"card (steps {r['steps']} vs {ws})")
        ks = ("segment_combine_i64", "segment_combine")
        check_launched(f"mesh_ranks taint {m} {c}",
                       {k: r["launches"].get(k, 0) for k in ks}, ks)
        taint_report.append(dict(
            mesh=f"{m[1]}x{m[0]}", route=c, windowed=windowed,
            steps=r["steps"], seconds=r["seconds"],
            tainted=[int(v) for v in np.atleast_2d(
                r["result"] < IMAX).sum(axis=1)],
            launches={k: r["launches"].get(k, 0) for k in (
                "segment_combine_i64", "segment_combine", "halo_pack")}))
    replay_report = []
    for (case, flags), r in zip(replays, res[n_timed:]):
        timed = res[cases.index(case)]
        if r["steps"] != timed["steps"] or not np.array_equal(
                r["result"], timed["result"]):
            raise AssertionError(f"mesh_ranks replay of {case} differs "
                                 "from its timed run")
        if flags.get("collectives"):
            lg, p, m, c = case
            replay_report.append(dict(
                log=lg, program=p, mesh=f"{m[1]}x{m[0]}", route=c,
                timed_seconds=timed["seconds"], seconds=r["seconds"],
                collectives={k: dict(calls=v[0], seconds=v[1])
                             for k, v in r["collectives"].items()}))
    ds = DeviceSweep(log, device=dev)
    want_sw, want_steps = ds.run_sweep(progs["pagerank"], hops,
                                       windows=WINDOWS)
    for j, hop in enumerate(sweep_r["hops"]):
        if hop["steps"] != want_steps[j] or not within_tol(
                torch.from_numpy(hop["result"]), want_sw[j].cpu()):
            raise AssertionError(f"mesh_ranks ShardedSweep hop {j} differs "
                                 "from DeviceSweep on the card")
    one_pr, one_pr_steps = one["pagerank"]
    if pr_cols["steps"] != one_pr_steps or not within_tol(
            torch.from_numpy(pr_cols["result"]), one_pr.cpu()):
        raise AssertionError("mesh_ranks K12 PageRank differs from mesh_one")
    from raphtory_tpu_torch.engine import hopbatch

    hb = hopbatch.HopBatchedCC(log, max_steps=50, device=dev)
    _, cols = hb._fold_columns(hops)
    want_cc, s_cc = hopbatch.run_cc_columns(hb.tables, *cols, hops, WINDOWS,
                                            max_steps=50, device=dev)
    if cc_cols["steps"] != s_cc or not torch.equal(
            torch.from_numpy(cc_cols["result"]), want_cc.cpu()):
        raise AssertionError("mesh_ranks K12 CC differs from run_cc_columns")
    month = torch.from_numpy(cc_cols["result"][::len(WINDOWS)])
    if not torch.equal(month, one["cc_month"][0].cpu()):
        raise AssertionError("mesh_ranks K12 CC month differs from mesh_one")

    launches = {k: 0 for k in ("halo_pack", "frontier_compact",
                               "frontier_merge_min")}
    for r in res[:n_timed]:
        for k in launches:
            launches[k] += r["launches"].get(k, 0)
    check_launched("mesh_ranks", launches, tuple(launches))
    for r, ks in ((pr_cols, ("column_masks", "column_pull_sum",
                             "pagerank_update")),
                  (cc_cols, ("column_masks", "cc_superstep")),
                  *((r, ("segment_combine",)) for r in res[:len(cases)]),
                  (sweep_r, ("segment_combine",))):
        check_launched("mesh_ranks", {k: r["launches"].get(k, 0)
                                      for k in ks}, ks)
    entries, deploy, edge_cases, page_s = mesh_kernels(
        torch, np, out[0]["samples"], dev)
    emit("mesh_ranks", ranks=4, backend="gloo", share_card=True,
         staged=out[0]["staged"], spawn_s=spawn_s, runs=report,
         collective_replays=replay_report, taint=taint_report,
         sweep=dict(hops=len(hops), steps=[h["steps"] for h in
                                           sweep_r["hops"]],
                    seconds=sweep_r["seconds"], routes=sweep_r["routes"]),
         columns={k: dict(steps=r["steps"], seconds=r["seconds"],
                          launches=r["launches"])
                  for k, r in (("pagerank", pr_cols), ("cc", cc_cols))},
         launches=launches,
         kernels={k: {kk: v[kk] for kk in SPLIT_KEYS if kk in v}
                  for k, v in entries.items()},
         deploy={k: {kk: v[kk] for kk in SPLIT_KEYS}
                 for k, v in deploy.items()},
         deploy_page_build_s=page_s, edge_cases_bitwise=edge_cases)
    return launches, entries, dict(
        runs=report, columns={k: dict(launches=r["launches"], columns=len(
            hops) * len(WINDOWS) // 4, routes=r["routes"],
            seconds=r["seconds"]) for k, r in (("pagerank", pr_cols),
                                               ("cc", cc_cols))})


#: the mesh path's own kernels
MESH_KERNELS = ("halo_pack", "frontier_compact", "frontier_merge_min")
#: what the mesh_ranks line reports of each exchange kernel
SPLIT_KEYS = ("ms", "plain_ms", "library_ms", "host_ms", "device_ms",
              "device_by", "library_host_ms", "library_device_ms",
              "bound_ms", "sector_bound_ms", "shape")


def program_bounds(np, log, kernels, mesh) -> dict:
    """Bounds of the mesh programs (K11 ``_sharded_runner``, K13 the
    sparse route, K12 ``run_columns_sharded``): for each timed GAB
    dispatch of ``mesh_ranks``, the sum over the kernels rank 0 launched
    of launches times one launch's byte bound, with the bytes the
    dispatch's collectives moved beside it (``COLLECTIVES``). One launch's
    bound: ``segment_combine`` (K7) from rank 0's shard of the View (k
    windows of the shard's real edges: payload and mask read, the CSR
    read, the k x n_loc result written; the mean of the dst- and
    src-partitioned shards); the exchange kernels at the largest inputs
    rank 0 gave them (the kernels line); K12's per-rank K3 / K2 / K5 from
    the kernels line scaled by the rank's columns over the entry's."""
    from raphtory_tpu_torch.core.snapshot import build_view
    from raphtory_tpu_torch.parallel import sharded

    view = build_view(log, int(0.90 * GAB_SPAN))
    shards = {}
    for S in sorted({r["shards"] for r in mesh["runs"]}):
        sv = sharded.partition_view(view, S)
        shards[S] = (int(sv.d_count[0]), int(sv.s_count[0]), sv.n_loc)

    def k7_ms(S, k):
        m_d, m_s, n_loc = shards[S]
        return float(np.mean([bound(k * m * 5 + (n_loc + 1) * 8
                                    + k * n_loc * 4)[0]
                              for m in (m_d, m_s)]))

    out = {"dispatches": [], "columns": {}}
    for r in mesh["runs"]:
        if r["log"] != "gab":
            continue
        k = -(-len(WINDOWS) // r["window_groups"])
        per = {name: (k7_ms(r["shards"], k) if name == "segment_combine"
                      else kernels[name]["bound_ms"])
               for name, n in r["launches"].items() if n and (
                   name == "segment_combine" or name in MESH_KERNELS)}
        # frontier_compact counts 2 launches a superstep, whose bound is
        # one entry's: the count-and-compact pass and the pad
        runs = {name: (r["launches"][name] // 2 if name == "frontier_compact"
                       else r["launches"][name]) for name in per}
        out["dispatches"].append(dict(
            program=r["program"], mesh=r["mesh"], route=r["route"],
            bound_ms=sum(runs[name] * per[name] for name in per),
            launches={name: r["launches"][name] for name in per},
            collective_bytes=sum(v.get("bytes", 0)
                                 for v in r["routes"].values()),
            seconds=r["seconds"]))
    for kind, c in mesh["columns"].items():
        per = {}
        for name, n in c["launches"].items():
            if not n:
                continue
            if "columns" not in kernels.get(name, {}):
                raise KeyError(f"program_bounds: K12 {kind} launched {name}, "
                               "which has no column kernel entry to bound")
            per[name] = (kernels[name]["bound_ms"] * c["columns"]
                         / kernels[name]["columns"])
        out["columns"][kind] = dict(
            bound_ms=sum(c["launches"][name] * per[name] for name in per),
            launches={name: c["launches"][name] for name in per},
            columns_a_rank=c["columns"],
            collective_bytes=sum(v.get("bytes", 0)
                                 for v in c["routes"].values()),
            seconds=c["seconds"])
    return out


def _same_tree(np, a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(np, a[k], b[k])
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same_tree(np, x, y)
                                        for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    # the phases of the earlier slices measure the unbinned route they
    # always measured; the pcpm phase (and scale_bulk's binned part) unset
    # the knob, the JAX package's default
    os.environ["RTPU_PCPM"] = "0"
    # and their jobs take their own routes, as before the serving
    # scheduler: only the serve phase opens a coalescing window
    os.environ["RTPU_BATCH_WINDOW_MS"] = "0"

    from raphtory_tpu_torch.core.snapshot import build_view
    from raphtory_tpu_torch.engine.hopbatch import HopBatchedPageRank
    from raphtory_tpu_torch.ops import columns, minplus, resident, segment
    from raphtory_tpu_torch.utils.synth import bitcoin_like_log, gab_like_log

    global PARENT
    args = sys.argv[1:]
    if args[:1] == ["--parent"] and len(args) == 2:
        PARENT = Parent(columns, args[1])
    elif args:
        print("usage: chip_smoke.py [--parent DIR]", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    global PAST_CAP_CPU
    PAST_CAP_CPU = start_past_cap_cpu()
    try:
        return run_phases(torch, np, columns, minplus, resident, segment,
                          build_view, HopBatchedPageRank, bitcoin_like_log,
                          gab_like_log, dev)
    finally:
        if PAST_CAP_CPU.poll() is None:
            PAST_CAP_CPU.kill()
            PAST_CAP_CPU.wait()


def run_phases(torch, np, columns, minplus, resident, segment, build_view,
               HopBatchedPageRank, bitcoin_like_log, gab_like_log, dev):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t_main = time.perf_counter()
    build_s = columns.build()
    emit("build", seconds=build_s, ptxas={
        k: [ln.strip() for ln in v.splitlines()
            if "registers" in ln or "error" in ln.lower()]
        for k, v in columns.BUILD_LOG.items()})

    log = gab_like_log(n_vertices=30_000, n_edges=300_000, t_span=GAB_SPAN)
    tables = HopBatchedPageRank(log, device=dev).tables
    ldbc = ldbc_log()
    ldbc_tables = HopBatchedPageRank(ldbc, device=dev).tables
    btc_tables = HopBatchedPageRank(bitcoin_like_log(
        n_addresses=20_000, n_txs=200_000, t_span=BTC_SPAN),
        device=dev).tables
    ldbc_view = build_view(ldbc, int(0.9 * LDBC_SPAN))
    gab_view = build_view(log, int(0.90 * GAB_SPAN))
    PHASE_S["build_and_tables"] = time.perf_counter() - t_main
    t0 = time.perf_counter()
    kernels = phase_kernels(torch, np, columns, tables, dev)
    kernels.update(minplus_kernels(torch, np, columns, minplus, tables,
                                   ldbc_tables, dev))
    # the cold Views K8u serves: view_programs' LDBC Views (2 windows), the
    # GAB View of lpa and pcpm (3), the taint View's occurrence rows (3)
    kernels.update(segment_kernels(
        torch, np, segment, resident, tables, btc_tables,
        {"ldbc": (2, ldbc_view.n_pad, ldbc_view.m_pad),
         "gab": (3, gab_view.n_pad, gab_view.m_pad),
         "taint": (len(TAINT_WINDOWS), 1 << 21, 1 << 23)}, dev))
    kernels.update(mask_kernels(torch, np, columns, tables, ldbc_tables,
                                dev))
    PHASE_S["kernels"] = time.perf_counter() - t0
    kernels.update(timed("pcpm_kernels", pcpm_kernels, torch, np, columns,
                         minplus, segment, tables, ldbc_tables, gab_view,
                         dev))
    emit("kernels", kernels={k: {kk: vv for kk, vv in v.items()
                                 if kk in ("ms", "device_ms", "plain_ms",
                                           "library_ms", "bound_ms",
                                           "max_abs_err", "shape", "calls",
                                           "edge_cases", "grid_split",
                                           "upload_and_call_ms")}
                             for k, v in kernels.items()})
    launches = timed("headline", phase_headline, torch, np, columns,
                     HopBatchedPageRank, log, dev)
    cc_launches = timed("cc_range", phase_cc_range, torch, np, columns, log,
                        dev)
    ldbc_launches = timed("ldbc_traversal", phase_ldbc_traversal, torch, np,
                          columns, ldbc, dev)
    # each kernel's launches on the path that runs it
    launches["cc_superstep"] = cc_launches["cc_superstep"]
    for k in ("minplus_superstep", "weights_from_deltas"):
        launches[k] = ldbc_launches[k]
    host_launches = timed("host_columns", phase_host_columns, torch, np,
                          columns, log, ldbc, dev)
    launches["column_masks"] = host_launches["column_masks"]
    timed("fold_pipeline", phase_fold_pipeline, torch, np, columns, log,
          ldbc, dev)
    job_launches = timed("job", phase_job, torch, np, columns, dev)
    view_launches = timed("gab_pr_view", phase_gab_pr_view, torch, np,
                          columns, log, dev)
    for k in RESIDENT_KERNELS:
        launches[k] = view_launches[k]
    # K9a's and K9b's launches on the path that runs them most: the
    # past-cap job, one of each a hop
    for k in ("apply_delta_chunk", "window_masks"):
        launches[k] = job_launches[k]
    btc_launches, out_degree_calls = timed(
        "bitcoin_range", phase_bitcoin_range, torch, np, columns, dev)
    # K7's launches on the path that runs it most (96 f32 + 20 int32, k 3)
    launches["segment_combine"] = btc_launches["segment_combine"]
    launches["segment_combine_out_degree"] = out_degree_calls
    cold_launches = timed("view_programs", phase_view_programs, torch, np,
                          columns, ldbc, dev)
    launches["unpack_mask_bits"] = cold_launches["unpack_mask_bits"]
    launches.update(timed("pcpm", phase_pcpm, torch, np, columns, log, ldbc,
                          dev))
    bulk_launches, bulk_errs, _, pcpm_errs = timed(
        "scale_bulk", phase_scale_bulk, torch, np, columns, dev)
    launches["scale_hop_masks"] = bulk_launches["scale_hop_masks"]
    for k, err in {**bulk_errs, **pcpm_errs}.items():
        kernels[k]["max_abs_err"] = max(kernels[k]["max_abs_err"], err)
    timed("scale", phase_scale, torch, np, columns, HopBatchedPageRank, dev)
    # slice 6: K10 at the scale shape, K10-P on the GAB log, LPA / K7-mode
    feat_launches, feat_entries = timed("features", phase_features, torch,
                                        np, columns, dev)
    kernels.update(feat_entries)
    gab_launches = timed("features_gab", phase_features_gab, torch, np,
                         columns, log, dev)
    lpa_launches, kernels["segment_mode"] = timed(
        "lpa", phase_lpa, torch, np, columns, segment, log, ldbc, dev)
    # each feature kernel's launches on the path that runs it: the scale
    # path's own route, the other one from the GAB runs
    for k in ("feature_propagate", "feature_propagate_binned"):
        launches[k] = feat_launches[k] or gab_launches[k]
    launches["segment_mode"] = lpa_launches["segment_mode"]
    # TaintTracking over the occurrence rows: K7 / K7-P on int64
    taint_launches, taint_entries = timed("taint", phase_taint, torch, np,
                                          columns, segment, dev)
    kernels.update(taint_entries)
    launches.update(taint_launches)
    # slice 20: the live path, the resident route's repin, the five
    # programs
    timed("transfer", phase_transfer, torch, np, dev)
    timed("live", phase_live, torch, np, columns, log, ldbc, dev)
    timed("repin_view", phase_repin_view, torch, np, columns, log, dev)
    timed("programs", phase_programs, torch, np, columns, log, ldbc, dev)
    # the REST serving stack, its scheduler's coalesced batches
    timed("serve", phase_serve, torch, np, columns, log, ldbc, dev)
    # slice 7: the mesh path, one rank then 4 ranks on the card
    one = timed("mesh_one", phase_mesh_one, torch, np, columns, log, dev)
    mesh_launches, mesh_entries, mesh = timed(
        "mesh_ranks", phase_mesh_ranks, torch, np, columns, log, one, dev)
    kernels.update(mesh_entries)
    launches.update(mesh_launches)
    if PARENT is not None:
        emit("parent", source=PARENT.source, entries=PARENT_MS)
    emit("program_bounds", **program_bounds(np, log, kernels, mesh))
    # the binned route's share: its kernel checks, the pcpm phase, and the
    # binned parts inside scale_bulk (layout build included)
    pcpm_s = sum(PHASE_S[k] for k in ("pcpm_kernels", "pcpm",
                                      "scale_bulk_pcpm",
                                      "scale_bulk_crosscheck_pcpm"))
    emit("timing", seconds=PHASE_S, pcpm_share_s=pcpm_s,
         total_s=time.perf_counter() - t_main)

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
