"""Amortised range sweeps on a mesh — a static partition, O(delta) hops.

Port of ``raphtory_tpu/parallel/sweep.py``. The sweep works in the GLOBAL
dense space (every vertex and pair the pinned log ever mentions, positions
fixed — ``engine/device_sweep.GlobalTables``), so the partition layout and
halo exchange structure are STATIC across the sweep: ``advance`` folds a
hop on the host (``SweepBuilder``) and patches only the delta's fold state
(alive, latest and first times) into the per-shard blocks at their static
slots, and ``run`` dispatches K11 (``sharded.run``) over the static
partition. Results are in the global dense vertex space (row i is
``tables.uv[i]``), like ``DeviceSweep``.

Supports the programs ``DeviceSweep`` does (``device_sweep.supported``):
no occurrences, no host-materialised properties.
"""

from __future__ import annotations

import numpy as np

from ..core.events import EventLog
from ..core.snapshot import INT64_MIN
from ..core.sweep import SweepBuilder
from ..engine.device_sweep import GlobalTables, supported
from . import sharded
from .sharded import ShardedView, _build_halo, _pow2


class ShardedSweep:
    """Ascending-time range sweep over a mesh with a static partition of
    ``n_shards`` vertex shards. ``ValueError`` when they do not divide the
    padded global vertex count."""

    def __init__(self, log: EventLog, n_shards: int):
        self.sw = SweepBuilder(log, track_rows=False, preseed_pairs=True)
        self.t = GlobalTables(self.sw)
        t = self.t
        if t.n_pad % n_shards:
            raise ValueError(
                f"vertex shards ({n_shards}) must divide the padded global "
                f"vertex count ({t.n_pad})")
        S = self.S = n_shards
        n_loc = self.n_loc = t.n_pad // n_shards

        def build(owner_of, local_of, global_of):
            owner = owner_of[: t.m] // n_loc
            order = np.lexsort((local_of[: t.m], owner))
            counts = np.bincount(owner, minlength=S)
            m_loc = _pow2(int(counts.max()) if t.m else 0)
            idx_g = np.full((S, m_loc), t.n_pad - 1, np.int32)
            idx_l = np.full((S, m_loc), n_loc - 1, np.int32)
            shard_of = np.empty(t.m, np.int32)   # engine pos -> (shard, slot)
            slot_of = np.empty(t.m, np.int32)
            off = 0
            for sh in range(S):
                c = int(counts[sh])
                rows = order[off: off + c]       # engine positions, sorted
                off += c
                idx_g[sh, :c] = global_of[rows]
                idx_l[sh, :c] = owner_of[rows] - sh * n_loc
                shard_of[rows] = sh
                slot_of[rows] = np.arange(c, dtype=np.int32)
            return m_loc, idx_g, idx_l, shard_of, slot_of, counts

        esrc = t.e_src.astype(np.int64)
        edst = t.e_dst.astype(np.int64)
        m_d, d_src_g, d_dst_l, self._d_shard, self._d_slot, d_count = build(
            edst, edst % n_loc, esrc)
        m_s, s_dst_g, s_src_l, self._s_shard, self._s_slot, s_count = build(
            esrc, esrc % n_loc, edst)
        h_d, d_src_h, d_send, halo_d = _build_halo(d_src_g, n_loc, S)
        h_s, s_dst_h, s_send, halo_s = _build_halo(s_dst_g, n_loc, S)

        skew = sharded.shard_skew(
            edges_dst=np.bincount(self._d_shard, minlength=S),
            edges_src=np.bincount(self._s_shard, minlength=S),
            halo_dst=halo_d, halo_src=halo_s)
        sharded.COLLECTIVES.note_partition(skew)

        # mutable fold-state blocks (alive masks + latest times), all-dead
        def blk(m_loc, fill, dt):
            return np.full((S, m_loc), fill, dt)

        self.sv = ShardedView(
            n_shards=S, n_loc=n_loc, m_loc_d=m_d, m_loc_s=m_s,
            vids=t.vids.reshape(S, n_loc),
            v_mask=np.zeros((S, n_loc), bool),
            v_latest=np.full((S, n_loc), INT64_MIN, np.int64),
            v_first=np.full((S, n_loc), INT64_MIN, np.int64),
            d_src_g=d_src_g, d_dst_l=d_dst_l,
            d_mask=blk(m_d, False, bool),
            d_time=blk(m_d, INT64_MIN, np.int64),
            d_first=blk(m_d, INT64_MIN, np.int64),
            s_dst_g=s_dst_g, s_src_l=s_src_l,
            s_mask=blk(m_s, False, bool),
            s_time=blk(m_s, INT64_MIN, np.int64),
            s_first=blk(m_s, INT64_MIN, np.int64),
            d_props={}, s_props={}, view=None,
            d_count=d_count[:S].astype(np.int64),
            s_count=s_count[:S].astype(np.int64),
            h_d=h_d, d_src_h=d_src_h, d_send=d_send,
            h_s=h_s, s_dst_h=s_dst_h, s_send=s_send,
            skew=skew,
        )
        self._shell = _Shell(time=0, n_pad=t.n_pad, vids=t.vids,
                             v_mask=self.sv.v_mask.reshape(-1),
                             v_latest_time=self.sv.v_latest.reshape(-1),
                             v_first_time=self.sv.v_first.reshape(-1))
        self.sv.view = self._shell
        self.t_now: int | None = None
        # republish the (sampled) skew once a quarter of the edge table
        # has churned since the last publication
        self._rows_since_skew = 0
        self._skew_refresh_rows = max(256, t.m // 4)

    # ---- sweep driving ----

    def advance(self, time: int) -> None:
        """Fold events in (t_now, time] on the host and patch the touched
        rows into the per-shard blocks. Times must be non-decreasing."""
        time = int(time)
        if self.t_now is not None and time < self.t_now:
            raise ValueError(
                f"ShardedSweep times must ascend (got {time} < {self.t_now})")
        if self.t_now is not None and time == self.t_now:
            return
        self.sw._advance(time)
        self.t_now = time
        self._shell.time = time
        d = self.sw.last_delta
        sv, n_loc = self.sv, self.n_loc
        vi = d["v_idx"]
        if len(vi):
            vs, vl = vi // n_loc, vi % n_loc
            sv.v_mask[vs, vl] = d["v_alive"]
            sv.v_latest[vs, vl] = d["v_lat"]
            sv.v_first[vs, vl] = d["v_first"]
        if len(d["e_enc"]):
            pos = self.t.eng_pos(d["e_enc"])
            for shard, slot, blocks in (
                    (self._d_shard, self._d_slot,
                     (sv.d_mask, sv.d_time, sv.d_first)),
                    (self._s_shard, self._s_slot,
                     (sv.s_mask, sv.s_time, sv.s_first))):
                sh, sl = shard[pos], slot[pos]
                blocks[0][sh, sl] = d["e_alive"]
                blocks[1][sh, sl] = d["e_lat"]
                blocks[2][sh, sl] = d["e_first"]
            self._rows_since_skew += len(pos)
            if self._rows_since_skew >= self._skew_refresh_rows:
                self._rows_since_skew = 0
                sharded.refresh_partition_skew(sv)

    # ---- dispatch ----

    def run(self, program, time: int | None = None, *, mesh,
            window: int | None = None, windows=None, comm: str = "auto"):
        """Advance to ``time`` and run ``program`` over ``mesh`` on the
        static partition. Result rows are global dense vertex indices."""
        if not supported(program):
            raise ValueError(
                "program needs occurrences or host-materialised properties — "
                "use jobs/bsp with per-view partitioning instead")
        if mesh.shape[sharded.V_AXIS] != self.S:
            raise ValueError(
                f"mesh vertex axis ({mesh.shape[sharded.V_AXIS]}) != "
                f"partition shards ({self.S})")
        if time is not None:
            self.advance(time)
        if self.t_now is None:
            raise ValueError("call advance(T) (or pass time=) before run()")
        return sharded.run(program, self._shell, mesh, window=window,
                           windows=windows, sharded_view=self.sv, comm=comm)

    def reduce_view(self):
        """A frozen host copy of the reducer-facing view fields at t_now —
        safe to keep across a later ``advance`` (the live shell mutates)."""
        return _Shell(time=int(self._shell.time), n_pad=self.t.n_pad,
                      vids=self.t.vids,
                      v_mask=self._shell.v_mask.copy(),
                      v_latest_time=self._shell.v_latest_time.copy(),
                      v_first_time=self._shell.v_first_time.copy())


class _Shell:
    """The reducer-facing slice of a GraphView over the global dense space:
    enough for ``sharded.run`` (time, n_pad) and host reducers
    (vids / v_mask / window_masks)."""

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
        return v, None  # edge masks live in the sharded blocks

    def vertex_prop(self, name, default=np.nan):
        raise ValueError("ShardedSweep does not materialise properties — "
                         "programs with props use the per-view path")
