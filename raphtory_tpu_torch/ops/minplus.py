"""Kernels of the columnar min-combine traversals: K5 (connected components,
min-label propagation) and K6 (BFS / weighted SSSP, min-plus relaxation),
one superstep each, and their destination-binned forms K5-P / K6-P.

Same three parts as ``ops/columns.py``, whose build and launch plumbing
they share: a **wrapper** (``cc_superstep``, ``minplus_superstep``,
``binned_cc_superstep``, ``binned_minplus_superstep``) that checks its
inputs and routes by device (CPU tensors take the twin, CUDA tensors
launch the kernel or raise), a **plain twin** (``*_plain``) with the same
math, and the **CUDA source** ``csrc/minplus_columns.cu``: one kernel and
one launch a superstep on every route. The card branch checks each input
signature once (``columns._k2_checked``: each tensor's identity and
version counter); ``cur`` and ``nxt`` swap every superstep, so a loop
sees two signatures.

A superstep is synchronous: it reads ``MinState.cur`` and writes
``MinState.nxt``, then the wrapper swaps the two, so every row sees the
previous superstep's state, as the reference's ``while_loop`` body does.
Results are bitwise the reference's: min is exact and ``dist + w`` is one
f32 add.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .columns import (_check_binned, _expect, _fn, _k2_checked, _launch,
                      _on_cuda, _stream, check_bucket_sources)

I32_MAX = 2**31 - 1
INF = float("inf")

#: K5/K6's block: 256 threads, a lane 4 adjacent columns of a row, a row's
#: lanes (its group) up to 32 (``csrc/minplus_columns.cu``)
_THREADS = 256
#: most blocks along K5/K6's rows: its last block reads one busy word per
#: block
_BLOCKS = 2 * 132


def superstep_grid(n: int, C: int) -> int:
    """Blocks along the rows of K5/K6's grid for ``[n, C]`` state — the row
    count of ``MinState.busy``. A block holds ``256 // G`` rows of ``G =
    min(ceil(C / 4), 32)`` lanes (wider C tiles the columns over the
    grid's second dimension)."""
    rows = _THREADS // max(1, min(-(-C // 4), 32))
    return max(1, min(-(-n // rows), _BLOCKS))


@dataclass
class MinState:
    """Per-dispatch state of a min-combine traversal, advanced in place.
    ``busy``/``ticket`` are the kernel's cross-block scratch (the twin
    leaves them alone)."""
    cur: torch.Tensor        # [n, C] int32 labels / f32 distances
    nxt: torch.Tensor        # [n, C] the next superstep's state
    halted: torch.Tensor     # [C] bool converged (frozen) columns
    done: torch.Tensor       # [1] bool every column halted
    busy: torch.Tensor       # [gx, C] int32 per-block "changed"
    ticket: torch.Tensor     # [1] int32 blocks finished (reset by the last)


def min_state(x0: torch.Tensor) -> MinState:
    """A ``MinState`` around the start state ``x0 [n, C]`` (contiguous)."""
    n, C = x0.shape
    dev = x0.device
    return MinState(
        cur=x0, nxt=torch.empty_like(x0),
        halted=torch.zeros(C, dtype=torch.bool, device=dev),
        done=torch.zeros(1, dtype=torch.bool, device=dev),
        busy=torch.empty((superstep_grid(n, C), C), dtype=torch.int32,
                         device=dev),
        ticket=torch.zeros(1, dtype=torch.int32, device=dev))


def _pull(cur, me, e_from, e_to, fill, w=None):
    """``min over e with e_to[e] = row of (me[e, c] ? cur[e_from[e], c]
    (+ w) : fill)`` — the reference's masked segment-min, over every m_pad
    edge (the pads are masked). ``w`` is a scalar or ``[m_pad, C]``."""
    vals = cur[e_from.long()]
    if w is not None:
        vals = vals + w
    vals = torch.where(me, vals, fill)
    idx = e_to.long()[:, None].expand_as(vals)
    return torch.full_like(cur, fill).scatter_reduce_(0, idx, vals, "amin")


def _advance_plain(st: MinState, agg, mv, fill) -> None:
    """The superstep epilogue: min with the pull, mask, halting over every
    row, then the freeze of halted columns; swaps ``cur``/``nxt``."""
    new = torch.where(mv, torch.minimum(st.cur, agg), fill)
    col_done = (new == st.cur).all(0)
    torch.where(st.halted[None, :], st.cur, new, out=st.nxt)
    st.halted |= col_done
    st.done.copy_(st.halted.all().reshape(1))
    st.cur, st.nxt = st.nxt, st.cur


def _check(name, st: MinState, me, mv, edges, dtype):
    n, C = st.cur.shape
    m = me.shape[0]
    _expect(name, st.cur, "cur", (dtype,), (n, C))
    _expect(name, st.nxt, "nxt", (dtype,), (n, C))
    _expect(name, me, "me", (torch.bool,), (m, C))
    _expect(name, mv, "mv", (torch.bool,), (n, C))
    _expect(name, st.halted, "halted", (torch.bool,), (C,))
    _expect(name, st.done, "done", (torch.bool,), (1,))
    _expect(name, edges.e_src, "e_src", (torch.int32,), (m,))
    _expect(name, edges.e_dst, "e_dst", (torch.int32,), (m,))
    _expect(name, edges.in_indptr, "in_indptr", (torch.int64,), (n + 1,))
    _expect(name, edges.out_indptr, "out_indptr", (torch.int64,), (n + 1,))
    _expect(name, edges.out_perm, "out_perm", (torch.int32,),
            (edges.out_perm.shape[0],))


def _check_weights(name, C: int, W: int, ew, rows: int) -> None:
    """``ew`` (when given) must be the f32 ``[rows, H]`` weight block of
    ``C = H * W`` columns."""
    if ew is not None:
        if C % W:
            raise ValueError(f"{name}: {C} columns are not H x W={W}")
        _expect(name, ew, "ew", (torch.float32,), (rows, C // W))


def _card_args(name, st: MinState, me, mv, walks, ew, extra, check):
    """The C call's arguments but the stream — ``(gx, in_indptr,
    in_order, in_rows, out_indptr, out_order, out_rows, me, mv, cur, nxt,
    halted, done, busy, ticket)`` as pointers, None for an absent walk
    array — or None for the twin's branch. ``check()`` (the wrapper's
    full checks, raising on a bad input) and the scratch's checks run once
    per input signature (``columns._k2_checked``)."""
    tensors = (st.cur, st.nxt, st.halted, st.done, st.busy, st.ticket, me,
               mv, *(t for t in walks if t is not None))
    if ew is not None:
        tensors += (ew,)

    def full():
        check()
        if not _on_cuda(name, *tensors):
            return None
        gx = superstep_grid(*st.cur.shape)
        _expect(name, st.busy, "busy", (torch.int32,),
                (gx, st.cur.shape[1]))
        _expect(name, st.ticket, "ticket", (torch.int32,), (1,))
        return (gx, *(None if t is None else t.data_ptr() for t in walks),
                me.data_ptr(), mv.data_ptr(), st.cur.data_ptr(),
                st.nxt.data_ptr(), st.halted.data_ptr(), st.done.data_ptr(),
                st.busy.data_ptr(), st.ticket.data_ptr())

    return _k2_checked(name, tensors, extra, full)


def _flat_walks(edges):
    """A ``DeviceEdges``' walks: the destination CSR over the (dst, src)
    table itself (entry j is edge j, far end ``e_src[j]``) and the source
    index (``out_perm``, far end ``e_dst``)."""
    return (edges.in_indptr, None, edges.e_src, edges.out_indptr,
            edges.out_perm, edges.e_dst)


def _binned_walks(be):
    """A layout's walks: its destination walk (far end ``b_src``) and its
    source walk (far end ``b_dst``; None unless asked for)."""
    return (be.in_indptr, be.in_order, be.b_src, be.out_indptr,
            be.out_order, be.b_dst)


# ---------------------------------------------------------------- K5

def cc_superstep_plain(st: MinState, me, mv, edges) -> None:
    """Twin of ``rtpu_cc_superstep``: one superstep of min-label
    propagation over both directions (``hopbatch.py:580-588``)."""
    agg = torch.minimum(
        _pull(st.cur, me, edges.e_src, edges.e_dst, I32_MAX),
        _pull(st.cur, me, edges.e_dst, edges.e_src, I32_MAX))
    _advance_plain(st, agg, mv, I32_MAX)


def cc_superstep(st: MinState, me, mv, edges) -> None:
    """K5 wrapper (the loop body of ``raphtory_tpu/engine/hopbatch.py:538``
    ``_cc_columns``): advances ``st`` (int32 ``[n_pad, C]`` labels) by one
    superstep over the column masks ``me [m_pad, C]`` / ``mv [n_pad, C]``
    and the device edge tables ``edges`` (``DeviceEdges``)."""
    name = "cc_superstep"
    args = _card_args(name, st, me, mv, _flat_walks(edges), None, None,
                      lambda: _check(name, st, me, mv, edges, torch.int32))
    if args is None:
        return cc_superstep_plain(st, me, mv, edges)
    n, C = st.cur.shape
    _launch(name, _fn("minplus_columns", "rtpu_cc_superstep")(
        n, C, *args, _stream(st.cur)))
    st.cur, st.nxt = st.nxt, st.cur


# ---------------------------------------------------------------- K6

def minplus_superstep_plain(st: MinState, me, mv, edges, directed: bool,
                            ew=None, W: int = 1) -> None:
    """Twin of ``rtpu_minplus_superstep``: one min-plus relaxation
    (``hopbatch.py:662-670``), payload ``dist[u] + w`` with ``w = 1`` or
    ``ew[e, c // W]``; the out-direction pull only when undirected."""
    w = 1.0 if ew is None else ew.repeat_interleave(W, dim=1)  # hop-major
    agg = _pull(st.cur, me, edges.e_src, edges.e_dst, INF, w)
    if not directed:
        agg = torch.minimum(agg, _pull(st.cur, me, edges.e_dst, edges.e_src,
                                       INF, w))
    _advance_plain(st, agg, mv, INF)


def minplus_superstep(st: MinState, me, mv, edges, directed: bool,
                      ew=None, W: int = 1) -> None:
    """K6 wrapper (the loop body of ``raphtory_tpu/engine/hopbatch.py:620``
    ``_bfs_columns``): advances ``st`` (f32 ``[n_pad, C]`` distances) by one
    superstep. ``ew`` is None for hop counting or the ``[m_pad, H]`` f32
    weight block of K6w (``C = H * W``, hop-major columns)."""
    name = "minplus_superstep"

    def check():
        _check(name, st, me, mv, edges, torch.float32)
        _check_weights(name, st.cur.shape[1], W, ew, me.shape[0])

    args = _card_args(name, st, me, mv, _flat_walks(edges), ew,
                      (bool(directed), W), check)
    if args is None:
        return minplus_superstep_plain(st, me, mv, edges, directed, ew, W)
    n, C = st.cur.shape
    _launch(name, _fn("minplus_columns", "rtpu_minplus_superstep")(
        n, C, W, C // W, args[0], int(bool(directed)),
        None if ew is None else ew.data_ptr(), *args[1:], _stream(st.cur)))
    st.cur, st.nxt = st.nxt, st.cur


# ------------------------------------------------------------ K5-P / K6-P

def _binned_in(cur, me, be, fill, w=None):
    """The binned in-direction pull of the twins: ``min over slots s with
    b_dst[s] = row of (me[s, c] ? src(s)[c] (+ w) : fill)``, ``src(s)`` the
    bucket row ``cur[u_src][slot[s]]`` when the layout pre-aggregates, else
    ``cur[b_src[s]]`` (``hopbatch.py:572-576``, ``:653-657``)."""
    if be.U:
        vals = cur[be.u_src.long()][be.slot.long()]
    else:
        vals = cur[be.b_src.long()]
    if w is not None:
        vals = vals + w
    vals = torch.where(me, vals, fill)
    idx = be.b_dst.long()[:, None].expand_as(vals)
    return torch.full_like(cur, fill).scatter_reduce_(0, idx, vals, "amin")


def _check_binned_step(name, st: MinState, me, mv, be, dtype, reverse):
    n, C = st.cur.shape
    B = me.shape[0]
    _expect(name, st.cur, "cur", (dtype,), (n, C))
    _expect(name, st.nxt, "nxt", (dtype,), (n, C))
    _expect(name, me, "me", (torch.bool,), (B, C))
    _expect(name, mv, "mv", (torch.bool,), (n, C))
    _expect(name, st.halted, "halted", (torch.bool,), (C,))
    _expect(name, st.done, "done", (torch.bool,), (1,))
    _check_binned(name, be, B, n, reverse)
    check_bucket_sources(name, be)


def binned_cc_superstep_plain(st: MinState, me, mv, be) -> None:
    """Twin of ``rtpu_binned_cc_superstep``: one binned superstep of
    min-label propagation — the in-direction through the buckets, the
    reverse over the binned arrays (``hopbatch.py:572-588``)."""
    agg = torch.minimum(
        _binned_in(st.cur, me, be, I32_MAX),
        _pull(st.cur, me, be.b_dst, be.b_src, I32_MAX))
    _advance_plain(st, agg, mv, I32_MAX)


def binned_cc_superstep(st: MinState, me, mv, be) -> None:
    """K5-P wrapper (``_cc_columns`` with ``pcpm``,
    ``raphtory_tpu/engine/hopbatch.py:572-576``): advances ``st`` (int32
    labels) by one superstep over binned masks ``me [B, C]`` and the
    layout's ``BinnedEdges`` (source walk included). One launch: the kernel
    reads each slot's source row straight from the state, where the twin
    reads a pre-aggregating layout's buckets."""
    name = "binned_cc_superstep"
    args = _card_args(name, st, me, mv, _binned_walks(be), None, be.U,
                      lambda: _check_binned_step(name, st, me, mv, be,
                                                 torch.int32, True))
    if args is None:
        return binned_cc_superstep_plain(st, me, mv, be)
    n, C = st.cur.shape
    _launch(name, _fn("minplus_columns", "rtpu_cc_superstep")(
        n, C, *args, _stream(st.cur)))
    st.cur, st.nxt = st.nxt, st.cur


def binned_minplus_superstep_plain(st: MinState, me, mv, be, directed: bool,
                                   ew=None, W: int = 1) -> None:
    """Twin of ``rtpu_binned_minplus_superstep``: one binned min-plus
    relaxation (``hopbatch.py:653-670``), weights ``ew [B, H]`` binned."""
    w = 1.0 if ew is None else ew.repeat_interleave(W, dim=1)  # hop-major
    agg = _binned_in(st.cur, me, be, INF, w)
    if not directed:
        agg = torch.minimum(agg, _pull(st.cur, me, be.b_dst, be.b_src, INF,
                                       w))
    _advance_plain(st, agg, mv, INF)


def binned_minplus_superstep(st: MinState, me, mv, be, directed: bool,
                             ew=None, W: int = 1) -> None:
    """K6-P wrapper (``_bfs_columns`` with ``pcpm``,
    ``raphtory_tpu/engine/hopbatch.py:653-657``): advances ``st`` (f32
    distances) by one superstep over binned masks ``me [B, C]``; ``ew`` is
    None (hop counting) or the binned ``[B, H]`` weight block. The layout's
    source walk is needed only when undirected. One launch, as K5-P."""
    name = "binned_minplus_superstep"

    def check():
        _check_binned_step(name, st, me, mv, be, torch.float32,
                           not directed)
        _check_weights(name, st.cur.shape[1], W, ew, me.shape[0])

    walks = _binned_walks(be)
    if directed:
        walks = walks[:3] + (None, None, None)
    args = _card_args(name, st, me, mv, walks, ew, (bool(directed), W, be.U),
                      check)
    if args is None:
        return binned_minplus_superstep_plain(st, me, mv, be, directed, ew,
                                              W)
    n, C = st.cur.shape
    _launch(name, _fn("minplus_columns", "rtpu_minplus_superstep")(
        n, C, W, C // W, args[0], int(bool(directed)),
        None if ew is None else ew.data_ptr(), *args[1:], _stream(st.cur)))
    st.cur, st.nxt = st.nxt, st.cur
