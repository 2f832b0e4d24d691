"""K10 and K10-P — one round of the windowed feature aggregation.

``raphtory_tpu/engine/features.py:36`` ``_compiled_propagate`` runs, per
round, a masked mean-aggregate of the F-wide source rows at each
destination, mixes each vertex's own row back in and L2-normalises the
result:

    mask[e]  = e_alive[e] & (window < 0 | e_lat[e] >= clip(T - window))
    deg[d]   = #{e -> d : mask[e]}
    agg[d]   = sum over e -> d with mask[e] of H[src[e]]     (f32)
    H2[d]    = self_weight * H[d] + (1 - self_weight) * agg[d] / max(deg, 1)
    H'[d]    = H2[d] / max(||H2[d]||, 1e-12), rounded to H's storage dtype

with ``H`` stored in float32 or bfloat16 and every sum, product and norm in
float32. The reference's degree is round-invariant and computed once a
call; computing it inside every round's walk gives the same number.

Same three parts as ``ops/columns.py``, whose build and launch plumbing
they share:

* the **wrappers** ``propagate_round`` (the unbinned route: one launch a
  round over the destination CSR, entry j read as ``(e_src[j], j)``) and
  ``propagate_round_binned`` (the destination-binned PCPM route over a
  ``BinnedEdges`` layout: one launch a round that walks each row's slots
  through ``binned_walk``'s pairs) — one kernel, ``ring_kernel`` in
  ``csrc/features.cu``, gathering the source rows straight from ``H``
  with several in flight, in entry order, so the two routes agree bit for
  bit; CPU tensors take the twin, CUDA tensors launch it or raise;
* the **plain twins** (``*_plain``): the reference's chunked scan, edge
  (or binned slot) chunks of ``chunk`` rows scatter-added at the
  destination, so at 2^25 edges and F = 128 they hold a few chunk-sized
  transients and never an ``[m, F]`` payload;
* the CUDA source.
"""

from __future__ import annotations

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .columns import _expect, _fn, _launch, _on_cuda, _stream

#: feature storage dtypes (the kernels' ``fdtype`` codes)
FEATURE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TIME_DTYPES = (torch.int32, torch.int64)


def window_bound(T: int, window: int, tdtype: torch.dtype) -> tuple[int, bool]:
    """``(lo, nowin)`` of the reference's mask (``features.py:59-61``):
    ``T - window`` clipped to the resident time dtype, and whether the
    window is off (negative)."""
    info = torch.iinfo(tdtype)
    lo = min(max(int(T) - int(window), info.min), info.max)
    return lo, int(window) < 0


def edge_mask(e_lat, e_alive, lo: int, nowin: bool):
    """``bool[m_pad]``: the live edges of the window."""
    if nowin:
        return e_alive.clone()
    return e_alive & (e_lat >= lo)


def _epilogue(H, agg, deg, self_weight: float):
    """Mean, mix and normalise (``features.py:127-131``): the self term
    reads the STORED row, the result rounds to its storage dtype."""
    inv_deg = 1.0 / torch.clamp(deg, min=1.0)
    H2 = agg * inv_deg[:, None]
    H2 = self_weight * H.float() + (1.0 - self_weight) * H2
    norm = torch.sqrt(torch.sum(H2 * H2, dim=1, keepdim=True))
    return (H2 / torch.clamp(norm, min=1e-12)).to(H.dtype)


def _check(name, H, e_lat, e_alive, m_pad):
    n_pad, F = H.shape
    _expect(name, H, "H", tuple(FEATURE_DTYPES), (n_pad, F))
    _expect(name, e_lat, "e_lat", _TIME_DTYPES, (m_pad,))
    _expect(name, e_alive, "e_alive", (torch.bool,), (m_pad,))
    return n_pad, F


def _check_kernel_shape(name, H):
    F = H.shape[1]
    if F % 4 or not 0 < F <= 512:
        raise ValueError(f"{name}: feature width {F} has no kernel (want a "
                         "multiple of 4 up to 512)")
    if H.data_ptr() % 16:
        raise ValueError(f"{name}: H is not 16-byte aligned (the kernel "
                         "reads rows in groups of 4 features)")


# ---------------------------------------------------------------- K10

def propagate_round_plain(H, edges, e_lat, e_alive, lo: int, nowin: bool,
                          self_weight: float, chunk: int = 1 << 22):
    """Twin of ``rtpu_feature_propagate``: the unbinned round
    (``features.py:79-95, 111-131``), the edges scanned in ``chunk``-row
    pieces (``edges`` the sweep's ``DeviceEdges``)."""
    n_pad, F = H.shape
    mask = edge_mask(e_lat, e_alive, lo, nowin)
    deg = torch.zeros(n_pad, dtype=torch.float32, device=H.device)
    agg = torch.zeros((n_pad, F), dtype=torch.float32, device=H.device)
    for c0 in range(0, edges.e_src.shape[0], chunk):
        s = edges.e_src[c0:c0 + chunk].long()
        d = edges.e_dst[c0:c0 + chunk].long()
        mk = mask[c0:c0 + chunk]
        deg.index_add_(0, d, mk.float())
        agg.index_add_(0, d, torch.where(mk[:, None], H[s].float(), 0.0))
    return _epilogue(H, agg, deg, self_weight)


def propagate_round(H, edges, e_lat, e_alive, lo: int, nowin: bool,
                    self_weight: float, chunk: int = 1 << 22):
    """K10 wrapper: one round of ``H [n_pad, F]`` (float32 or bfloat16
    storage) over the sweep's ``DeviceEdges`` and resident ``(e_lat,
    e_alive)``, the window given by ``window_bound``: one launch over
    ``in_indptr`` whose entry j is edge j, source row ``e_src[j]`` (K10-P's
    kernel with the walk implicit). Returns the next ``H`` (a new tensor:
    the rounds double-buffer)."""
    name = "feature_propagate"
    m_pad = edges.e_src.shape[0]
    n_pad, F = _check(name, H, e_lat, e_alive, m_pad)
    _expect(name, edges.e_src, "e_src", (torch.int32,), (m_pad,))
    _expect(name, edges.e_dst, "e_dst", (torch.int32,), (m_pad,))
    _expect(name, edges.in_indptr, "in_indptr", (torch.int64,), (n_pad + 1,))
    if not _on_cuda(name, H, e_lat, e_alive, edges.e_src, edges.in_indptr):
        return propagate_round_plain(H, edges, e_lat, e_alive, lo, nowin,
                                     self_weight, chunk)
    _check_kernel_shape(name, H)
    out = torch.empty_like(H)
    err = _fn("features", "rtpu_feature_propagate")(
        n_pad, F, FEATURE_DTYPES[H.dtype], e_lat.dtype.itemsize, int(lo),
        int(nowin), float(self_weight), float(1.0 - self_weight),
        edges.in_indptr.data_ptr(), edges.e_src.data_ptr(), e_lat.data_ptr(),
        e_alive.data_ptr(), H.data_ptr(), out.data_ptr(), _stream(H))
    _launch(name, err)
    return out


# ---------------------------------------------------------------- K10-P

def propagate_round_binned_plain(H, be, e_lat, e_alive, lo: int,
                                 nowin: bool, self_weight: float,
                                 chunk: int = 1 << 22):
    """Twin of ``rtpu_feature_propagate_binned``: the PCPM round
    (``features.py:62-77, 99-110``) — each (partition, source) bucket row
    ``H[u_src]`` gathered once, expanded through ``slot`` and scatter-added
    at ``b_dst`` where ``mask[perm] & valid``, slot chunks of ``chunk``
    rows in slot order (within each destination row: source order, the
    order of the unbinned scan)."""
    n_pad, F = H.shape
    mask = edge_mask(e_lat, e_alive, lo, nowin)
    vals = H[be.u_src.long()]
    deg = torch.zeros(n_pad, dtype=torch.float32, device=H.device)
    agg = torch.zeros((n_pad, F), dtype=torch.float32, device=H.device)
    for c0 in range(0, be.perm.shape[0], chunk):
        mk = mask[be.perm[c0:c0 + chunk].long()] & be.valid[c0:c0 + chunk]
        d = be.b_dst[c0:c0 + chunk].long()
        rows = vals[be.slot[c0:c0 + chunk].long()]
        deg.index_add_(0, d, mk.float())
        agg.index_add_(0, d, torch.where(mk[:, None], rows.float(), 0.0))
    return _epilogue(H, agg, deg, self_weight)


#: ``BinnedEdges.in_order`` → its walk pairs (``binned_walk``), kept while
#: the layout's device arrays live
_WALKS = WeakIdKeyDictionary()


def binned_walk(be):
    """``int32 [m, 2]``: for each entry ``j`` of the layout's destination
    walk (slot ``s = in_order[j]``), the source row ``u_src[slot[s]]`` and
    the engine edge ``perm[s]`` — what K10-P reads a slot, one 8-byte load
    instead of three dependent ones. Derived on ``be``'s device at the
    first call (m * 8 bytes) and cached with ``be``."""
    got = _WALKS.get(be.in_order)
    if got is None:
        s = be.in_order.long()
        got = torch.stack([be.u_src[be.slot[s].long()], be.perm[s]], dim=1)
        _WALKS[be.in_order] = got
    return got


def propagate_round_binned(H, be, e_lat, e_alive, lo: int, nowin: bool,
                           self_weight: float, chunk: int = 1 << 22):
    """K10-P wrapper: one round over a pre-aggregating layout's
    ``BinnedEdges`` (``ops/partition.PartitionLayout.device_edges``), one
    launch. Each destination row walks its real slots in the layout's
    destination walk (source order) through ``binned_walk`` and gathers
    each source row straight from ``H`` (no bucket buffer), so it adds in
    K10's order and its result equals K10's bit for bit."""
    name = "feature_propagate_binned"
    m_pad = e_lat.shape[0]
    n_pad, F = _check(name, H, e_lat, e_alive, m_pad)
    if not be.U:
        raise ValueError(f"{name}: the layout does not pre-aggregate (U=0); "
                         "the binned feature route needs its buckets")
    B = be.perm.shape[0]
    for t, what, dt, shape in ((be.perm, "perm", torch.int32, (B,)),
                               (be.valid, "valid", torch.bool, (B,)),
                               (be.b_dst, "b_dst", torch.int32, (B,)),
                               (be.slot, "slot", torch.int32, (B,)),
                               (be.u_src, "u_src", torch.int32, (be.U,)),
                               (be.in_indptr, "in_indptr", torch.int64,
                                (n_pad + 1,)),
                               (be.in_order, "in_order", torch.int32,
                                (be.in_order.shape[0],))):
        _expect(name, t, what, (dt,), shape)
    if not _on_cuda(name, H, e_lat, e_alive, be.perm, be.slot, be.u_src,
                    be.in_indptr, be.in_order):
        return propagate_round_binned_plain(H, be, e_lat, e_alive, lo, nowin,
                                            self_weight, chunk)
    _check_kernel_shape(name, H)
    walk = binned_walk(be)
    out = torch.empty_like(H)
    err = _fn("features", "rtpu_feature_propagate_binned")(
        n_pad, F, FEATURE_DTYPES[H.dtype], e_lat.dtype.itemsize, int(lo),
        int(nowin), float(self_weight), float(1.0 - self_weight),
        be.in_indptr.data_ptr(), walk.data_ptr(),
        e_lat.data_ptr(), e_alive.data_ptr(), H.data_ptr(), out.data_ptr(),
        _stream(H))
    _launch(name, err)
    return out
