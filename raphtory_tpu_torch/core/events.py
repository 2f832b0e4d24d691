"""Append-only temporal event log — the heart of the store.

Re-design of the reference's bitemporal entity model
(``core/model/graphentities/Entity.scala:25-57`` — per-entity
``TreeMap[Long, Boolean]`` histories with tombstone deletes). Instead of
pointer-chasing per-entity maps, the whole graph history is ONE
structure-of-arrays event log on the host (numpy). Views/windows are computed
as vectorised folds over the sorted log (see ``snapshot.py``); the columnar
engine ships only fold state and per-hop deltas to the device.

Semantics (deterministic fold over the event *multiset* — order of arrival
never matters, mirroring the commutativity invariant of the reference,
``README.md:6``):

* A vertex is alive at T iff the latest vertex-relevant event at time <= T is
  an "alive" mark. Alive marks are: explicit vertex adds AND any edge add
  touching the vertex (the reference's ``EntityStorage.edgeAdd`` calls
  ``vertexAdd`` for both endpoints, ``EntityStorage.scala:241-263``). Dead
  marks are vertex deletes.
* An edge (src, dst) is alive at T iff the latest event at time <= T in its
  *merged* stream is an edge add. The merged stream is: its own add/delete
  events plus a dead mark at the time of every delete of either endpoint
  (the reference's ``killList`` propagation, ``Edge.scala:36-44``,
  ``EntityStorage.scala:148-232`` — here a pure fold, no ack protocol).
* Tie-break at equal timestamps: delete wins (tombstone preference). The
  reference's last-writer-wins TreeMap insert is order-dependent; we pick the
  deterministic, conservative resolution so the permutation invariant holds
  exactly.
"""

from __future__ import annotations

import threading

import numpy as np

# Event kinds (u8)
VERTEX_ADD = np.uint8(0)
VERTEX_DELETE = np.uint8(1)
EDGE_ADD = np.uint8(2)
EDGE_DELETE = np.uint8(3)

KIND_NAMES = {0: "vertex_add", 1: "vertex_delete", 2: "edge_add", 3: "edge_delete"}

_GROW = 1.6
_INIT_CAP = 1024


class _Columns:
    """Growable structure-of-arrays block."""

    def __init__(self, spec: dict[str, np.dtype], cap: int = _INIT_CAP):
        self.spec = spec
        self.n = 0
        self.cap = cap
        self.cols = {k: np.empty(cap, dtype=dt) for k, dt in spec.items()}

    def _ensure(self, extra: int) -> None:
        need = self.n + extra
        if need <= self.cap:
            return
        new_cap = max(need, int(self.cap * _GROW) + 1)
        for k in self.cols:
            new = np.empty(new_cap, dtype=self.spec[k])
            new[: self.n] = self.cols[k][: self.n]
            self.cols[k] = new
        self.cap = new_cap

    def append_row(self, **vals) -> int:
        self._ensure(1)
        i = self.n
        for k, v in vals.items():
            self.cols[k][i] = v
        self.n = i + 1
        return i

    def append_batch(self, **arrays) -> tuple[int, int]:
        lens = {len(a) for a in arrays.values()}
        assert len(lens) == 1, f"ragged batch: {lens}"
        m = lens.pop()
        self._ensure(m)
        i = self.n
        for k, a in arrays.items():
            self.cols[k][i : i + m] = a
        self.n = i + m
        return i, i + m

    def view(self, name: str) -> np.ndarray:
        return self.cols[name][: self.n]


class PropertyLog:
    """Timeline of property updates attached to events.

    Mirrors ``MutableProperty.previousState: TreeMap[Long, Any]``
    (``MutableProperty.scala:19``) / ``ImmutableProperty``
    (``ImmutableProperty.scala:9-11``) as flat arrays: each row says
    "event #e set key k to value v". Numeric values live in a float64 column
    (device-capable); strings in a host-side list referenced by index.
    """

    STR_TAG = np.int8(1)
    NUM_TAG = np.int8(0)

    def __init__(self) -> None:
        self._key_ids: dict[str, int] = {}
        self._key_names: list[str] = []
        self._immutable: set[int] = set()
        self._rows = _Columns(
            {
                "event": np.dtype(np.int64),
                "key": np.dtype(np.int32),
                "tag": np.dtype(np.int8),
                "num": np.dtype(np.float64),
                "sref": np.dtype(np.int64),
            }
        )
        self._strings: list[str] = []

    def key_id(self, name: str, immutable: bool = False) -> int:
        kid = self._key_ids.get(name)
        if kid is None:
            kid = len(self._key_names)
            self._key_ids[name] = kid
            self._key_names.append(name)
        if immutable:
            self._immutable.add(kid)
        return kid

    def key_name(self, kid: int) -> str:
        return self._key_names[kid]

    def is_immutable(self, kid: int) -> bool:
        return kid in self._immutable

    @property
    def keys(self) -> list[str]:
        return list(self._key_names)

    def append(self, event_row: int, props: dict[str, object] | None) -> None:
        if not props:
            return
        for name, value in props.items():
            immutable = False
            if name.startswith("!"):  # "!name" marks immutable, like Type props
                immutable, name = True, name[1:]
            kid = self.key_id(name, immutable=immutable)
            if isinstance(value, str):
                self._rows.append_row(
                    event=event_row,
                    key=kid,
                    tag=self.STR_TAG,
                    num=np.nan,
                    sref=len(self._strings),
                )
                self._strings.append(value)
            else:
                self._rows.append_row(
                    event=event_row,
                    key=kid,
                    tag=self.NUM_TAG,
                    num=float(value),
                    sref=-1,
                )

    @property
    def n(self) -> int:
        return self._rows.n

    def column(self, name: str) -> np.ndarray:
        return self._rows.view(name)

    def string(self, sref: int) -> str:
        return self._strings[sref]


class EventLog:
    """The append-only log. Thread-safe appends (ingestion workers share it).

    Columns: ``time`` (event time, i64), ``kind`` (u8), ``src`` (vertex id or
    edge source, i64), ``dst`` (edge destination, -1 for vertex events).
    Row index doubles as the event id referenced by ``PropertyLog``.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._rows = _Columns(
            {
                "time": np.dtype(np.int64),
                "kind": np.dtype(np.uint8),
                "src": np.dtype(np.int64),
                "dst": np.dtype(np.int64),
            }
        )
        self.props = PropertyLog()
        # Monotone high-water marks maintained on append (cheap, lock-held).
        self.min_time: int = np.iinfo(np.int64).max
        self.max_time: int = np.iinfo(np.int64).min
        self._version = 0  # bumped per append
        self._frozen = False

    # -- single-event API (the reference's EntityStorage verbs,
    #    EntityStorage.scala:73 vertexAdd / :237 edgeAdd / :148 vertexRemoval /
    #    :327 edgeRemoval) --

    def add_vertex(self, time: int, vid: int, props: dict | None = None) -> None:
        with self._lock:
            row = self._rows.append_row(time=time, kind=VERTEX_ADD, src=vid, dst=-1)
            self.props.append(row, props)
            self._touch(time)

    def delete_vertex(self, time: int, vid: int) -> None:
        with self._lock:
            self._rows.append_row(time=time, kind=VERTEX_DELETE, src=vid, dst=-1)
            self._touch(time)

    def add_edge(self, time: int, src: int, dst: int, props: dict | None = None) -> None:
        with self._lock:
            row = self._rows.append_row(time=time, kind=EDGE_ADD, src=src, dst=dst)
            self.props.append(row, props)
            self._touch(time)

    def delete_edge(self, time: int, src: int, dst: int) -> None:
        with self._lock:
            self._rows.append_row(time=time, kind=EDGE_DELETE, src=src, dst=dst)
            self._touch(time)

    # -- bulk API (hot ingestion path) --

    def append_batch(
        self,
        time: np.ndarray,
        kind: np.ndarray,
        src: np.ndarray,
        dst: np.ndarray,
        props: list | None = None,
    ) -> tuple[int, int]:
        """Append a batch of events; returns the [start, end) row range.

        ``props`` is a list of ``(batch_offset, dict)`` property payloads,
        appended under the SAME lock acquisition as the event rows — a
        freeze() concurrent with ingestion must never observe events whose
        properties are still pending."""
        with self._lock:
            rng = self._rows.append_batch(
                time=np.asarray(time, np.int64),
                kind=np.asarray(kind, np.uint8),
                src=np.asarray(src, np.int64),
                dst=np.asarray(dst, np.int64),
            )
            if props:
                start = rng[0]
                for off, p in props:
                    self.props.append(start + off, p)
            if len(time):
                t = np.asarray(time)
                self.min_time = min(self.min_time, int(t.min()))
                self.max_time = max(self.max_time, int(t.max()))
            self._version += 1
            return rng

    def _touch(self, time: int) -> None:
        self.min_time = min(self.min_time, int(time))
        self.max_time = max(self.max_time, int(time))
        self._version += 1

    # -- read access (snapshot builder) --

    @property
    def n(self) -> int:
        return self._rows.n

    @property
    def version(self) -> int:
        return self._version

    def column(self, name: str) -> np.ndarray:
        """Zero-copy view of a column. Stable under concurrent appends
        (appends only extend past ``n``; rows < n are immutable)."""
        return self._rows.view(name)

    def arrays(self) -> dict[str, np.ndarray]:
        return {k: self._rows.view(k) for k in ("time", "kind", "src", "dst")}

    def __len__(self) -> int:
        return self._rows.n

    # ---- consistent snapshots ----

    def freeze(self) -> "EventLog":
        """A consistent, immutable prefix snapshot taken under the lock.

        Rows already written never mutate, so the snapshot just pins matching
        (event-count, prop-count) lengths — O(1), no copying. Use for
        consistent reads concurrent with live appends."""
        with self._lock:
            n = self._rows.n
            p_n = self.props._rows.n
            rows = self._rows
            props = self.props
            # bounds/version read under the same lock that appends hold, so
            # they describe exactly the pinned n rows
            min_t, max_t, ver = self.min_time, self.max_time, self._version
        out = EventLog.__new__(EventLog)
        out._lock = threading.Lock()
        out._frozen = True
        out._rows = _FrozenColumns(rows, n)
        out.props = _FrozenProps(props, p_n)
        out.min_time = min_t
        out.max_time = max_t
        out._version = ver
        return out

    def pin(self) -> "EventLog":
        """Consistent read snapshot for view building — O(1): views built
        over a pin never observe rows appended after it."""
        return self if self._frozen else self.freeze()

    def __repr__(self) -> str:  # pragma: no cover
        return f"EventLog(n={self.n}, time=[{self.min_time},{self.max_time}])"


class _FrozenColumns:
    """Read-only fixed-length view over a _Columns block."""

    def __init__(self, inner: _Columns, n: int):
        self._cols = {k: inner.cols[k][:n] for k in inner.cols}
        self.n = n

    def view(self, name: str) -> np.ndarray:
        return self._cols[name]

    def append_row(self, **kw):  # pragma: no cover
        raise RuntimeError("frozen log is read-only")

    append_batch = append_row


class _FrozenProps:
    """Read-only fixed-length view over a PropertyLog."""

    STR_TAG = PropertyLog.STR_TAG
    NUM_TAG = PropertyLog.NUM_TAG

    def __init__(self, inner: PropertyLog, n: int):
        self._inner = inner
        self.n = n
        self._key_ids = inner._key_ids
        self._immutable = inner._immutable

    @property
    def keys(self):
        return self._inner.keys

    def key_name(self, kid: int) -> str:
        return self._inner.key_name(kid)

    def is_immutable(self, kid: int) -> bool:
        return self._inner.is_immutable(kid)

    def column(self, name: str) -> np.ndarray:
        return self._inner._rows.cols[name][: self.n]

    def string(self, sref: int) -> str:
        return self._inner.string(sref)

    @property
    def _strings(self):
        return self._inner._strings
