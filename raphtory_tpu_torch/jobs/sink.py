"""Result file sinks — per-job line writers for analysis output.

The reference appends every analysis result row as a text line to an
env-configured path — ``Utils.scala:107-126`` (``writeLines``: print to
stdout when unset, else mkdirs + append file) — and each algorithm formats
its rows inline (``ConnectedComponents.scala:46,62`` JSON rows,
``/analysis/Analyser.scala`` subclasses generally). Without a sink a long
Range job's results lived only in the job object and died with the process.

Here the sink is a small thread-safe line-writer attached to the job's
emit path: rows stream to disk the moment they are computed (line-buffered,
so a killed job's partial output survives), in ``jsonl`` (one JSON object
per row, the reference's shape) or ``csv`` (header + one row per view),
while the same rows stay in memory for the REST surface.
"""

from __future__ import annotations

import csv
import io
import json
import os
import threading

__all__ = ["ResultSink", "resolve_sink_path"]

_CSV_FIELDS = ("time", "windowsize", "viewTime", "steps", "result")


class ResultSink:
    """Append result rows to ``path`` as lines; format inferred from the
    suffix (``.csv`` → csv, anything else → jsonl) unless ``fmt`` forces
    one. Parent directories are created (the reference's mkdirs). Writes
    are flushed per line so readers — and post-kill inspection — always
    see every emitted row."""

    def __init__(self, path: str, fmt: str | None = None):
        if fmt is None:
            fmt = "csv" if str(path).endswith(".csv") else "jsonl"
        if fmt not in ("jsonl", "csv"):
            raise ValueError(f"unknown sink format {fmt!r}")
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self.path = str(path)
        self.fmt = fmt
        self.rows_written = 0
        self._lock = threading.Lock()
        self._fh: io.TextIOBase | None = open(path, "a", encoding="utf-8",
                                              newline="")   # csv contract
        self._csv = csv.writer(self._fh) if fmt == "csv" else None
        self._header_done = fmt != "csv"

    def write(self, row: dict) -> None:
        """Append one result row (no-op after close, so a racing emit
        during job teardown cannot raise)."""
        with self._lock:
            if self._fh is None:
                return
            if not self._header_done:
                # deferred to the first row: a sink that is opened but
                # loses the manager's in-use check never dirties the file,
                # and an append to an existing file keeps its one header
                if self._fh.tell() == 0:
                    self._csv.writerow(_CSV_FIELDS)
                self._header_done = True
            if self.fmt == "csv":
                self._csv.writerow(
                    [json.dumps(row.get(k), default=str)
                     if k == "result" else row.get(k)
                     for k in _CSV_FIELDS])
            else:
                self._fh.write(json.dumps(row, default=str) + "\n")
            self._fh.flush()
            self.rows_written += 1

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "ResultSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def resolve_sink_path(sink_dir: str, job_id: str,
                      requested: str | None = None,
                      fmt: str = "jsonl") -> str | None:
    """Resolve a job's sink path. With no configured ``sink_dir`` sinks are
    disabled (returns None) — matching the reference's unset-env behaviour
    minus the stdout spam. Both the ``requested`` name (from a REST body)
    and the job id (also caller-supplied over REST) are interpreted
    RELATIVE to ``sink_dir`` and must stay inside it: network callers pick
    a file name, never an absolute filesystem location. Extensionless
    names get the ``fmt`` suffix so the format survives suffix inference."""
    if not sink_dir:
        return None
    if fmt not in ("jsonl", "csv"):
        raise ValueError(f"unknown sink format {fmt!r}")
    if requested is not None and not isinstance(requested, str):
        raise ValueError(f"sink name must be a string, got "
                         f"{type(requested).__name__}")
    base = os.path.realpath(sink_dir)
    name = requested if requested else f"{job_id}.{fmt}"
    if not name.endswith((".jsonl", ".csv")):
        name += f".{fmt}"
    # realpath (not abspath): a symlink planted inside the sink dir must
    # not smuggle writes outside it
    cand = os.path.realpath(os.path.join(base, name))
    if os.path.commonpath([base, cand]) != base or cand == base:
        raise ValueError(f"sink path {name!r} escapes the sink dir")
    if os.path.isdir(cand):
        raise ValueError(f"sink path {name!r} is a directory")
    return cand
