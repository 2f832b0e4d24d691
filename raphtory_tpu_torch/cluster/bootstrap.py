"""Process bootstrap, topology, the collectives of one mesh axis, and the
local rank spawner.

The reference wires its processes with ``jax.distributed.initialize`` and
runs a mesh as ONE process over many devices
(``raphtory_tpu/cluster/bootstrap.py:21, 92``). The port runs SPMD the
PyTorch way: one process per rank under ``torch.distributed``, the layout
``torchrun`` gives, each rank on its own device. ``bootstrap()`` forms the
process group from the ``torchrun`` environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) or from explicit
arguments, and chooses the backend explicitly:

* ``nccl`` when the ranks run on CUDA and each has its own card;
* ``gloo`` on the CPU;
* ``gloo`` for several ranks on ONE card only when the caller asks for it
  (``share_card=True``): NCCL refuses two ranks on one GPU. Every kernel
  still runs on the card; the collectives then stage their tensors through
  host memory and back (``Axis``; ``STAGED`` names the ones that did), as
  the reference's own multi-process exchange goes through the host
  (``multihost_utils.process_allgather``).

``spawn`` starts N ranks of a function in fresh interpreters
(``python -m raphtory_tpu_torch.cluster.bootstrap``), rendezvousing over a
``FileStore`` in a private temporary directory, so concurrent groups never
collide. It has a hard timeout: when it passes, or when any rank fails,
every rank is killed and ``spawn`` raises with the ranks' error output,
how each rank ended, and the machine's free memory and load — a rank
that SIGKILL ended before ``spawn`` stopped the group (the kernel's
out-of-memory killer, or a memory limit) is named as killed from outside.
"""

from __future__ import annotations

import contextlib
import datetime
import importlib
import os
import pickle
import shutil
import signal
import subprocess
import sys
import tempfile
import time as _time
from dataclasses import dataclass
from pathlib import Path

import torch

#: collectives that staged CUDA tensors through host memory (gloo on a
#: card) since the process started
STAGED: set = set()

#: when a dict, each collective's calls and wall seconds by name, the
#: device synchronised before and after each call so that no queued
#: kernel is counted in (``[calls, seconds]``); None: not timed
TIMES: dict | None = None

_STATE: dict = {"device": None, "backend": None}


def _dist():
    import torch.distributed as dist

    return dist


def bootstrap(rank: int | None = None, world_size: int | None = None,
              init_method: str | None = None, *, device=None,
              backend: str | None = None, share_card: bool = False,
              timeout_s: float = 600.0) -> bool:
    """Join the process group (idempotent). Returns False in single-process
    mode: no arguments and no ``torchrun`` environment (``WORLD_SIZE``
    unset). ``device`` is where this rank's kernels run: ``"cpu"``, or
    CUDA (None) — ``cuda:LOCAL_RANK`` under ``nccl``, ``cuda:0`` for every
    rank under ``share_card``. A rank that cannot reach its device
    raises."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ
    if world_size is None and "WORLD_SIZE" not in env:
        return False
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = (int(env["WORLD_SIZE"]) if world_size is None
                  else int(world_size))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: CUDA is not available: pass "
                               "device='cpu' to run the ranks on the CPU")
        if share_card:
            dev = torch.device("cuda", 0 if dev.index is None else dev.index)
            chosen = backend or "gloo"
            if chosen != "gloo":
                raise ValueError("ranks sharing one card need gloo: NCCL "
                                 "refuses two ranks on one GPU")
        else:
            local = int(env.get("LOCAL_RANK", rank))
            visible = torch.cuda.device_count()
            if local >= visible:
                raise RuntimeError(
                    f"rank {rank}: no card of its own ({visible} visible); "
                    "pass share_card=True to run several ranks on one card "
                    "under gloo")
            dev = torch.device("cuda", local)
            chosen = backend or "nccl"
        torch.cuda.set_device(dev)
    elif dev.type == "cpu":
        chosen = backend or "gloo"
    else:
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    dist.init_process_group(
        chosen, init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    _STATE["device"], _STATE["backend"] = dev, chosen
    # the tracer's process identity: every span and captured trace
    # context of this rank carries it
    from ..obs.trace import TRACER

    TRACER.set_process_index(rank)
    return True


def rank_device():
    """The device ``bootstrap`` gave this rank (None before it ran)."""
    return _STATE["device"]


@dataclass(frozen=True)
class Topology:
    """What the mesh builder needs to know about this deployment."""

    n_ranks: int
    rank: int
    backend: str | None
    device: str | None


def topology() -> Topology:
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return Topology(dist.get_world_size(), dist.get_rank(),
                        _STATE["backend"] or dist.get_backend(),
                        str(_STATE["device"]))
    return Topology(1, 0, None, None)


@contextlib.contextmanager
def _timed(name: str, t: torch.Tensor):
    if TIMES is None:
        yield
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = _time.perf_counter()
    yield
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    entry = TIMES.setdefault(name, [0, 0.0])
    entry[0] += 1
    entry[1] += _time.perf_counter() - t0


class Axis:
    """The collectives of one mesh axis: the ranks ``ranks`` (global rank
    numbers, in axis order), this rank's ``index`` among them, and their
    process group. A one-rank axis is the identity and calls nothing.
    Under gloo a CUDA tensor is staged through host memory and back,
    explicitly (the name lands in ``STAGED``); ``TIMES`` times the calls
    when it is set."""

    def __init__(self, ranks, index: int, group=None):
        self.ranks = tuple(int(r) for r in ranks)
        self.index = int(index)
        self.group = group
        self.size = len(self.ranks)

    def _staged(self, name: str, t: torch.Tensor):
        if t.is_cuda and _STATE["backend"] == "gloo":
            STAGED.add(name)
            return t.cpu(), True
        return t.contiguous(), False

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Elementwise sum / max / min of ``t`` over the axis (a new
        tensor)."""
        if self.size == 1:
            return t
        dist = _dist()
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}
        with _timed("all_reduce", t):
            x, staged = self._staged("all_reduce", t)
            x = x.clone() if x is t else x
            dist.all_reduce(x, op=ops[op], group=self.group)
            x = x.to(t.device) if staged else x
        return x

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[size, *t.shape]``: every rank's ``t`` in axis order."""
        if self.size == 1:
            return t[None]
        dist = _dist()
        with _timed("all_gather", t):
            x, staged = self._staged("all_gather", t)
            out = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype,
                              device=x.device)
            dist.all_gather(list(out.unbind(0)), x, group=self.group)
            out = out.to(t.device) if staged else out
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s leading axis split into ``size`` equal chunks, chunk r
        sent to rank r; chunk o of the result is what rank o sent here."""
        if self.size == 1:
            return t
        dist = _dist()
        with _timed("all_to_all", t):
            x, staged = self._staged("all_to_all", t)
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=self.group)
            out = out.to(t.device) if staged else out
        return out


# ---------------------------------------------------------------- spawner

def _package_root() -> str:
    return str(Path(__file__).resolve().parent.parent.parent)


def spawn(target: str, world: int, args: tuple = (), *, timeout: float,
          device=None, share_card: bool = False) -> list:
    """Run ``target`` (``"module:function"``, importable from the
    package's root) as ``world`` ranks in fresh interpreters and return
    each rank's return value, in rank order. Each rank joins the group
    with ``bootstrap`` (a ``FileStore`` in a private temporary directory;
    ``device``/``share_card`` as there: the ranks run on CUDA unless
    ``device="cpu"``, and this raises before starting any rank when there
    is no card) and calls ``function(*args)``. The ranks' ``PYTHONPATH``
    is the package's root alone, so they import nothing the caller's path
    would add. If a rank fails, or ``timeout`` seconds pass, every rank is
    killed and this raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spawn: CUDA is not available: pass "
                           "device='cpu' to run the ranks on the CPU")
    tmp = Path(tempfile.mkdtemp(prefix="rtpu_ranks_"))
    procs, logs = [], []
    try:
        with open(tmp / "args.pkl", "wb") as f:
            pickle.dump(tuple(args), f)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(PYTHONPATH=_package_root(), WORLD_SIZE=str(world),
                   OMP_NUM_THREADS="1",
                   GLOO_SOCKET_IFNAME=env.get("GLOO_SOCKET_IFNAME", "lo"))
        t0 = _time.monotonic()
        for r in range(world):
            log = open(tmp / f"rank{r}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "raphtory_tpu_torch.cluster.bootstrap",
                 str(tmp), target, str(dev), "1" if share_card else "0",
                 str(timeout)],
                env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                stdin=subprocess.DEVNULL, stdout=log,
                stderr=subprocess.STDOUT, cwd=str(tmp),
                start_new_session=True))
        deadline = t0 + timeout
        failed = None
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                break
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad and failed is None:
                failed = bad
                # the others may sit in a collective the failed rank never
                # reaches: give them a moment to fail on their own
                deadline = min(deadline, _time.monotonic() + 3.0)
            if _time.monotonic() > deadline:
                break
            _time.sleep(0.05)
        codes = [p.poll() for p in procs]
        if not all(c == 0 for c in codes):
            elapsed = _time.monotonic() - t0
            _kill(procs)
            for log in logs:
                log.flush()
            tails = "\n".join(
                f"--- rank {r} ({_ended(c)}) ---\n"
                + (tmp / f"rank{r}.log").read_text()[-4000:]
                for r, c in enumerate(codes))
            what = (f"rank(s) {failed} failed" if failed
                    else f"timed out after {timeout} s")
            raise RuntimeError(
                f"spawn({target!r}, {world}): {what} after {elapsed:.1f} s; "
                f"every rank was stopped. {_diagnosis(codes)}\n{tails}")
        out = []
        for r in range(world):
            with open(tmp / f"out{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        _kill(procs)
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _ended(code) -> str:
    if code is None:
        return "still running, stopped by spawn"
    if code < 0:
        try:
            return f"killed by {signal.Signals(-code).name}"
        except ValueError:
            return f"killed by signal {-code}"
    return f"exit {code}"


def _machine() -> str:
    """The machine's free memory and load, where ``/proc`` has them."""
    try:
        mem = dict(line.split(":", 1) for line in
                   Path("/proc/meminfo").read_text().splitlines())
        free = int(mem["MemAvailable"].split()[0]) >> 10
        total = int(mem["MemTotal"].split()[0]) >> 10
        load = Path("/proc/loadavg").read_text().split()[:3]
    except (OSError, KeyError, ValueError):
        return "memory and load not readable"
    return (f"MemAvailable {free} of {total} MiB, load {' '.join(load)} on "
            f"{os.cpu_count()} cores")


def _diagnosis(codes) -> str:
    """Why the group ended, as far as the ranks' exits say. ``codes`` are
    read before ``spawn`` stops any rank, so a rank that SIGKILL ended was
    killed from outside the group; ranks that raised beside it most often
    lost it as a peer."""
    killed = [r for r, c in enumerate(codes) if c == -signal.SIGKILL]
    if killed:
        return (f"Rank(s) {killed} were killed by SIGKILL before spawn "
                "stopped the group: something outside the group killed them "
                "(on Linux most often the kernel's out-of-memory killer or a "
                "memory limit of the machine), and a rank that raised beside "
                f"them most often lost its peer. The machine: {_machine()}.")
    return f"The machine: {_machine()}."


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                p.kill()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass


def _rank_main(argv) -> None:
    tmp, target, device, share, timeout = argv
    tmp = Path(tmp)
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    bootstrap(init_method=f"file://{tmp / 'store'}", device=device,
              share_card=share == "1", timeout_s=float(timeout))
    try:
        mod, fn = target.split(":")
        func = getattr(importlib.import_module(mod), fn)
        with open(tmp / "args.pkl", "rb") as f:
            args = pickle.load(f)
        result = func(*args)
        part = tmp / f".out{rank}.pkl"
        with open(part, "wb") as f:
            pickle.dump(result, f)
        os.replace(part, tmp / f"out{rank}.pkl")
        _dist().barrier()
    except BaseException:
        _dist().destroy_process_group()
        raise
    # every rank's result is on disk and the group has met: the rank ends
    # here, without the group's teardown or the interpreter's. gloo's
    # teardown can abort a rank once its peers are gone ("terminate called
    # without an active exception": a rank killed by SIGABRT after the
    # other three had exited 0), which failed a group whose work was done
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    # run as the package's module, not as __main__: the rank's bootstrap
    # state must be the one the rest of the package reads
    from raphtory_tpu_torch.cluster import bootstrap as _module

    _module._rank_main(sys.argv[1:])
