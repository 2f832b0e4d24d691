"""The port stands alone: no JAX and nothing of the JAX package, and every
entry point refuses to run on a card that is not there."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "raphtory_tpu"}


def _port_sources():
    files = sorted((ROOT / "raphtory_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


#: modules each slice added; the walk above must reach every one of them
SLICE_MODULES = (
    "raphtory_tpu_torch/ops/columns.py",
    "raphtory_tpu_torch/engine/hopbatch.py",
    "raphtory_tpu_torch/ops/minplus.py",
    "raphtory_tpu_torch/algorithms/connected_components.py",
    "raphtory_tpu_torch/algorithms/traversal.py",
    "raphtory_tpu_torch/ops/segment.py",
    "raphtory_tpu_torch/ops/resident.py",
    "raphtory_tpu_torch/engine/bsp.py",
    "raphtory_tpu_torch/engine/device_sweep.py",
    "raphtory_tpu_torch/algorithms/degree.py",
    "raphtory_tpu_torch/core/bulk.py",
    "raphtory_tpu_torch/native/lib.py",
    "raphtory_tpu_torch/ops/partition.py",
    "raphtory_tpu_torch/ops/features.py",
    "raphtory_tpu_torch/engine/features.py",
    "raphtory_tpu_torch/examples/embeddings.py",
    "raphtory_tpu_torch/algorithms/lpa.py",
    "raphtory_tpu_torch/cluster/bootstrap.py",
    "raphtory_tpu_torch/cluster/tasks.py",
    "raphtory_tpu_torch/ops/exchange.py",
    "raphtory_tpu_torch/parallel/sharded.py",
    "raphtory_tpu_torch/parallel/frontier.py",
    "raphtory_tpu_torch/parallel/sweep.py",
    "raphtory_tpu_torch/parallel/columns.py",
    "raphtory_tpu_torch/algorithms/rankings.py",
    "raphtory_tpu_torch/algorithms/flow.py",
    "raphtory_tpu_torch/algorithms/diffusion.py",
    "raphtory_tpu_torch/jobs/live.py",
    "raphtory_tpu_torch/utils/transfer.py",
)


def test_walk_covers_every_slice_module():
    walked = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert set(SLICE_MODULES) <= walked


def _imported_top_levels(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = _imported_top_levels(path) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_unloaded():
    mods = ["raphtory_tpu_torch"] + sorted(
        "raphtory_tpu_torch." + ".".join(p.relative_to(
            ROOT / "raphtory_tpu_torch").with_suffix("").parts)
        for p in (ROOT / "raphtory_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'raphtory_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _tiny_log():
    from raphtory_tpu_torch.core.events import EventLog

    log = EventLog()
    log.add_edge(1, 1, 2)
    log.add_edge(2, 2, 3)
    return log


def test_entry_points_refuse_a_missing_card(monkeypatch):
    from raphtory_tpu_torch.core.service import TemporalGraph
    from raphtory_tpu_torch.engine.hopbatch import (HopBatchedBFS,
                                                    HopBatchedCC,
                                                    HopBatchedPageRank,
                                                    HopBatchedSSSP)
    from raphtory_tpu_torch.jobs.manager import AnalysisManager

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    log = _tiny_log()
    for make in (HopBatchedPageRank, HopBatchedCC,
                 lambda lg: HopBatchedBFS(lg, (1,)),
                 lambda lg: HopBatchedSSSP(lg, (1,), "weight")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(log)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TemporalGraph(log)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AnalysisManager(TemporalGraph(log, device="cpu"))
    from raphtory_tpu_torch.algorithms import PageRank
    from raphtory_tpu_torch.core.snapshot import build_view
    from raphtory_tpu_torch.engine import bsp
    from raphtory_tpu_torch.engine.device_sweep import DeviceSweep

    from raphtory_tpu_torch.examples.embeddings import TemporalEmbeddings

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceSweep(log)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TemporalEmbeddings(log)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bsp.run(PageRank(), build_view(log, 2))
    from raphtory_tpu_torch.parallel.sharded import make_mesh

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(1, 1)
    from raphtory_tpu_torch.cluster.bootstrap import spawn

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spawn("raphtory_tpu_torch.cluster.tasks:run_requests", 2,
              ({"requests": []},), timeout=60)
    # the explicit CPU request is honoured
    assert HopBatchedPageRank(log, device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_a_card():
    """The smoke run exits non-zero, printing no result, when there is no
    card (forced here by hiding every CUDA device)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
