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
FORBIDDEN = {"jax", "jaxlib", "raphtory_tpu", "prometheus_client"}
#: what the port and chip_smoke.py may import at module level, besides the
#: standard library and the port itself: the card's machine has these and
#: nothing more that the port may rely on (triton and the ctypes builds
#: are imported inside the functions that launch a kernel)
MODULE_LEVEL_ALLOWED = {"numpy", "torch", "scipy", "einops",
                        "raphtory_tpu_torch"}


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
    "raphtory_tpu_torch/utils/config.py",
    "raphtory_tpu_torch/analysis/sanitizer.py",
    "raphtory_tpu_torch/obs/journal.py",
    "raphtory_tpu_torch/obs/trace.py",
    "raphtory_tpu_torch/obs/metrics.py",
    "raphtory_tpu_torch/obs/slo.py",
    "raphtory_tpu_torch/obs/freshness.py",
    "raphtory_tpu_torch/obs/device.py",
    "raphtory_tpu_torch/obs/ledger.py",
    "raphtory_tpu_torch/obs/workload.py",
    "raphtory_tpu_torch/obs/budget.py",
    "raphtory_tpu_torch/obs/exitdump.py",
    "raphtory_tpu_torch/resilience/breaker.py",
    "raphtory_tpu_torch/resilience/degrade.py",
    "raphtory_tpu_torch/resilience/faults.py",
    "raphtory_tpu_torch/resilience/policy.py",
    "raphtory_tpu_torch/jobs/registry.py",
    "raphtory_tpu_torch/jobs/sink.py",
    "raphtory_tpu_torch/jobs/scheduler.py",
    "raphtory_tpu_torch/jobs/rest.py",
    "raphtory_tpu_torch/ingestion/watermark.py",
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


def _module_level_top_levels(path: Path) -> set[str]:
    """Top-level names of the absolute imports a module runs when it is
    imported: its own statements, those under ``if`` / ``try`` at module
    level, not those inside a function or class."""
    names = set()
    todo = list(ast.parse(path.read_text(), str(path)).body)
    while todo:
        node = todo.pop()
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, (ast.If, ast.Try, ast.With)):
            for field in ("body", "orelse", "finalbody", "handlers"):
                todo.extend(getattr(node, field, []) or [])
        elif isinstance(node, ast.ExceptHandler):
            todo.extend(node.body)
    return names


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_module_level_imports_are_stdlib_numpy_torch(path):
    """At module level the port and chip_smoke.py import only the
    standard library, numpy, torch, scipy, einops and the port: nothing a
    card's machine lacks (no prometheus_client: ``obs/metrics`` writes the
    exposition itself)."""
    bad = {n for n in _module_level_top_levels(path)
           if n not in sys.stdlib_module_names
           and n not in MODULE_LEVEL_ALLOWED}
    assert not bad, f"{path} imports {bad} at module level"


def test_the_module_level_check_refuses_prometheus(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom prometheus_client import Counter\n"
                 "def g():\n    import triton\n")
    assert _module_level_top_levels(f) == {"os", "prometheus_client"}
    assert "prometheus_client" in FORBIDDEN


def test_import_leaves_jax_unloaded():
    mods = ["raphtory_tpu_torch"] + sorted(
        "raphtory_tpu_torch." + ".".join(p.relative_to(
            ROOT / "raphtory_tpu_torch").with_suffix("").parts)
        for p in (ROOT / "raphtory_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'raphtory_tpu', 'prometheus_client')]\n"
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
