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
    from raphtory_tpu_torch.engine.hopbatch import HopBatchedPageRank
    from raphtory_tpu_torch.jobs.manager import AnalysisManager

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    log = _tiny_log()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HopBatchedPageRank(log)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TemporalGraph(log)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AnalysisManager(TemporalGraph(log, device="cpu"))
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
