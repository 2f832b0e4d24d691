"""TemporalGraph — the user-facing handle tying log, watermarks and device.

The single-process equivalent of the reference deployment
(``SingleNodeSetup.scala``): storage + ingestion fence + the device analysis
runs on, behind one object. The watermark fence reproduces the
``TimeCheck``/``TimeResponse`` gate (``AnalysisTask.scala:162-195``): a view
at T is only served as *exact* once every source's watermark has passed T.
"""

from __future__ import annotations

from ..ingestion.watermark import WatermarkRegistry
from ..utils.device import resolve_device
from .events import EventLog


class TemporalGraph:
    """``device`` is where this graph's analyses run: ``None`` means the CUDA
    card (and raises without one); the tests pass ``"cpu"``."""

    def __init__(self, log: EventLog | None = None,
                 watermarks: WatermarkRegistry | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.log = log if log is not None else EventLog()
        self.watermarks = (watermarks if watermarks is not None
                           else WatermarkRegistry())

    @property
    def earliest_time(self) -> int:
        return self.log.min_time

    @property
    def latest_time(self) -> int:
        return self.log.max_time

    def safe_time(self) -> int:
        """Largest timestamp no in-flight source can still mutate."""
        return min(self.watermarks.safe_time(), 2**62)
