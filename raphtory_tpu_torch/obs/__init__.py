"""Observability of the port: span tracing + flight recorder, the
per-query ledger and kernel registry, the device plane, SLO histograms,
error budgets, per-tenant workload accounts, the freshness plane, the
durable journal and the Prometheus metrics bundle (``obs/metrics.py``,
standard library only).

The port of ``raphtory_tpu/obs/``. Every module here is importable without
a card and without torch; ``obs/advisor.py``, ``obs/sampler.py``,
``obs/cluster.py`` and ``obs/profile.py`` are not ported yet.
"""

from .budget import BUDGET                         # noqa: F401
from .device import RESIDENT, TIMING               # noqa: F401
from .freshness import FRESH                       # noqa: F401
from .ledger import REGISTRY, Ledger, instrument   # noqa: F401
from .metrics import METRICS, Metrics, MetricsServer   # noqa: F401
from .slo import SERIES, SLO                       # noqa: F401
from .trace import TRACER, TraceContext, Tracer, span   # noqa: F401
from .workload import WORKLOAD                     # noqa: F401
