"""raphtory_tpu_torch — the PyTorch/CUDA port of raphtory_tpu.

Runs the windowed PageRank, ConnectedComponents and BFS / weighted-SSSP
Range queries (on the delta and the host-column fold routes), the
bulk-loaded scale PageRank sweep (``core/bulk.py``), View queries and
Range queries of any supported program through the generic vertex-program
engine (LabelPropagation's custom exchange included), and the windowed
feature aggregation (``engine/features.py``, ``examples/embeddings.py``),
end to end on an NVIDIA H100 through hand-written CUDA kernels
(``ops/columns.py``, ``ops/minplus.py``, ``ops/segment.py``,
``ops/resident.py``, ``ops/features.py``, sources in ``csrc/``), beside the
JAX package it is checked against. It imports torch and numpy, never
JAX. Entry points take ``device=None`` (the CUDA card; raises without one)
or ``device="cpu"``, where every kernel wrapper runs its plain PyTorch twin.
"""

__version__ = "0.1.0"
