"""raphtory_tpu_torch — the PyTorch/CUDA port of raphtory_tpu.

Runs the windowed PageRank Range query end to end on an NVIDIA H100 through
hand-written CUDA kernels (``ops/columns.py``, sources in ``csrc/``), beside
the JAX package it is checked against. It imports torch and numpy, never
JAX. Entry points take ``device=None`` (the CUDA card; raises without one)
or ``device="cpu"``, where every kernel wrapper runs its plain PyTorch twin.
"""

__version__ = "0.1.0"
