"""Device resolution shared by every entry point of the package."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card. Asking for CUDA where there is none
    raises: the package never carries on silently on the CPU — callers that
    want the CPU (the tests, a reference run) pass ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev
