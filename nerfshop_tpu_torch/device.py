"""The port's default device: the first CUDA card, never a silent CPU."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``cuda:0``; raises when CUDA is absent instead of running on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run the plain versions on the CPU")
    return torch.device("cuda", 0)
