"""Device and dtype resolution shared by every entry point of the port.

The port runs on a CUDA card unless the caller asks for the CPU by name:
``device="cuda"`` is the default everywhere, and asking for it without a card
raises instead of quietly running the plain PyTorch path on the host.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "numpy_dtype"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for but
    absent, or when the device type is neither ``cuda`` nor ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy counterpart of a torch floating dtype."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64; "
                         f"got {dtype}")
    return np.dtype("float32" if dtype == torch.float32 else "float64")
