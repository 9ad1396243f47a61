"""Device and dtype resolution shared by every entry point of the port.

The port runs on a CUDA card unless the caller asks for the CPU by name:
``device="cuda"`` is the default everywhere, and asking for it without a card
raises instead of quietly running the plain PyTorch path on the host.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "numpy_dtype", "host_array", "host_tensor"]


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


def host_array(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host numpy array; a bfloat16 tensor, which numpy cannot
    hold, as a 2-byte void (``|V2``) array with the same bits: the form in
    which ``np.asarray`` of a JAX ``bfloat16`` array is saved by
    ``np.savez``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def host_tensor(a) -> torch.Tensor:
    """A host numpy array as a CPU tensor. A 2-byte array of kind ``V`` (a
    ``|V2`` array of :func:`host_array` or a checkpoint, or a JAX
    ``bfloat16`` array through ``np.asarray``, whose dtype is
    ``ml_dtypes.bfloat16``) holds bfloat16 bits, which ``torch.tensor``
    rejects: it comes across through its ``int16`` view, bit for bit."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))
