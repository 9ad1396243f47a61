"""Environment fingerprint: make every recorded number interpretable.

A benchmark entry or metrics dump without the torch and CUDA versions, the
device it ran on and the git SHA that produced it is noise across machines.
Every field is best-effort (``None`` on failure) so the fingerprint never
breaks a run. :func:`device_fingerprint` is the part that names one device;
the calibration store keys its samples by it (:func:`repro_torch.obs.
calibrate.env_key`).
"""
from __future__ import annotations

import datetime
import os
import platform
import subprocess

import torch

__all__ = ["environment_fingerprint", "device_fingerprint"]


def _git_sha() -> str | None:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    for cwd in (root, os.getcwd()):
        try:
            out = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                cwd=cwd, capture_output=True, text=True, timeout=5)
            if out.returncode == 0:
                return out.stdout.strip()
        except (OSError, subprocess.SubprocessError):
            pass
    return None


def device_fingerprint(device) -> dict:
    """Platform (``gpu`` / ``cpu``), kind and compute capability of one
    device (``"cuda"``, ``"cuda:1"``, ``"cpu"`` or a ``torch.device``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else 0
        major, minor = torch.cuda.get_device_capability(idx)
        return {"device_platform": "gpu",
                "device_kind": torch.cuda.get_device_name(idx),
                "compute_capability": f"sm_{major}{minor}"}
    if dev.type == "cpu":
        return {"device_platform": "cpu",
                "device_kind": platform.processor() or platform.machine(),
                "compute_capability": None}
    raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")


def environment_fingerprint(device=None) -> dict:
    """Everything needed to compare two runs: versions, device, code
    revision, and a UTC timestamp. ``device`` defaults to the card when
    one is present, else the CPU."""
    fp: dict = {
        "timestamp_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "python": platform.python_version(),
        "platform": platform.platform(),
        "git_sha": _git_sha(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device_count": (torch.cuda.device_count()
                         if torch.cuda.is_available() else 0),
    }
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    try:
        fp.update(device_fingerprint(device))
    except Exception as e:                         # pragma: no cover
        fp["device_error"] = f"{type(e).__name__}: {e}"
    return fp
