"""Bytes that a ψ solve needs, counted from the inputs' own sizes, and the
card's published peaks.

A Power-ψ step ``s' = μ ⊙ push(s ⊙ 1/w) + c`` with its L1 gap needs, at the
least, every real edge's source id (4 B) and the row structure of the
dst-sorted edge list (4 B a node, n + 1 offsets), and five node vectors of
the working type: s and 1/w read, μ and c read, s' written. The ψ
epilogue ``(λ ⊙ push(s ⊙ 1/w) + d) / N`` reads the same edges and s, 1/w,
λ, d and writes ψ: the same count. No count depends on the program's own
(padded) formats, so it reads the same work whatever computes it.

The bound of a step is its bytes at the card's HBM bandwidth; a share of
it (a roofline share) cannot pass 100% where the kernel reads its edge
list from HBM, which for every cell here is several times the 50 MB L2.
"""
from __future__ import annotations

import subprocess

__all__ = ["PEAKS", "peaks_for", "step_bytes", "power_limit_w"]

#: Published peaks of one card, by a fragment of its
#: ``torch.cuda.get_device_name``: the NVIDIA H100 SXM5 80 GB data sheet,
#: dense rates at the 700 W limit (bytes/s and FLOP/s; the PCIe card, with
#: another bandwidth, is not in the table).
PEAKS = {
    "H100 80GB HBM3": dict(
        hbm_bytes_per_s=3.35e12, fp64_flops=34e12, fp32_flops=67e12,
        tf32_flops=495e12, bf16_flops=989e12, fp8_flops=1979e12,
        int8_ops=1979e12, hbm_bytes=80e9,
        source="NVIDIA H100 SXM5 data sheet"),
}


def peaks_for(kind: str) -> dict | None:
    """The peaks of a card by its ``torch.cuda.get_device_name``; None for a
    card not in the table."""
    for key, peaks in PEAKS.items():
        if key in kind:
            return peaks
    return None


def step_bytes(n: int, m: int, elem: int) -> int:
    """Least bytes of one step, or of the ψ epilogue, on a graph of ``n``
    nodes and ``m`` edges."""
    return 4 * m + 4 * (n + 1) + 5 * n * elem


def power_limit_w() -> float | None:
    """The card's power limit in watts (``nvidia-smi``), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
