"""Plain PyTorch oracles for the four kernels of the JAX package.

Each ``*_ref`` consumes the same *logical* inputs (an edge list in node ids,
not a blocked format) as its counterpart in the JAX package, so a test can
hold a kernel against the math without going through the kernel's layout.
"""
from __future__ import annotations

import torch

__all__ = ["edge_spmv_ref", "bsr_spmv_ref", "power_step_ref", "seg_mm_ref"]


def edge_spmv_ref(s_pre: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  n: int, weights: torch.Tensor | None = None) -> torch.Tensor:
    """t_i = Σ_{(j→i)∈E} w_e · s_pre_j  (plain scatter-add)."""
    contrib = s_pre[src.long()]
    if weights is not None:
        contrib = contrib * weights
    out = torch.zeros(n, dtype=s_pre.dtype, device=s_pre.device)
    return out.index_add_(0, dst.long(), contrib)


def bsr_spmv_ref(s_pre: torch.Tensor, dense_a: torch.Tensor) -> torch.Tensor:
    """t = s_preᵀ · A as a dense product (small graphs only)."""
    return s_pre @ dense_a


def power_step_ref(s: torch.Tensor, inv_w: torch.Tensor, mu: torch.Tensor,
                   c: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One Alg. 2 iteration + L1 gap: s' = μ ⊙ push(s) + c, gap = ‖s'−s‖₁."""
    t = edge_spmv_ref(s * inv_w, src, dst, n)
    s_new = mu * t + c
    return s_new, torch.sum(torch.abs(s_new - s))


def seg_mm_ref(messages: torch.Tensor, dst: torch.Tensor,
               n: int) -> torch.Tensor:
    """Y[i] = Σ_{e: dst_e = i} M[e]  — segment-sum over feature rows."""
    out = torch.zeros((n,) + tuple(messages.shape[1:]), dtype=messages.dtype,
                      device=messages.device)
    return out.index_add_(0, dst.long(), messages)
