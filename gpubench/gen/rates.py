"""Per-user activity rates: regime (i) of the paper (arXiv:2206.09960, §V),
λ and μ drawn i.i.d. uniform in (low, high), in float64."""
from __future__ import annotations

import torch

__all__ = ["uniform_rates"]


def uniform_rates(n: int, low: float, high: float, gen: torch.Generator,
                  device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(λ, μ), each f64[n] on ``device``, from ``gen``."""
    def draw():
        u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
        return low + (high - low) * u
    lam = draw()
    return lam, draw()
