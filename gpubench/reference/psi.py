"""The plain ψ-score reference: Power-ψ (Alg. 2 of arXiv:2206.09960) written
straight from the paper's definitions in plain PyTorch.

From an edge list (``src`` follows ``dst``) and the rates λ, μ:

    w_j = Σ_{i ∈ L(j)} (λ_i + μ_i)     c = μ/(λ+μ)     d = λ/(λ+μ)
    s ← μ ⊙ t(s) + c,  t(s)_i = Σ_{(j→i)} s_j / w_j,   from s₀ = c
    ψ = (λ ⊙ t(s) + d) / N

iterated until the largest change of s is below ``rtol`` of the largest s.
The push is one ``index_add_`` a step. Several independent graphs
are one disjoint union; each node's ψ divides by its own graph's N
(``inv_n``, one value a node).

``storage`` is the type every node vector is rounded to after each
operation and ``accumulate`` the type the push sums in: float64 / float64 is
the reference; a narrower storage is the control that a lower-precision
program would be (bfloat16 storage with float32 sums for a float32
configuration, float32 throughout for a float64 one).

It imports nothing of the program under test and takes only the inputs the
benchmark generated.
"""
from __future__ import annotations

import torch

__all__ = ["psi_reference"]


def psi_reference(src: torch.Tensor, dst: torch.Tensor, lam: torch.Tensor,
                  mu: torch.Tensor, inv_n: torch.Tensor, *,
                  storage: torch.dtype = torch.float64,
                  accumulate: torch.dtype = torch.float64,
                  rtol: float = 1e-14, max_iter: int = 3000
                  ) -> tuple[torch.Tensor, int]:
    """(ψ in ``storage`` f[n], iterations) for the union graph; ``src`` and
    ``dst`` are i64 node ids, ``lam``, ``mu``, ``inv_n`` f64[n]; every tensor
    on one device."""
    n = lam.shape[0]

    def st(x):
        return x.to(storage)

    def push(x):                       # t_i = Σ_{(j→i)} x_j, in accumulate
        t = torch.zeros(n, dtype=accumulate, device=lam.device)
        return t.index_add_(0, dst, x.to(accumulate)[src])

    lam_s, mu_s = st(lam), st(mu)
    total = st(lam_s.to(accumulate) + mu_s.to(accumulate))
    w = torch.zeros(n, dtype=accumulate, device=lam.device)
    w = st(w.index_add_(0, src, total.to(accumulate)[dst]))
    inv_w = st(torch.where(w > 0, 1.0 / torch.where(w > 0, w, 1.0), 0.0))
    c = st(torch.where(total > 0, mu_s / torch.where(total > 0, total, 1.0),
                       0.0))
    d = st(torch.where(total > 0, lam_s / torch.where(total > 0, total, 1.0),
                       0.0))
    s = c
    it = 0
    while it < max_iter:
        s_new = st(mu_s * st(push(st(s * inv_w))) + c)
        change = float((s_new - s).abs().max())
        s, it = s_new, it + 1
        if change <= rtol * float(s.abs().max()):
            break
    psi = st(st(lam_s * st(push(st(s * inv_w))) + d) * st(inv_n))
    return psi, it
