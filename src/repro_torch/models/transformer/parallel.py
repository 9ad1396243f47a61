"""The LM family's collectives over a :class:`~repro_torch.launch.mesh.Mesh`,
as autograd functions: the counterpart of what GSPMD and ``shard_map``
insert for the JAX package's ``param_specs`` layout (the family-neutral
sums, ``ModelSum`` and ``SrcSum``, live beside the mesh).

Tensor parallelism (TP) runs over the model group, Megatron style: the
residual stream is whole on every model rank, a block's input enters the
TP region through :func:`to_tp` (identity forward, model-group sum of the
cotangent backward) and its row-split output leaves through :func:`from_tp`
(model-group sum forward, identity backward: the sum is whole on every rank
and the loss counts it once). FSDP weights are gathered over the src group
where a layer uses them (:func:`fsdp_gather`: all-gather forward,
reduce-scatter backward, so the gradient comes back summed over the data
ranks); called inside a rematerialised layer the gather runs again in the
backward, as GSPMD repeats it. :func:`span_gather` gathers a KV projection's
columns over the ranks whose query heads share the head. The vocabulary is
split over the model group: :func:`vocab_embed` is the masked gather plus a
model-group sum, :func:`vocab_xent` the cross-entropy from a max and a
log-sum-exp over the model group.

Every function is the identity (no collective) where its group has one
rank, so a ``(1, 1)`` mesh runs the one-device arithmetic.
"""
from __future__ import annotations

import torch

from ...launch.mesh import ModelSum

__all__ = ["to_tp", "from_tp", "fsdp_gather", "span_gather", "vocab_embed",
           "vocab_xent"]


class _IntoTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_model(grad), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over the src group (``span`` None) or a
    span group; the backward reduce-scatters the cotangent back."""

    @staticmethod
    def forward(ctx, w, mesh, dim, span):
        ctx.mesh, ctx.dim, ctx.span = mesh, dim, span
        if span is None:
            return mesh.all_gather_src_dim(w, dim)
        return mesh.all_gather_span(w, span, dim)

    @staticmethod
    def backward(ctx, grad):
        mesh, dim, span = ctx.mesh, ctx.dim, ctx.span
        if span is None:
            g = mesh.reduce_scatter_src_dim(grad, dim)
        else:
            g = mesh.reduce_scatter_span(grad, span, dim)
        return g, None, None, None


def to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """Enter the TP region: ``x`` whole on every model rank."""
    return x if mesh is None or mesh.mo == 1 else _IntoTP.apply(x, mesh)


def from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """Leave the TP region: the sum of the model ranks' partials."""
    return x if mesh is None or mesh.mo == 1 else ModelSum.apply(x, mesh)


def fsdp_gather(w: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """A weight split over the src group along ``dim``, whole."""
    return w if mesh is None or mesh.d == 1 else _Gather.apply(w, mesh, dim,
                                                                None)


def span_gather(w: torch.Tensor, mesh, span: int, dim: int) -> torch.Tensor:
    """``w`` of the ``span`` ranks of this rank's span group, concatenated
    along ``dim``."""
    return w if span == 1 else _Gather.apply(w, mesh, dim, span)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor,
                mesh) -> torch.Tensor:
    """Rows ``tokens`` of a table whose rows are split over the model group
    (this rank holds rows ``[col · rows, (col + 1) · rows)``): each rank
    gathers the rows it owns, the rest masked to zero, and the model group
    sums them."""
    if mesh is None or mesh.mo == 1:
        return table[tokens]
    rows = table.shape[0]
    rel = tokens - mesh.col * rows
    ok = (rel >= 0) & (rel < rows)
    x = table[torch.clamp(rel, 0, rows - 1)] * ok[..., None].to(table.dtype)
    return ModelSum.apply(x, mesh)


def vocab_xent(logits: torch.Tensor, labels: torch.Tensor,
               mesh) -> torch.Tensor:
    """Per-token ``logsumexp(logits) − logits[label]`` over a vocabulary
    split over the model group (``logits`` this rank's columns, ``labels``
    global ids; a label < 0 reads class 0 and is the caller's to mask).
    The maximum is a model-group max outside the gradient (it cancels in
    the log-sum-exp), the exponentials' sum and the gold logit model-group
    sums."""
    if mesh is None or mesh.mo == 1:
        gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])
        return torch.logsumexp(logits, dim=-1) - gold[..., 0]
    cols = logits.shape[-1]
    with torch.no_grad():
        m = mesh.all_reduce_model(logits.amax(dim=-1), op="max")
    se = ModelSum.apply(torch.exp(logits - m[..., None]).sum(dim=-1), mesh)
    rel = labels.clamp(min=0) - mesh.col * cols
    ok = (rel >= 0) & (rel < cols)
    gold = torch.gather(logits, -1, rel.clamp(0, cols - 1)[..., None])[..., 0]
    gold = ModelSum.apply(gold * ok.to(gold.dtype), mesh)
    return torch.log(se) + m - gold
