"""Optimizers and learning-rate schedules with the JAX package's update rules.

A port of ``train/optim.py`` (``sgd``, ``adamw``, ``adafactor``) with its
interface::

    opt = adamw(schedule, ...)
    state = opt.init(params)
    params, state = opt.apply(grads, state, params)

Where the leaves are shards of a mesh, ``init`` and ``apply`` take
``layout=`` (a :class:`ShardLayout`: the mesh and each leaf's spec): the
clip's global norm then sums every shard's squares over the groups the
leaf spans, and ``adafactor`` factors a leaf by its global shape and takes
its row, column and RMS means over the whole leaf, so a sharded step is the
one-device step's arithmetic.

``params`` and ``grads`` are trees of nested dicts and lists of tensors
(dict keys visited in sorted order, as JAX flattens them). ``adamw`` keeps
float32 masters, clips by the global norm, reads the schedule at
``step + 1`` and decays as ``master − lr·(u + wd·master)`` — not
``torch.optim.AdamW``, whose eps placement and decay order differ. ``sgd``
reads the schedule at ``step`` (as the JAX package does) and keeps a float32
momentum; ``adafactor`` keeps the JAX package's state tree (``vr``/``vc``
for a factored leaf, else ``v``), β = 1 − t^(−0.8) and the RMS update clip,
in float32. Unlike the
JAX package's pure functions, ``apply`` writes the new values into the
parameter tensors in place (they stay the leaves autograd differentiates)
and returns them. Schedules return a float32 0-d tensor on the CPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..launch.mesh import DP, TP, split

__all__ = ["Optimizer", "ShardLayout", "sgd", "adamw", "adafactor",
           "global_norm", "clip_by_global_norm",
           "cosine_schedule", "linear_schedule", "constant_schedule",
           "tree_leaves", "tree_map"]

Schedule = Callable[[Any], torch.Tensor]


def tree_leaves(tree) -> list[torch.Tensor]:
    """The leaves of a tree of dicts (sorted keys) and lists, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``
    (a tuple is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


# --------------------------------------------------------------------- #
# Schedules
# --------------------------------------------------------------------- #
def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def linear_schedule(lr: float, total_steps: int, warmup: int = 0) -> Schedule:
    def f(step):
        step = _f32(step)
        warm = torch.clamp(step / max(1, warmup), max=1.0)
        decay = torch.clamp(1.0 - (step - warmup) / max(1, total_steps - warmup),
                            min=0.0)
        return lr * warm * torch.where(step <= warmup, 1.0, decay)
    return f


def cosine_schedule(lr: float, total_steps: int, warmup: int = 0,
                    final_frac: float = 0.1) -> Schedule:
    def f(step):
        step = _f32(step)
        warm = torch.clamp(step / max(1, warmup), max=1.0)
        t = torch.clamp((step - warmup) / max(1, total_steps - warmup),
                        0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return lr * warm * cos
    return f


# --------------------------------------------------------------------- #
# Utilities
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """The leaves of a tree as shards of ``mesh``: ``specs`` is a tree of
    the same shape whose leaves are layout specs (a tuple, one axis a
    dimension: ``"model"``, ``"dp"`` or None; see
    :mod:`repro_torch.launch.mesh`)."""
    mesh: Any
    specs: Any

    def _reduce(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum ``x`` over the groups of the split ``axes``."""
        axes = {a for a in axes if a is not None
                and split(self.mesh, a)[0] > 1}
        if axes == {DP, TP}:
            return self.mesh.all_reduce_world(x)
        if axes == {TP}:
            return self.mesh.all_reduce_model(x)
        if axes == {DP}:
            return self.mesh.all_reduce_src(x)
        return x

    def global_shape(self, x: torch.Tensor, spec) -> tuple[int, ...]:
        return tuple(n * split(self.mesh, a)[0] for n, a in zip(
            x.shape, tuple(spec) + (None,) * x.dim()))

    def mean(self, x: torch.Tensor, spec, dim: int,
             keepdim: bool = False) -> torch.Tensor:
        """The mean over ``dim`` of the whole leaf ``x`` is a shard of."""
        n = self.global_shape(x, spec)[dim]
        axis = (tuple(spec) + (None,) * x.dim())[dim % x.dim()]
        return self._reduce(x.sum(dim=dim, keepdim=keepdim), (axis,)) / n

    def mean_all(self, x: torch.Tensor, spec) -> torch.Tensor:
        n = math.prod(self.global_shape(x, spec))
        return self._reduce(x.sum().reshape(1), spec)[0] / n

    def sum_sq(self, tree) -> torch.Tensor:
        """The float32 sum of squares of every leaf, each shard's summed
        over the groups its leaf spans (a replicated leaf counted once)."""
        part = {}
        for x, spec in zip(tree_leaves(tree), tree_leaves(self.specs)):
            key = frozenset(a for a in spec if a is not None
                            and split(self.mesh, a)[0] > 1)
            sq = torch.sum(torch.square(x.float()))
            part[key] = sq if key not in part else part[key] + sq
        total = part.pop(frozenset(), None)
        for key, sq in part.items():
            sq = self._reduce(sq.reshape(1), key)[0]
            total = sq if total is None else total + sq
        return total


def global_norm(tree, layout: ShardLayout | None = None) -> torch.Tensor:
    """The float32 l2 norm of every leaf together (of the whole leaves
    where they are shards of ``layout``)."""
    if layout is not None:
        return torch.sqrt(layout.sum_sq(tree))
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float,
                        layout: ShardLayout | None = None):
    norm = global_norm(tree, layout)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    apply: Callable[[Any, Any, Any], tuple[Any, Any]]
    name: str = "opt"


def _write(params, new):
    """Copy each new value into its parameter tensor (in its dtype)."""
    tree_map(lambda p, x: p.copy_(x.to(p.dtype)), params, new)


# --------------------------------------------------------------------- #
# SGD (+momentum)
# --------------------------------------------------------------------- #
def sgd(schedule: Schedule, momentum: float = 0.9,
        clip_norm: float | None = None) -> Optimizer:
    def init(params, layout=None):
        return dict(step=0, m=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params))

    @torch.no_grad()
    def apply(grads, state, params, *, layout=None):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm, layout)
        lr = schedule(state["step"])
        m = tree_map(lambda m_, g: momentum * m_ + g.float(), state["m"],
                     grads)
        _write(params, tree_map(lambda p, m_: p.float() - lr * m_, params, m))
        return params, dict(step=state["step"] + 1, m=m)

    return Optimizer(init, apply, "sgd")


# --------------------------------------------------------------------- #
# AdamW with fp32 master weights
# --------------------------------------------------------------------- #
def adamw(schedule: Schedule, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: float | None = 1.0,
          keep_master: bool = True) -> Optimizer:
    def init(params, layout=None):
        def zeros32(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        state = dict(step=0, m=tree_map(zeros32, params),
                     v=tree_map(zeros32, params))
        if keep_master:
            state["master"] = tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params)
        return state

    @torch.no_grad()
    def apply(grads, state, params, *, layout=None):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm, layout)
        step = state["step"] + 1
        lr = schedule(step)
        t = _f32(step)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t

        def upd(g, m, v, master):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            master = master - lr * (u + weight_decay * master)
            return m, v, master

        masters = state.get("master") or tree_map(
            lambda p: p.detach().float(), params)
        out = tree_map(upd, grads, state["m"], state["v"], masters)
        m, v, master = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
        tree_map(lambda p, mst: p.copy_(mst), params, master)
        new_state = dict(step=step, m=m, v=v)
        if keep_master:
            new_state["master"] = master
        return params, new_state

    return Optimizer(init, apply, "adamw")



# --------------------------------------------------------------------- #
# Adafactor (factored second moment)
# --------------------------------------------------------------------- #
def _is_factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 8 and shape[-2] >= 8


def adafactor(schedule: Schedule, eps: float = 1e-30,
              clip_threshold: float = 1.0, decay: float = 0.8,
              weight_decay: float = 0.0,
              clip_norm: float | None = 1.0) -> Optimizer:
    def init(params, layout=None):
        def per_param(p, spec=()):
            def z(shape):
                return torch.zeros(shape, dtype=torch.float32,
                                   device=p.device)
            full = p.shape if layout is None else layout.global_shape(p,
                                                                      spec)
            if _is_factored(full):
                return dict(vr=z(p.shape[:-1]),
                            vc=z(p.shape[:-2] + p.shape[-1:]))
            return dict(v=z(p.shape))
        if layout is None:
            return dict(step=0, stats=tree_map(per_param, params))
        return dict(step=0, stats=tree_map(per_param, params,
                                           layout.specs))

    @torch.no_grad()
    def apply(grads, state, params, *, layout=None):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm, layout)
        step = state["step"] + 1
        lr = schedule(step)
        beta = 1.0 - _f32(step) ** (-decay)

        def upd(g, stats, p, spec=None):
            g = g.float()
            g2 = g * g + eps
            if layout is None:
                def mean(x, dim, keepdim=False):
                    return x.mean(dim=dim, keepdim=keepdim)
            else:                   # the means of the whole leaf
                def mean(x, dim, keepdim=False):
                    return layout.mean(x, spec if x.dim() == g.dim()
                                       else spec[:-1], dim, keepdim)
            if "vr" in stats:
                vr = beta * stats["vr"] + (1 - beta) * mean(g2, -1)
                vc = beta * stats["vc"] + (1 - beta) * mean(g2, -2)
                denom = torch.sqrt(
                    vr[..., None] * vc[..., None, :]
                    / (mean(vr, -1, True)[..., None] + eps))
                new_stats = dict(vr=vr, vc=vc)
            else:
                v = beta * stats["v"] + (1 - beta) * g2
                denom = torch.sqrt(v)
                new_stats = dict(v=v)
            u = g / torch.clamp(denom, min=eps)
            # update clipping (Adafactor's RMS rule)
            ms = (torch.mean(u * u) if layout is None
                  else layout.mean_all(u * u, spec))
            rms_u = torch.sqrt(ms + eps)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            p32 = p.float()
            return (p32 - lr * (u + weight_decay * p32), new_stats)

        if layout is None:
            out = tree_map(upd, grads, state["stats"], params)
        else:
            out = tree_map(upd, grads, state["stats"], params, layout.specs)
        _write(params, tree_map(lambda o: o[0], out))
        return params, dict(step=step,
                            stats=tree_map(lambda o: o[1], out))

    return Optimizer(init, apply, "adafactor")
