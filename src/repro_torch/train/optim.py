"""Optimizers and learning-rate schedules with the JAX package's update rules.

A port of ``train/optim.py`` (``sgd``, ``adamw``, ``adafactor``) with its
interface::

    opt = adamw(schedule, ...)
    state = opt.init(params)
    params, state = opt.apply(grads, state, params)

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

__all__ = ["Optimizer", "sgd", "adamw", "adafactor", "global_norm", "clip_by_global_norm",
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
def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
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
    def init(params):
        return dict(step=0, m=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params))

    @torch.no_grad()
    def apply(grads, state, params):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
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
    def init(params):
        def zeros32(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        state = dict(step=0, m=tree_map(zeros32, params),
                     v=tree_map(zeros32, params))
        if keep_master:
            state["master"] = tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params)
        return state

    @torch.no_grad()
    def apply(grads, state, params):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
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
def _is_factored(p) -> bool:
    return p.dim() >= 2 and p.shape[-1] >= 8 and p.shape[-2] >= 8


def adafactor(schedule: Schedule, eps: float = 1e-30,
              clip_threshold: float = 1.0, decay: float = 0.8,
              weight_decay: float = 0.0,
              clip_norm: float | None = 1.0) -> Optimizer:
    def init(params):
        def per_param(p):
            def z(shape):
                return torch.zeros(shape, dtype=torch.float32,
                                   device=p.device)
            if _is_factored(p):
                return dict(vr=z(p.shape[:-1]),
                            vc=z(p.shape[:-2] + p.shape[-1:]))
            return dict(v=z(p.shape))
        return dict(step=0, stats=tree_map(per_param, params))

    @torch.no_grad()
    def apply(grads, state, params):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state["step"] + 1
        lr = schedule(step)
        beta = 1.0 - _f32(step) ** (-decay)

        def upd(g, stats, p):
            g = g.float()
            g2 = g * g + eps
            if "vr" in stats:
                vr = beta * stats["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * stats["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = torch.sqrt(
                    vr[..., None] * vc[..., None, :]
                    / (vr.mean(dim=-1, keepdim=True)[..., None] + eps))
                new_stats = dict(vr=vr, vc=vc)
            else:
                v = beta * stats["v"] + (1 - beta) * g2
                denom = torch.sqrt(v)
                new_stats = dict(v=v)
            u = g / torch.clamp(denom, min=eps)
            # update clipping (Adafactor's RMS rule)
            rms_u = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            p32 = p.float()
            return (p32 - lr * (u + weight_decay * p32), new_stats)

        out = tree_map(upd, grads, state["stats"], params)
        _write(params, tree_map(lambda o: o[0], out))
        return params, dict(step=step,
                            stats=tree_map(lambda o: o[1], out))

    return Optimizer(init, apply, "adafactor")
