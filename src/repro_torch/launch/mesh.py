"""A device mesh over ``torch.distributed`` for the 2-D distributed Power-ψ.

The JAX package builds its mesh with ``jax.make_mesh(shape, axis_names)``
and lets ``shard_map`` name the axes a collective runs over. Here every
rank is one process with one device, and :func:`make_mesh` gives each rank
what the sharded step needs:

* its coordinates ``(row, col)`` on the ``d × mo`` grid: ``col`` is the
  ``"model"`` index and ``row`` folds every axis before it (``"pod"`` ×
  ``"data"``), pod-major, as the JAX schedule folds ``src_axes``. Global
  rank ``row · mo + col``.
* the **src group** — the ``d`` ranks of its column, in row order (the
  reduce-scatter of the push and the gap's sum run over it), and the
  **model group** — the ``mo`` ranks of its row, in column order (the
  all-gather of the new iterate runs over it, and the sum that reassembles
  a row-sharded embedding lookup).

Every collective the port issues goes through the :class:`Mesh` methods
below, and only these ``torch.distributed`` names are used:
``reduce_scatter_tensor``, ``all_gather_into_tensor``, ``all_reduce`` and
``new_group`` (present in torch 2.11 and 2.13; 2.13 marks the first two
deprecated, which is silenced here). Each method counts what it issues in
:attr:`Mesh.counts` (calls and result bytes by the JAX dry run's collective
types), which the dry run reads. The sharded LM also gathers over a
**span group**: ``span`` consecutive ranks of a model group
(:meth:`Mesh.span_group`), the ranks whose query heads share one KV head.

:func:`make_production_mesh` is the JAX package's production mesh, 16 × 16
over ``("data", "model")`` or 2 × 16 × 16 over ``("pod", "data",
"model")``, on the 256 or 512 ranks of the caller's process group (the dry
run starts them on ``torch.distributed``'s ``fake`` backend).
:class:`ModelSum` and :class:`SrcSum`, the sums over the model and the src
group with an identity backward, are the autograd functions the model
families share.

Without a process group :func:`make_mesh` starts one of world size 1 on an
in-process ``HashStore`` (no port to collide on) with the backend
``"cpu:gloo,cuda:nccl"`` (``"gloo"`` where torch has no NCCL), and a
multi-rank mesh needs the caller's group (``init_process_group`` under
``torchrun``, or spawned workers). The group :func:`make_mesh` started is
destroyed when the last mesh on it is closed.
"""
from __future__ import annotations

import math
import warnings

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "world_size",
           "COLLECTIVES", "DP", "TP", "split", "shard_shape", "ModelSum",
           "SrcSum"]

# the axes of a layout spec (a tuple with one entry a dimension): TP is the
# model group, DP the src group (the JAX package's ("pod", "data") batch
# axes, folded), None whole on every rank
TP, DP = "model", "dp"

# the collective types of the JAX dry run's records
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# the world group make_mesh started, and how many open meshes use it
_STARTED = {"group": None, "meshes": 0}


def _quiet(fn, *args, **kwargs):
    """Call a collective with torch 2.13's deprecation warning silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kwargs)


class Mesh:
    """One rank's view of a ``("data", "model")`` or ``("pod", "data",
    "model")`` mesh; see the module docstring. Build with
    :func:`make_mesh`."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...],
                 device: torch.device, *, owns_world: bool = False):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(x) for x in shape)))
        self.device = device
        self.world_size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.mo = self.shape["model"]
        self.d = self.world_size // self.mo
        self.row, self.col = divmod(self.rank, self.mo)
        self._groups = []
        # new_group is collective: every rank creates every group, in the
        # same order, and keeps the two it belongs to
        for c in range(self.mo):
            g = self._new_group([r * self.mo + c for r in range(self.d)])
            if c == self.col:
                self.src_group = g
        for r in range(self.d):
            g = self._new_group([r * self.mo + c for c in range(self.mo)])
            if r == self.row:
                self.model_group = g
        self._spans = {self.mo: self.model_group}
        self._owns_world = owns_world
        self._closed = False
        self.reset_counts()

    def _new_group(self, ranks):
        g = dist.new_group(ranks)
        self._groups.append(g)
        return g

    @property
    def src_axes(self) -> tuple[str, ...]:
        return self.axis_names[:-1]

    def span_group(self, span: int):
        """The group of ``span`` consecutive ranks of this rank's model
        group that holds it (``span`` divides ``mo``; the model group when
        ``span == mo``). The groups of a span are made on first use, by
        every rank in the same order, as ``new_group`` requires."""
        if self.mo % span:
            raise ValueError(f"span {span} does not divide model size "
                             f"{self.mo}")
        if span not in self._spans:
            for r in range(self.d):
                for b in range(self.mo // span):
                    g = self._new_group([r * self.mo + b * span + j
                                         for j in range(span)])
                    if r == self.row and b == self.col // span:
                        self._spans[span] = g
        return self._spans[span]

    # -- counters -------------------------------------------------------- #
    def reset_counts(self) -> None:
        """Zero :attr:`counts`: ``{type: {"count", "bytes"}}`` over
        :data:`COLLECTIVES`, the calls and result bytes issued since."""
        self.counts = {c: dict(count=0, bytes=0) for c in COLLECTIVES}

    def _count(self, kind: str, out: torch.Tensor) -> None:
        c = self.counts[kind]
        c["count"] += 1
        c["bytes"] += out.numel() * out.element_size()

    # -- the collectives ------------------------------------------------- #
    def reduce_scatter_src(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the src group; this rank keeps slice ``row`` of
        ``d`` equal slices."""
        return self._reduce_scatter(x.reshape(-1), self.d, self.src_group)

    def reduce_scatter_src_dim(self, x: torch.Tensor,
                               dim: int) -> torch.Tensor:
        """Sum ``x`` over the src group; this rank keeps slice ``row`` of
        ``d`` equal slices along ``dim``."""
        return self._scatter_dim(x, self.d, self.src_group, dim)

    def reduce_scatter_span(self, x: torch.Tensor, span: int,
                            dim: int) -> torch.Tensor:
        """Sum ``x`` over :meth:`span_group`; this rank keeps its slice
        (its place in the span) along ``dim``."""
        return self._scatter_dim(x, span, self.span_group(span), dim)

    def _scatter_dim(self, x, size, group, dim):
        dim %= x.dim()
        shape = list(x.shape)
        part = shape[dim] // size
        parts = x.reshape(shape[:dim] + [size, part] + shape[dim + 1:])
        out = self._reduce_scatter(parts.movedim(dim, 0).reshape(-1), size,
                                   group)
        return out.reshape(shape[:dim] + [part] + shape[dim + 1:])

    def _reduce_scatter(self, flat, size, group):
        out = flat.new_empty(flat.numel() // size)
        _quiet(dist.reduce_scatter_tensor, out, flat.contiguous(),
               group=group)
        self._count("reduce-scatter", out)
        return out

    def all_gather_model(self, x: torch.Tensor) -> torch.Tensor:
        """Concatenate ``x`` over the model group in column order."""
        return self._all_gather(x, self.mo, self.model_group)

    def all_gather_src(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` of every row of this rank's column, stacked ``[d, ...]``."""
        return self._all_gather(x, self.d, self.src_group).reshape(
            (self.d,) + tuple(x.shape))

    def all_gather_src_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` of every row of this rank's column, concatenated along
        ``dim`` in row order."""
        return self._gather_dim(x, self.d, self.src_group, dim)

    def all_gather_span(self, x: torch.Tensor, span: int,
                        dim: int) -> torch.Tensor:
        """``x`` of every rank of :meth:`span_group`, concatenated along
        ``dim`` in column order."""
        return self._gather_dim(x, span, self.span_group(span), dim)

    def all_gather_world(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` of every rank, concatenated in global rank order."""
        return self._all_gather(x, self.world_size, None)

    def _gather_dim(self, x, size, group, dim):
        dim %= x.dim()
        shape = list(x.shape)
        out = self._all_gather(x, size, group).reshape([size] + shape)
        return out.movedim(0, dim).reshape(
            shape[:dim] + [size * shape[dim]] + shape[dim + 1:])

    def _all_gather(self, x, size, group):
        out = x.new_empty(size * x.numel())
        _quiet(dist.all_gather_into_tensor, out, x.contiguous().reshape(-1),
               group=group)
        self._count("all-gather", out)
        return out

    def all_reduce_src(self, x: torch.Tensor,
                       op: str = "sum") -> torch.Tensor:
        """Sum (``op="max"`` / ``"min"``: maximum / minimum) of ``x`` over
        the src group (a new tensor)."""
        return self._all_reduce(x, self.src_group, op)

    def all_reduce_model(self, x: torch.Tensor,
                         op: str = "sum") -> torch.Tensor:
        """Sum (``op="max"`` / ``"min"``: maximum / minimum) of ``x`` over
        the model group (a new tensor)."""
        return self._all_reduce(x, self.model_group, op)

    def all_reduce_world(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of ``x`` over every rank (a new tensor)."""
        return self._all_reduce(x, None)

    def _all_reduce(self, x, group, op: str = "sum"):
        out = x.reshape(-1).clone()
        dist.all_reduce(out, op=dict(sum=dist.ReduceOp.SUM,
                                     max=dist.ReduceOp.MAX,
                                     min=dist.ReduceOp.MIN)[op], group=group)
        self._count("all-reduce", out)
        return out.reshape(x.shape)

    def barrier(self) -> None:
        """Every rank waits here for every other (an all-reduce on the
        mesh's device, read back on the host)."""
        float(self.all_reduce_world(torch.zeros(1, device=self.device))[0])

    # -- lifetime -------------------------------------------------------- #
    def close(self) -> None:
        """Destroy this mesh's groups, and the world group when this mesh
        was the last one on a group :func:`make_mesh` started."""
        if self._closed:
            return
        self._closed = True
        for g in self._groups:
            if g is not None and g != dist.GroupMember.NON_GROUP_MEMBER:
                dist.destroy_process_group(g)
        self._groups = []
        if self._owns_world:
            _STARTED["meshes"] -= 1
            if _STARTED["meshes"] == 0:
                dist.destroy_process_group()
                _STARTED["group"] = None

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank} at (row={self.row}, "
                f"col={self.col}), device={self.device})")


# --------------------------------------------------------------------- #
# Sums with an identity backward (shared by the model families)
# --------------------------------------------------------------------- #
class ModelSum(torch.autograd.Function):
    """Forward: the sum of ``x`` over the mesh's model group. Backward: the
    cotangent as it is, as the transpose of the JAX package's ``psum``
    inside ``shard_map`` leaves a replicated output's cotangent.
    (``torch.distributed.nn.functional.all_reduce`` sums the cotangent over
    the group as well, which would scale every gradient by the model
    size.)"""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_model(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class SrcSum(torch.autograd.Function):
    """Forward: the sum of ``x`` over the src group. Backward: the
    cotangent as it is (a rank's share of a loss summed over the data
    ranks; the gradients are summed over them after the backward)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_src(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def make_mesh(shape: tuple[int, ...],
              axis_names: tuple[str, ...] = ("data", "model"), *,
              device: str | torch.device = "cuda") -> Mesh:
    """This rank's :class:`Mesh` of ``shape`` over ``axis_names``.

    ``axis_names`` must be ``("data", "model")`` or ``("pod", "data",
    "model")``; ``prod(shape)`` must equal the world size of the existing
    process group, or be 1 when there is none (a world-1 group is started).
    """
    dev = resolve_device(device)
    axis_names = tuple(axis_names)
    if axis_names not in (("data", "model"), ("pod", "data", "model")):
        raise ValueError("mesh axes must be ('data', 'model') or ('pod', "
                         f"'data', 'model'); got {axis_names}")
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {tuple(shape)} does not match axes "
                         f"{axis_names}")
    size = math.prod(int(x) for x in shape)
    if not dist.is_initialized():
        if size != 1:
            raise ValueError(
                f"a {tuple(shape)} mesh needs {size} ranks: start the process "
                "group first (torch.distributed.init_process_group, e.g. "
                "under torchrun); without one only a world-1 mesh is made")
        backend = ("cpu:gloo,cuda:nccl" if dist.is_nccl_available()
                   else "gloo")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        # a new group: no mesh uses it yet (one that outlived an earlier
        # group destroyed from outside no longer counts)
        _STARTED.update(group=dist.group.WORLD, meshes=0)
    elif size != dist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} has {size} ranks but the "
                         f"process group has {dist.get_world_size()}")
    owns = _STARTED["group"] is not None \
        and _STARTED["group"] is dist.group.WORLD
    if owns:
        _STARTED["meshes"] += 1
    return Mesh(tuple(shape), axis_names, dev, owns_world=owns)


def make_production_mesh(multi_pod: bool = False, *,
                         device: str | torch.device = "cuda") -> Mesh:
    """This rank's view of the JAX package's production mesh: ``(16, 16)``
    over ``("data", "model")``, or ``(2, 16, 16)`` over ``("pod", "data",
    "model")`` with ``multi_pod``, on the caller's process group of 256 or
    512 ranks."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"),
                         device=device)
    return make_mesh((16, 16), ("data", "model"), device=device)


def split(mesh: Mesh | None, axis: str | None) -> tuple[int, int]:
    """(ranks, this rank's index) of a spec axis; (1, 0) for None or
    without a mesh."""
    if mesh is None or axis is None:
        return 1, 0
    return (mesh.d, mesh.row) if axis == DP else (mesh.mo, mesh.col)


def shard_shape(shape, spec, mesh: Mesh | None) -> tuple[int, ...]:
    """This rank's block shape of an array of ``shape`` laid out by
    ``spec`` (every split must be even), as JAX's ``NamedSharding.
    shard_shape``."""
    out = []
    for n, axis in zip(shape, tuple(spec) + (None,) * len(shape)):
        k, _ = split(mesh, axis)
        if n % k:
            raise ValueError(f"dimension {n} of {tuple(shape)} does not "
                             f"split over {k} ranks ({axis})")
        out.append(n // k)
    return tuple(out)


def world_size() -> int:
    """The process group's world size, 1 when there is none yet."""
    return dist.get_world_size() if dist.is_initialized() else 1

