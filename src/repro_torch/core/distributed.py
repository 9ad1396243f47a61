"""Distributed Power-ψ over ``torch.distributed``: the 2-D block-cyclic
schedule of the JAX package's ``shard_map`` program, one rank a block.

One iteration on the (pod ×) data × model mesh (:mod:`repro_torch.launch.
mesh`), rank (r, c) holding block (r, c) of the edges and row r of the
iterate in the block-cyclic src layout:

  1. local push       — gather s·(1/w) by local src ids, segment sum over
                        the dst-sorted runs onto the local dst block
                        (``torch.segment_reduce``, lengths from the host;
                        no atomics)                               [compute]
  2. reduce-scatter   — over the src group (the ranks of column c, in row
                        order); the slice rank r keeps IS piece (r, c) of
                        the src layout (no reshuffling)        [collective]
  3. epilogue         — s'_piece = μ_piece ⊙ t_piece + c_piece   [compute]
  4. all-gather       — over the model group (the ranks of row r, in column
                        order): row r reassembles its shard of s'
                                                                [collective]
  5. gap              — local l1 of Δs, all-reduced over the src group
                                                                   [scalar]

Each rank moves Nc values in the reduce-scatter and N/d in the all-gather.
The code that runs on one card (a world-1 mesh over NCCL) is the code that
the gloo tests run across ranks: there is no single-rank shortcut around
the collectives.

``s`` is the entire algorithm state; the driver in
:mod:`repro_torch.runtime` checkpoints it every chunk and a restart
warm-starts the contraction exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import numpy_dtype
from ..graphs.partition import Partition2D, partition_2d
from ..graphs.structure import Graph
from ..launch.mesh import DP, TP, Mesh, shard_shape
from .activity import Activity

__all__ = ["DistributedPsi", "DistributedPsi1D", "DistPsiArrays",
           "PartialReduction", "BlockOverflowError"]


class BlockOverflowError(RuntimeError):
    """An edge insert does not fit a partition block's ``e_max`` capacity.

    Carries which (row, col) block overflowed and the capacity the insert
    would need, so callers can regrow the partition deliberately instead of
    guessing from a silent failure.
    """

    def __init__(self, block: tuple[int, int], e_max: int, required: int):
        self.block = block
        self.e_max = e_max
        self.required = required
        super().__init__(
            f"distributed edge block (row={block[0]}, col={block[1]}) "
            f"overflows e_max={e_max}: the insert requires capacity "
            f">= {required}; regrow the partition (re-prepare) or construct "
            f"the engine with on_overflow='regrow'")


@dataclasses.dataclass(frozen=True)
class PartialReduction:
    """Explicit handle between the dispatch and finalize halves of one
    sharded iteration: this rank's un-reduced dst partials plus the iterate
    they were pushed from (the finalize half needs it for the gap).

    Produced by :meth:`DistributedPsi.make_dispatch`, consumed by
    :meth:`DistributedPsi.make_finalize`; composing the two is bitwise the
    fused :meth:`DistributedPsi.make_step`. The split exists so an
    overlapped executor can issue the next dispatch (pure local compute)
    while a previous finalize (the collective half) is still in flight.
    """

    partial_t: torch.Tensor   # f[nc]   — pre-reduction dst partials
    s_in: torch.Tensor        # f[mo·q] — src-layout row the push read


@dataclasses.dataclass(frozen=True)
class DistPsiArrays:
    """One rank's block (r, c) of the sharded operators, on its device."""

    src_local: torch.Tensor   # i64[e_max] local src ids; sentinel mo·q
    lengths: torch.Tensor     # i64[nc+1] dst run lengths (sentinel last)
    inv_w_src: torch.Tensor   # f[mo·q] row r of 1/w, block-cyclic src layout
    mu_piece: torch.Tensor    # f[q]    piece (r, c)
    c_piece: torch.Tensor     # f[q]
    c_src: torch.Tensor       # f[mo·q] row r of s₀ = c, src layout
    lam_piece: torch.Tensor   # f[q]    for the ψ epilogue
    d_piece: torch.Tensor     # f[q]


def block_arrays(fields: dict, row: int, col: int, nc: int,
                 dtype: torch.dtype, device) -> DistPsiArrays:
    """Block (row, col) from the global host layouts (the fields of the
    JAX package's ``DistPsiArrays``: ``src_local``/``dst_local``
    ``[d, mo, e_max]``, ``inv_w_src``/``c_src`` ``[d, mo·q]``, the pieces
    ``[d, mo, q]``)."""
    np_dtype = numpy_dtype(dtype)

    def vec(x):
        return torch.tensor(np.asarray(x, np_dtype), device=device)

    def idx(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    return DistPsiArrays(
        src_local=idx(fields["src_local"][row, col]),
        lengths=idx(np.bincount(fields["dst_local"][row, col],
                                minlength=nc + 1)),
        inv_w_src=vec(fields["inv_w_src"][row]),
        mu_piece=vec(fields["mu_piece"][row, col]),
        c_piece=vec(fields["c_piece"][row, col]),
        c_src=vec(fields["c_src"][row]),
        lam_piece=vec(fields["lam_piece"][row, col]),
        d_piece=vec(fields["d_piece"][row, col]))


class DistributedPsi:
    """Power-ψ sharded over a ("data","model") or ("pod","data","model")
    mesh; this object is one rank's part."""

    def __init__(self, part: Partition2D, mesh: Mesh, *,
                 dtype: torch.dtype = torch.float32,
                 arrays: DistPsiArrays | None = None):
        self.part = part
        self.mesh = mesh
        self.dtype = dtype
        if mesh.axis_names[-2:] != ("data", "model"):
            raise ValueError(f"mesh must end in (data, model); got "
                             f"{mesh.axis_names}")
        self.src_axes = mesh.src_axes
        if mesh.d != part.d or mesh.mo != part.mo:
            raise ValueError("partition grid does not match mesh shape")
        self.arrays = arrays

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    # ------------------------------------------------------------------ #
    @classmethod
    def from_graph(cls, graph: Graph, activity: Activity, mesh: Mesh, *,
                   dtype: torch.dtype = torch.float32) -> "DistributedPsi":
        part = partition_2d(graph, mesh.d, mesh.mo)
        self = cls(part, mesh, dtype=dtype)
        self.arrays = self.build_arrays(graph, activity)
        return self

    def host_layouts(self, graph: Graph, activity: Activity) -> dict:
        """Every block's operators in the partitioned host layouts: the
        JAX package's ``build_arrays`` before its device put."""
        p = self.part
        np_dtype = numpy_dtype(self.dtype)
        lam = activity.lam.astype(np_dtype)
        mu = activity.mu.astype(np_dtype)
        total = lam + mu
        w = np.zeros(graph.n, np_dtype)
        np.add.at(w, graph.src, total[graph.dst])
        inv_w = np.where(w > 0, 1.0 / np.where(w > 0, w, 1), 0).astype(np_dtype)
        with np.errstate(divide="ignore", invalid="ignore"):
            c = np.where(total > 0, mu / total, 0.0).astype(np_dtype)
            dd = np.where(total > 0, lam / total, 0.0).astype(np_dtype)
        return dict(
            src_local=p.src_local, dst_local=p.dst_local,
            inv_w_src=p.to_src_layout(inv_w), mu_piece=p.to_piece_layout(mu),
            c_piece=p.to_piece_layout(c), c_src=p.to_src_layout(c),
            lam_piece=p.to_piece_layout(lam), d_piece=p.to_piece_layout(dd))

    def build_arrays(self, graph: Graph, activity: Activity) -> DistPsiArrays:
        """Host-side operator build in partitioned layouts → this rank's
        block on its device."""
        return block_arrays(self.host_layouts(graph, activity),
                            self.mesh.row, self.mesh.col, self.part.nc,
                            self.dtype, self.device)

    # -- layout ------------------------------------------------------------ #
    def input_specs(self) -> dict:
        """Each operator array's global (shape, dtype), in the JAX
        package's layout (``input_specs``), no allocation. The push reads
        each block's dst run ``lengths`` ``[d, mo, nc + 1]`` where the JAX
        package reads ``dst_local``."""
        p = self.part
        i64, f = torch.int64, self.dtype
        grid, row = (p.d, p.mo, p.q), (p.d, p.mo * p.q)
        return dict(src_local=((p.d, p.mo, p.e_max), i64),
                    lengths=((p.d, p.mo, p.nc + 1), i64),
                    inv_w_src=(row, f), mu_piece=(grid, f),
                    c_piece=(grid, f), c_src=(row, f),
                    lam_piece=(grid, f), d_piece=(grid, f))

    def shardings(self) -> dict:
        """Each array's spec (the JAX package's ``shardings()``): a block
        array's leading ``[d, mo]`` split over the src and model groups, a
        src-layout row's ``d`` over the src group (whole on every model
        rank). Rank ``(row, col)`` holds block ``(row, col)``."""
        grid, row = (DP, TP, None), (DP, None)
        return dict(src_local=grid, lengths=grid, inv_w_src=row,
                    mu_piece=grid, c_piece=grid, c_src=row, lam_piece=grid,
                    d_piece=grid)

    def local_specs(self) -> dict:
        """This rank's (shape, dtype) of each array: its block of the
        global layout (:meth:`shard_shape`-sized, the unit ``[d, mo]``
        dimensions dropped, as :class:`DistPsiArrays` holds it)."""
        spec = self.shardings()
        out = {}
        for k, (shape, dtype) in self.input_specs().items():
            block = shard_shape(shape, spec[k], self.mesh)
            out[k] = (block[sum(a is not None for a in spec[k]):], dtype)
        return out

    # -- host layout ⇄ this rank's row ---------------------------------- #
    def local_src(self, full: np.ndarray) -> torch.Tensor:
        """Row r of a ``[d, mo·q]`` src-layout host array, on the device."""
        return torch.tensor(
            np.asarray(full, numpy_dtype(self.dtype))[self.mesh.row],
            device=self.device)

    def gather_src(self, s: torch.Tensor) -> np.ndarray:
        """Every row of the src-layout iterate, ``[d, mo·q]`` on the host
        (an all-gather over the src group; the same on every rank)."""
        return self.mesh.all_gather_src(s).cpu().numpy()

    def gather_psi(self, psi_piece: torch.Tensor) -> np.ndarray:
        """ψ in node order on every rank from each rank's dst piece (an
        all-gather over every rank; rank order is (row, col) row-major, so
        the pieces stack as ``[d, mo, q]``)."""
        pieces = self.mesh.all_gather_world(psi_piece).cpu().numpy()
        return self.part.from_src_layout(pieces.reshape(self.part.d, -1))

    def l1(self, x: torch.Tensor) -> float:
        """Global l1 norm of a src-layout row vector (rows summed over the
        src group)."""
        return float(self.mesh.all_reduce_src(
            torch.sum(torch.abs(x)).reshape(1))[0])

    # ------------------------------------------------------------------ #
    def _local_push(self, s: torch.Tensor, a: DistPsiArrays) -> torch.Tensor:
        """Dispatch half's local math: gather s·(1/w) by local src ids,
        segment sum over the dst-sorted runs onto the local dst block (the
        sentinel run dropped). Pure compute — no collectives."""
        s_pre = torch.cat([s * a.inv_w_src, s.new_zeros(1)])
        t = torch.segment_reduce(s_pre[a.src_local], "sum",
                                 lengths=a.lengths, unsafe=True)
        return t[:self.part.nc]

    def _local_finish(self, partial_t: torch.Tensor, s: torch.Tensor,
                      a: DistPsiArrays):
        """Finalize half's local math: reduce-scatter the partials (the
        slice kept IS piece (r, c)), μ/c epilogue, all-gather over the
        model group, l1 gap against the input iterate summed over the src
        group."""
        mesh = self.mesh
        t_piece = mesh.reduce_scatter_src(partial_t)
        s_new = mesh.all_gather_model(a.mu_piece * t_piece + a.c_piece)
        gap = mesh.all_reduce_src(torch.sum(torch.abs(s_new - s)).reshape(1))
        return s_new, gap[0]

    def make_step(self):
        """One iteration ``(s_row, arrays) → (s'_row, gap)``: the fused
        composition of :meth:`make_dispatch` and :meth:`make_finalize`."""

        def step(s, a: DistPsiArrays):
            return self._local_finish(self._local_push(s, a), s, a)

        return step

    def make_dispatch(self):
        """Compute-only half: ``(s_row, arrays) →``
        :class:`PartialReduction`. No collectives are issued."""

        def dispatch(s, a: DistPsiArrays):
            return PartialReduction(partial_t=self._local_push(s, a), s_in=s)

        return dispatch

    def make_finalize(self):
        """Collective half: ``(PartialReduction, arrays) → (s'_row, gap)``
        — exactly the tail of :meth:`make_step`."""

        def finalize(h: PartialReduction, a: DistPsiArrays):
            return self._local_finish(h.partial_t, h.s_in, a)

        return finalize

    def make_epilogue(self):
        """ψ from converged s: one more push, then (λ⊙t + d)/N — this
        rank's dst piece ``f[q]`` (:meth:`gather_psi` assembles node
        order)."""
        n = self.part.n

        def epilogue(s, a: DistPsiArrays):
            t_piece = self.mesh.reduce_scatter_src(self._local_push(s, a))
            return (a.lam_piece * t_piece + a.d_piece) / n

        return epilogue

    # ------------------------------------------------------------------ #
    def make_run(self, *, chunk_iters: int = 8):
        """``(s, arrays) → (s', gap)``: ``chunk_iters`` steps; ``gap`` (a
        device scalar) is the last step's. The driver reads it once a chunk
        and loops chunks until gap ≤ tol, checkpointing between chunks.
        The loop runs in Python, unrolled (the JAX package's ``unroll``
        flag, which the dry run's 1- and 2-iteration probes set, has no
        counterpart)."""
        step = self.make_step()

        def run(s, arrays):
            gap = None
            for _ in range(chunk_iters):
                s, gap = step(s, arrays)
            return s, gap

        return run

    def run_to_convergence(self, *, tol: float = 1e-9, max_iter: int = 2000,
                           chunk_iters: int = 16,
                           b_norm: float | None = None):
        """Host-driven convergence loop. Returns (psi [n] in node order on
        every rank, iters, gap)."""
        if self.arrays is None:
            raise ValueError("no device arrays; use from_graph()")
        run = self.make_run(chunk_iters=chunk_iters)
        s = self.arrays.c_src
        scale = 1.0 if b_norm is None else b_norm
        it = 0
        gap = np.inf
        while it < max_iter:
            s, gap_dev = run(s, self.arrays)
            it += chunk_iters
            gap = float(gap_dev) * scale
            if gap <= tol:
                break
        psi = self.gather_psi(self.make_epilogue()(s, self.arrays))
        return psi, it, gap


class DistributedPsi1D:
    """Paper-faithful distributed baseline (§III: 'can even be calculated
    distributedly'): edges sharded across all ranks, s **replicated**, one
    full-vector all-reduce per iteration.

    The natural 1-D reading of the paper's distribution remark, kept as the
    comparison point for the 2-D block-cyclic schedule: per rank the 1-D
    all-reduce moves ~2·N values per iteration against the 2-D scheme's Nc
    (reduce-scatter) + N/d (all-gather).
    """

    def __init__(self, graph: Graph, activity: Activity, mesh: Mesh, *,
                 dtype: torch.dtype = torch.float32):
        self.mesh = mesh
        self.dtype = dtype
        self.n_dev = mesh.world_size
        self.n = graph.n
        self.n_pad = -(-graph.n // 128) * 128
        np_dtype = numpy_dtype(dtype)
        act_l = activity.lam.astype(np_dtype)
        act_m = activity.mu.astype(np_dtype)
        total = act_l + act_m
        w = np.zeros(graph.n, np_dtype)
        np.add.at(w, graph.src, total[graph.dst])
        inv_w = np.where(w > 0, 1.0 / np.where(w > 0, w, 1), 0)

        def pad(v):
            return torch.tensor(np.concatenate(
                [v.astype(np_dtype),
                 np.zeros(self.n_pad - graph.n, np_dtype)]),
                device=mesh.device)

        with np.errstate(divide="ignore", invalid="ignore"):
            c = np.where(total > 0, act_m / total, 0.0)
        # edges in contiguous dst-sorted runs over ranks; this rank's run
        src, dst = graph.edges_by_dst
        per = -(-graph.m // self.n_dev)
        self.e_max = -(-per // 128) * 128
        lo = min(mesh.rank * per, graph.m)
        hi = min(lo + per, graph.m)
        es = np.full(self.e_max, self.n_pad, np.int64)
        ed = np.full(self.e_max, self.n_pad, np.int64)
        es[:hi - lo] = src[lo:hi]
        ed[:hi - lo] = dst[lo:hi]
        dev = mesh.device
        self.arrays = dict(
            src=torch.as_tensor(es, device=dev),
            lengths=torch.as_tensor(np.bincount(ed, minlength=self.n_pad + 1),
                                    device=dev),
            inv_w=pad(inv_w), mu=pad(act_m), c=pad(c))

    def make_step(self):
        """``(s, arrays) → s'``: the replicated iterate's next value; the
        convergence gap is the caller's (from s' and s)."""
        n_pad = self.n_pad

        def step(s, a):
            s_pre = torch.cat([s * a["inv_w"], s.new_zeros(1)])
            partial = torch.segment_reduce(
                s_pre[a["src"]], "sum", lengths=a["lengths"],
                unsafe=True)[:n_pad]
            return a["mu"] * self.mesh.all_reduce_world(partial) + a["c"]

        return step
