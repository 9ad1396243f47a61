"""Carry state across from the JAX package as numpy arrays.

The caller turns each field of a JAX object into numpy (``np.asarray``) and
hands the fields over as a mapping, e.g. for a JAX ``PsiOperators``::

    fields = {f.name: np.asarray(getattr(ops, f.name))
              for f in dataclasses.fields(ops)}
    ops_t = operators_from_numpy(fields, device="cuda")

Nothing here imports either package's JAX side; the formats are the same
arrays in both packages, so the device objects are rebuilt from them.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .core.operators import PsiOperators, _edge_tensors
from .device import host_array, host_tensor, numpy_dtype, resolve_device
from .kernels.formats import BsrFormat, EdgeTileFormat
from .kernels.ops import DeviceBsr, DeviceEdgeTiles

__all__ = ["operators_from_numpy", "edge_tiles_from_numpy", "bsr_from_numpy",
           "warm_start_from_numpy", "gnn_params_from_numpy",
           "sage_params_from_numpy", "lm_params_from_numpy",
           "lm_params_to_numpy", "mind_params_from_jax",
           "dist_arrays_from_numpy", "chunk_args_from_numpy"]


def _host_fields(fields: Mapping, names) -> dict:
    """Scalars as Python ints (0-d arrays after ``np.asarray``), arrays as
    numpy arrays."""
    return {k: int(fields[k]) if np.ndim(fields[k]) == 0
            else np.asarray(fields[k]) for k in names}


def _vec(x, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, numpy_dtype(dtype)), device=device)


def operators_from_numpy(fields: Mapping, *, dtype: torch.dtype | None = None,
                         device: str | torch.device = "cuda") -> PsiOperators:
    """A :class:`PsiOperators` from the fields of the JAX package's
    ``PsiOperators`` (``n``, ``m``, both sorted edge views ``src_by_dst``,
    ``dst_by_dst``, ``src_by_src``, ``dst_by_src``, and ``lam``, ``mu``,
    ``inv_w``, ``c``, ``d``, ``b_norm``). ``dtype`` defaults to the dtype of
    ``lam``."""
    dev = resolve_device(device)
    lam = np.asarray(fields["lam"])
    if dtype is None:
        dtype = torch.float64 if lam.dtype == np.float64 else torch.float32
    n = int(fields["n"])
    return PsiOperators(
        n=n, m=int(fields["m"]),
        **_edge_tensors(n, *(np.asarray(fields[k]) for k in (
            "src_by_dst", "dst_by_dst", "src_by_src", "dst_by_src")), dev),
        **{k: _vec(fields[k], dtype, dev)
           for k in ("lam", "mu", "inv_w", "c", "d", "b_norm")})


def edge_tiles_from_numpy(fields: Mapping, *,
                          device: str | torch.device = "cuda"
                          ) -> DeviceEdgeTiles:
    """A :class:`DeviceEdgeTiles` from the fields of the JAX package's
    ``DeviceEdgeTiles`` (or ``EdgeTileFormat``). The JAX gather pad
    (``n_gather``) is not carried over: this package uses its own."""
    fmt = EdgeTileFormat(**_host_fields(
        fields, [f.name for f in dataclasses.fields(EdgeTileFormat)]))
    return DeviceEdgeTiles.from_format(fmt, device)


def bsr_from_numpy(fields: Mapping, *,
                   device: str | torch.device = "cuda") -> DeviceBsr:
    """A :class:`DeviceBsr` from the fields of the JAX package's
    ``DeviceBsr`` (or ``BsrFormat``)."""
    names = {f.name for f in dataclasses.fields(BsrFormat)} - {"n_dst_pad"}
    fmt = BsrFormat(**_host_fields(fields, names),
                    n_dst_pad=int(fields["num_dst_tiles"]) * int(fields["td"]))
    return DeviceBsr.from_format(fmt, device)


def warm_start_from_numpy(s: np.ndarray, *, dtype: torch.dtype = torch.float32,
                          device: str | torch.device = "cuda") -> torch.Tensor:
    """A node-order series vector (e.g. a JAX ``PsiResult.s``) that any
    engine's ``run(s0=...)`` accepts."""
    return _vec(s, dtype, resolve_device(device))


def gnn_params_from_numpy(tree, *, dtype: torch.dtype | None = None,
                          device: str | torch.device = "cuda"):
    """Any GNN parameter tree of the JAX package as numpy
    (``jax.tree.map(np.asarray, params)`` of ``sage``, ``pna``, ``nequip``
    or ``equiformer_v2``'s ``init_params``): the same nesting of dicts and
    lists and the same ``w[d_in, d_out]`` layout, so nothing is transposed.
    Every leaf becomes a tensor that requires grad; ``dtype`` defaults to
    the arrays' own."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return torch.tensor(np.asarray(t), dtype=dtype,
                            device=dev).requires_grad_()

    return conv(tree)


def sage_params_from_numpy(tree, *, dtype: torch.dtype | None = None,
                           device: str | torch.device = "cuda") -> dict:
    """GraphSAGE parameters from the JAX package's ``sage.init_params`` tree
    as numpy: :func:`gnn_params_from_numpy`."""
    return gnn_params_from_numpy(tree, dtype=dtype, device=device)


def lm_params_from_numpy(tree, *, dtype: torch.dtype | None = None,
                         device: str | torch.device = "cuda") -> dict:
    """LM parameters from the JAX package's ``transformer.init_params``
    tree as numpy (``jax.tree.map(np.asarray, params)``): the same dict of
    stacked ``[L, …]`` leaves in the same ``w[d_in, d_out]`` layout, nothing
    transposed; bfloat16 leaves bit for bit (:func:`~repro_torch.device.
    host_tensor`).
    Every leaf becomes a tensor that requires grad; ``dtype`` defaults to
    the arrays' own."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return host_tensor(t).to(device=dev, dtype=dtype).requires_grad_()

    return conv(tree)


MIND_LEAVES = ("item_emb", "profile_emb", "bilinear", "profile_proj",
               "b_init")


def mind_params_from_jax(tree, *, dtype: torch.dtype | None = None,
                         device: str | torch.device = "cuda") -> dict:
    """MIND parameters from the JAX package's ``mind.init_params`` tree as
    numpy (``jax.tree.map(np.asarray, params)``): the five leaves, same
    names and layout, bit for bit at their own dtype. Every leaf becomes a
    tensor that requires grad; ``dtype`` defaults to the arrays' own."""
    dev = resolve_device(device)
    if set(tree) != set(MIND_LEAVES):
        raise ValueError(f"a MIND tree has the leaves {MIND_LEAVES}; got "
                         f"{sorted(tree)}")
    return {k: torch.tensor(np.asarray(tree[k]), dtype=dtype,
                            device=dev).requires_grad_()
            for k in MIND_LEAVES}


def lm_params_to_numpy(params: dict) -> dict:
    """The tree of :func:`lm_params_from_numpy` back as numpy arrays, for
    the JAX package; a bfloat16 leaf as a 2-byte void array with the same
    bits (as the checkpoint stores it: ``.view(ml_dtypes.bfloat16)`` reads
    it)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return host_array(t)

    return conv(params)


def dist_arrays_from_numpy(fields: Mapping, *, row: int, col: int,
                           dtype: torch.dtype | None = None,
                           device: str | torch.device = "cuda"):
    """One rank's block ``(row, col)`` of the distributed operators
    (:class:`~repro_torch.core.distributed.DistPsiArrays`) from the fields
    of the JAX package's ``DistPsiArrays`` as numpy (the global arrays:
    ``src_local``/``dst_local`` ``[d, mo, e_max]``, ``inv_w_src``/``c_src``
    ``[d, mo·q]``, the pieces ``[d, mo, q]``). The dst run lengths are
    counted here from ``dst_local``. ``dtype`` defaults to the arrays'."""
    from .core.distributed import block_arrays
    fields = {k: np.asarray(v) for k, v in fields.items()}
    if dtype is None:
        dtype = (torch.float64 if fields["mu_piece"].dtype == np.float64
                 else torch.float32)
    d, _, q = fields["mu_piece"].shape
    nc = d * q                                  # n_pad / mo
    return block_arrays(fields, row, col, nc, dtype, resolve_device(device))


def chunk_args_from_numpy(fields: Mapping, *, q: int,
                          device: str | torch.device = "cuda"):
    """A :class:`~repro_torch.asyncexec.scheduler.ChunkArgs` from the
    fields of the JAX package's ``ChunkArgs`` as numpy (``src``,
    ``dst_local``, ``mu``, ``c``, ``inv_w``, ``start``): the dst run
    lengths (``q`` real runs, then the sentinel run) are counted here from
    ``dst_local``; the dtype is the arrays'."""
    from .asyncexec.scheduler import ChunkArgs
    dev = resolve_device(device)

    def t(k, dt=None):
        return torch.tensor(np.asarray(fields[k], dt), device=dev)

    return ChunkArgs(
        src=t("src", np.int64),
        lengths=torch.as_tensor(np.bincount(
            np.asarray(fields["dst_local"], np.int64), minlength=q + 1),
            device=dev),
        mu=t("mu"), c=t("c"), inv_w=t("inv_w"), start=int(fields["start"]))
