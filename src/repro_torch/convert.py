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
from .device import numpy_dtype, resolve_device
from .kernels.formats import BsrFormat, EdgeTileFormat
from .kernels.ops import DeviceBsr, DeviceEdgeTiles

__all__ = ["operators_from_numpy", "edge_tiles_from_numpy", "bsr_from_numpy",
           "warm_start_from_numpy", "sage_params_from_numpy"]


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


def sage_params_from_numpy(tree, *, dtype: torch.dtype | None = None,
                           device: str | torch.device = "cuda") -> dict:
    """GraphSAGE parameters from the JAX package's ``sage.init_params`` tree
    as numpy (``jax.tree.map(np.asarray, params)``): the same nesting
    (``layers`` list of ``w_self`` / ``w_neigh``, ``head``) and the same
    ``w[d_in, d_out]`` layout, so nothing is transposed. Every leaf becomes
    a tensor that requires grad; ``dtype`` defaults to the arrays' own."""
    dev = resolve_device(device)

    def leaf(a):
        return torch.tensor(np.asarray(a), dtype=dtype,
                            device=dev).requires_grad_()

    return dict(layers=[{k: {kk: leaf(vv) for kk, vv in v.items()}
                         for k, v in lyr.items()} for lyr in tree["layers"]],
                head={k: leaf(v) for k, v in tree["head"].items()})
