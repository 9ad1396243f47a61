"""Decode attention over a full layer's head-major cache: CUDA kernel and
plain version.

:func:`decode_attention` computes what
:func:`~repro_torch.models.transformer.attention.cached_attention` computes
with ``window=None`` over a cache whose slot i holds position i (the full
kinds' layout, as :func:`~repro_torch.models.transformer.hybrid.init_cache`
makes it: ``pos = arange(C)``): row r attends slots 0 … ``q_pos[r]``. On a
CUDA tensor it launches ``csrc/decode_attn.cu`` (a split pass,
``decode_attn_kernel``, and a merge in chunk order,
``decode_attn_merge_kernel``; counted in ``decode_attention.launches``),
which reads each row's bf16 keys and values up to its own position once and
no slot past it; the row's length is read on the device. On a CPU tensor it
runs :func:`decode_attention_plain`, ``cached_attention`` itself.

Precision: the scores are f32 sums of the exact bf16 products, times
1/√Dk; the softmax's running max, exp and sum are f32, the sink (where
given) starts the online state (m = sink, l = 1); P is rounded to bf16 for
the P·V product (f32 sums); the output is divided by l in f32, times
``v_scale``, rounded to bf16. The plain version rounds P after normalising
(``p.to(q.dtype)``), the kernel before (an online softmax does not know l
yet): each probability is rounded at another point, so the two agree to
bf16's rounding of P and of the output, not bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["decode_attention", "decode_attention_plain", "least_bytes",
           "CHUNK", "MAX_GROUP", "HEAD_DIMS"]

#: slots a CTA of the split pass reads (the split-K chunk)
CHUNK = 2048
#: query heads a KV head the kernel takes (the MMA's M dimension; each
#: chunk's partial state has this many rows, the group padded)
MAX_GROUP = 16
#: (Dk, Dv) pairs the kernel is built for
HEAD_DIMS = ((192, 128),)

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                          ctypes.c_void_p]


def decode_attention_plain(q, kc, vc, q_pos, *, sink=None, v_scale=None):
    """The plain PyTorch version: ``cached_attention(..., window=None)``
    with slot i at position i. Returns [B, 1, Hq·Dv]."""
    from ..models.transformer.attention import cached_attention
    k_pos = torch.arange(kc.shape[2], device=kc.device)[None]
    return cached_attention(q, kc, vc, q_pos, k_pos, window=None, sink=sink,
                            v_scale=v_scale)


def least_bytes(q, kc, vc, q_pos) -> int:
    """The least bytes of one launch (arguments as
    :func:`decode_attention`'s): each row's live keys and values ((q_pos +
    1) slots, at most C, × Hkv × (Dk + Dv) elements), the queries and the
    output. Reads ``q_pos`` (a device sync on a card)."""
    b, _, hq, dk = q.shape
    hkv, c, dv = kc.shape[1], kc.shape[2], vc.shape[-1]
    live = int(torch.clamp(q_pos.reshape(-1) + 1, 0, c).sum())
    return (live * hkv * (dk + dv) + b * hq * (dk + dv)) * q.element_size()


def _check(q, kc, vc, q_pos, sink) -> None:
    """Raise on what the kernel does not take: every device but the dtype,
    which is bfloat16 for the kernel and any one float type on the CPU."""
    if q.dim() != 4 or kc.dim() != 4 or vc.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention: q [B, 1, Hq, Dk], kc [B, Hkv, "
                         f"C, Dk], vc [B, Hkv, C, Dv]; got {tuple(q.shape)}, "
                         f"{tuple(kc.shape)}, {tuple(vc.shape)}")
    b, _, hq, dk = q.shape
    hkv, c = kc.shape[1], kc.shape[2]
    if kc.shape != (b, hkv, c, dk) or vc.shape[:3] != (b, hkv, c):
        raise ValueError(f"decode_attention: shapes disagree: q "
                         f"{tuple(q.shape)}, kc {tuple(kc.shape)}, vc "
                         f"{tuple(vc.shape)}")
    if (dk, vc.shape[-1]) not in HEAD_DIMS:
        raise ValueError(f"decode_attention: (Dk, Dv) = ({dk}, "
                         f"{vc.shape[-1]}) is not one of {HEAD_DIMS}")
    if hq % hkv or hq // hkv > MAX_GROUP or c < 1:
        raise ValueError(f"decode_attention: Hq / Hkv = {hq} / {hkv} must be "
                         f"a whole group of at most {MAX_GROUP}; C = {c}")
    want = q.dtype if q.device.type == "cpu" else torch.bfloat16
    for name, x in (("q", q), ("kc", kc), ("vc", vc)):
        if x.dtype != want or not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"decode_attention: {name} must be a contiguous "
                             f"{want} tensor on {q.device}; got {x.dtype} on "
                             f"{x.device}, strides {x.stride()}")
    if q_pos.dtype != torch.int64 or q_pos.shape != (b, 1) \
            or not q_pos.is_contiguous() or q_pos.device != q.device:
        raise ValueError(f"decode_attention: q_pos must be int64 [B, 1] on "
                         f"{q.device}; got {q_pos.dtype} "
                         f"{tuple(q_pos.shape)} on {q_pos.device}")
    if sink is not None and (sink.dtype != torch.float32
                             or sink.shape != (hq,)
                             or not sink.is_contiguous()
                             or sink.device != q.device):
        raise ValueError(f"decode_attention: sink must be a contiguous "
                         f"float32 [{hq}] on {q.device}; got {sink.dtype} "
                         f"{tuple(sink.shape)}")


def decode_attention(q, kc, vc, q_pos, *, sink=None, v_scale=None):
    """One query a row against a full layer's head-major cache.

    Args:
      q: bf16[B, 1, Hq, Dk]; kc: bf16[B, Hkv, C, Dk]; vc: bf16[B, Hkv, C,
        Dv], one layer's contiguous view of the cache, slot i holding
        position i. Hq / Hkv at most 16; (Dk, Dv) one of ``HEAD_DIMS``.
      q_pos: i64[B, 1], each row's position: row r reads slots 0 …
        ``q_pos[r]`` (at most C − 1) and no slot past it.
      sink: f32[Hq] or None, one logit a query head in the denominator.
      v_scale: multiplies the output (None: 1).

    Returns:
      bf16[B, 1, Hq·Dv]. A CPU tensor takes :func:`decode_attention_plain`
      (in any float type, q, kc and vc alike); a CUDA tensor launches the
      kernel. Either raises on what the kernel does not take.
    """
    _check(q, kc, vc, q_pos, sink)
    if q.device.type == "cpu":
        return decode_attention_plain(q, kc, vc, q_pos, sink=sink,
                                      v_scale=v_scale)
    if kc.data_ptr() % 16 or vc.data_ptr() % 16 or q.data_ptr() % 4:
        raise ValueError("decode_attention: kc and vc must start on 16 "
                         "bytes, q on 4 (the kernel's copies)")
    b, _, hq, dk = q.shape
    hkv, c, dv = kc.shape[1], kc.shape[2], vc.shape[-1]
    nchunks = -(-c // CHUNK)
    part_m = torch.empty(b, hkv, nchunks, MAX_GROUP, dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty(b, hkv, nchunks, MAX_GROUP, dv,
                           dtype=torch.float32, device=q.device)
    out = torch.empty(b, 1, hq * dv, dtype=q.dtype, device=q.device)
    fn = _build.entry("decode_attn", "repro_decode_attn", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                    q_pos.data_ptr(),
                    None if sink is None else sink.data_ptr(),
                    part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
                    out.data_ptr(), b, hkv, c, hq // hkv, dk, dv, CHUNK,
                    1.0 if v_scale is None else float(v_scale), stream)
    _build.check("decode_attn", status)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
