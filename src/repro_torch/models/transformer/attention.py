"""Attention paths: dense GQA, blocked (flash-style) causal, banded SWA.

A port of the JAX package's ``models/transformer/attention.py``: the same
three schedules, masks and dispatch thresholds, with Python loops over the
blocks where the JAX package scans.

  * ``dense``     — small Sq·Sk and decode (one query against a cache).
  * ``blocked``   — causal full attention: an outer loop over q blocks, an
                    inner loop over every k block with masking (fully masked
                    blocks are computed too, as in the JAX package).
  * ``banded``    — sliding window: each q block attends a ``window +
                    q_block`` slice of the keys, O(S·W) instead of O(S²).

:func:`cached_attention` is the decode schedule over a head-major cache
(one query a row, rows in chunks). Values may be narrower than keys
(``Dv`` ≠ ``Dk``); a ``sink`` (one logit a query head) joins each softmax's
denominator with no value, and ``v_scale`` multiplies the probabilities
before they meet the values (both left out when ``None``, as every config
of the JAX package has them).

Scores are float32 whatever the inputs' dtype, as the JAX package's
``preferred_element_type=jnp.float32`` gives them: narrower inputs are
widened first (exact), float64 products are rounded to float32 after. The
online-softmax state ``(m, l, acc)`` is float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["attention", "cached_attention"]

_NEG = -1e30


def _scores(eq: str, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, q, k)`` as float32."""
    if q.dtype != torch.float64:
        q, k = q.float(), k.float()
    return torch.einsum(eq, q, k).float()


def _mask(q_pos, k_pos, window, k_valid):
    m = k_pos[:, None, :] <= q_pos[:, :, None]
    if window is not None:
        m &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    if k_valid is not None:
        m &= k_valid[:, None, :]
    return m  # [B, Sq, Sk]


def _probs(s, sink, v_scale, dtype):
    """Softmax over the keys (last axis) of float32 scores ``[B, hkv, g,
    …, k]``, each query head's ``sink`` logit in the denominator, times
    ``v_scale``; in ``dtype``."""
    if sink is None:
        p = torch.softmax(s, dim=-1)
    else:
        col = sink.to(s.dtype).reshape(1, *s.shape[1:3],
                                       *([1] * (s.dim() - 3)))
        p = torch.softmax(torch.cat([s, col.expand(*s.shape[:-1], 1)], -1),
                          dim=-1)[..., :-1]
    if v_scale is not None:
        p = p * v_scale
    return p.to(dtype)


def _dense(q, k, v, q_pos, k_pos, window, k_valid, sink=None, v_scale=None):
    dh = q.shape[-1]
    scores = _scores("bqhgd,bkhd->bhgqk", q, k) / math.sqrt(dh)
    m = _mask(q_pos, k_pos, window, k_valid)
    scores = torch.where(m[:, None, None], scores, _NEG)
    probs = _probs(scores, sink, v_scale, q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)


def _online_block(carry, kblk, vblk, qblk, qp, kp, window, scale):
    """One online-softmax step. carry = (m, l, acc) for the q block."""
    m_prev, l_prev, acc = carry
    s = _scores("bqhgd,bkhd->bhgqk", qblk, kblk) * scale
    msk = _mask(qp, kp, window, None)
    s = torch.where(msk[:, None, None], s, _NEG)
    m_cur = torch.maximum(m_prev, s.amax(dim=-1))
    alpha = torch.exp(m_prev - m_cur)
    p = torch.exp(s - m_cur[..., None])
    l_new = l_prev * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bhgqk,bkhd->bhgqd", p.to(qblk.dtype), vblk)
    return m_cur, l_new, acc


def _blocked(q, k, v, q_pos, k_pos, window, q_block, k_block, sink=None,
             v_scale=None, prefix=False):
    """A sink starts each row's online softmax as a key of logit ``sink``
    and no value: m = sink, l = 1. ``prefix``: q and k are one sequence at
    increasing positions, so the key blocks past a query block are not
    computed (each would leave the online state as it is)."""
    b, sq, hkv, g, dh = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    outs = []
    for i in range(0, sq, q_block):
        qblk, qp = q[:, i:i + q_block], q_pos[:, i:i + q_block]
        if sink is None:
            m0 = q.new_full((b, hkv, g, q_block), _NEG, dtype=torch.float32)
            l0 = q.new_zeros((b, hkv, g, q_block), dtype=torch.float32)
        else:
            m0 = sink.float().reshape(1, hkv, g, 1).expand(
                b, hkv, g, q_block).clone()
            l0 = q.new_ones((b, hkv, g, q_block), dtype=torch.float32)
        carry = (m0, l0,
                 q.new_zeros((b, hkv, g, q_block, dv), dtype=torch.float32))
        for j in range(0, min(sk, i + q_block) if prefix else sk, k_block):
            carry = _online_block(carry, k[:, j:j + k_block],
                                  v[:, j:j + k_block], qblk, qp,
                                  k_pos[:, j:j + k_block], window, scale)
        _, l, acc = carry
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        if v_scale is not None:
            out = out * v_scale
        outs.append(out.to(q.dtype).permute(0, 3, 1, 2, 4))  # [B,qb,hkv,g,dv]
    return torch.cat(outs, 1)


def _banded(q, k, v, q_pos, k_pos, window, q_block, sink=None,
            v_scale=None):
    """SWA: q block at offset o attends k slice [o + qb − span, o + qb)."""
    sq, dh = q.shape[1], q.shape[-1]
    sk = k.shape[1]
    nq = sq // q_block
    span = min(sk, window + q_block)
    scale = 1.0 / math.sqrt(dh)
    # pad left so every slice is in range
    pad = span
    kp_full = F.pad(k_pos, (pad, 0), value=-10 ** 9)
    k_full = F.pad(k, (0, 0, 0, 0, pad, 0))
    v_full = F.pad(v, (0, 0, 0, 0, pad, 0))
    outs = []
    for i in range(nq):
        start = i * q_block
        lo = min(start + q_block, sk)      # dynamic_slice clamps the start
        qblk = q[:, start:start + q_block]
        qp = q_pos[:, start:start + q_block]
        ks, vs = k_full[:, lo:lo + span], v_full[:, lo:lo + span]
        kp = kp_full[:, lo:lo + span]
        s = _scores("bqhgd,bkhd->bhgqk", qblk, ks) * scale
        msk = _mask(qp, kp, window, None)
        s = torch.where(msk[:, None, None], s, _NEG)
        p = _probs(s, sink, v_scale, q.dtype)
        outs.append(torch.einsum("bhgqk,bkhd->bqhgd", p, vs))
    return torch.cat(outs, 1)


def attention(q, k, v, q_pos, k_pos, *, window: int | None,
              k_valid=None, q_block: int = 512, k_block: int = 1024,
              dense_threshold: int = 2048, sink=None,
              v_scale: float | None = None, prefix: bool = False):
    """GQA attention dispatcher.

    q: [B, Sq, Hq, Dk]; k: [B, Sk, Hkv, Dk]; v: [B, Sk, Hkv, Dv]; sink:
    f32[Hq] or None. ``prefix``: q and k are one sequence at positions
    that increase along it (a prefill), so ``blocked`` skips the key blocks
    past each query block. Returns [B, Sq, Hq·Dv].
    """
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    sk = k.shape[1]
    g = hq // hkv
    q5 = q.reshape(b, sq, hkv, g, dh)
    extra = dict(sink=sink, v_scale=v_scale)

    if sq <= 1 or sq * sk <= dense_threshold ** 2 or k_valid is not None:
        out = _dense(q5, k, v, q_pos, k_pos, window, k_valid, **extra)
    elif window is not None and sk > 2 * (window + q_block):
        qb = min(q_block, sq)
        out = _banded(q5, k, v, q_pos, k_pos, window, qb, **extra)
    else:
        qb = min(q_block, sq)
        kbl = min(k_block, sk)
        qb = math.gcd(qb, sq)
        kbl = math.gcd(kbl, sk)
        out = _blocked(q5, k, v, q_pos, k_pos, window, qb, kbl,
                       prefix=prefix, **extra)
    return out.reshape(b, sq, hq * v.shape[-1])


def cached_attention(q, kc, vc, q_pos, k_pos, *, window: int | None,
                     sink=None, v_scale: float | None = None,
                     rows: int | None = None):
    """One query a row against a head-major cache: q [B, 1, Hq, Dk], kc
    [B, Hkv, C, Dk], vc [B, Hkv, C, Dv], q_pos i64[B, 1], k_pos i64[B, C]
    or [1, C] (a slot's position, −1 for an empty one). A slot is read
    where 0 ≤ k_pos ≤ q_pos (and q_pos − k_pos < window). The scores are
    float32 from widened keys, as :func:`_dense` makes them; the rows go
    through ``rows`` at a time (all at once when None), so only one chunk's
    widened keys and scores are live. Returns [B, 1, Hq·Dv]."""
    b, _, hq, dh = q.shape
    hkv, dv = kc.shape[1], vc.shape[-1]
    g = hq // hkv
    rows = rows or b
    outs = []
    for i in range(0, b, rows):
        qc, kt = q[i:i + rows, 0].reshape(-1, hkv, g, dh), kc[i:i + rows]
        if q.dtype != torch.float64:
            qc, kt = qc.float(), kt.float()
        kp = k_pos[i:i + rows] if k_pos.shape[0] > 1 else k_pos
        qp = q_pos[i:i + rows]
        s = torch.matmul(qc, kt.transpose(-1, -2)).float() / math.sqrt(dh)
        m = (kp >= 0) & (kp <= qp)
        if window is not None:
            m &= (qp - kp) < window
        s = torch.where(m[:, None, None], s, _NEG)
        p = _probs(s, sink, v_scale, q.dtype)
        outs.append(torch.matmul(p, vc[i:i + rows]).reshape(-1, 1, hq * dv))
    return torch.cat(outs, 0)
