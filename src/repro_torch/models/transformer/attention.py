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

Scores are float32 whatever the inputs' dtype, as the JAX package's
``preferred_element_type=jnp.float32`` gives them: narrower inputs are
widened first (exact), float64 products are rounded to float32 after. The
online-softmax state ``(m, l, acc)`` is float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["attention"]

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


def _dense(q, k, v, q_pos, k_pos, window, k_valid):
    dh = q.shape[-1]
    scores = _scores("bqhgd,bkhd->bhgqk", q, k) / math.sqrt(dh)
    m = _mask(q_pos, k_pos, window, k_valid)
    scores = torch.where(m[:, None, None], scores, _NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
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


def _blocked(q, k, v, q_pos, k_pos, window, q_block, k_block):
    b, sq, hkv, g, dh = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    outs = []
    for i in range(0, sq, q_block):
        qblk, qp = q[:, i:i + q_block], q_pos[:, i:i + q_block]
        carry = (q.new_full((b, hkv, g, q_block), _NEG, dtype=torch.float32),
                 q.new_zeros((b, hkv, g, q_block), dtype=torch.float32),
                 q.new_zeros((b, hkv, g, q_block, dh), dtype=torch.float32))
        for j in range(0, sk, k_block):
            carry = _online_block(carry, k[:, j:j + k_block],
                                  v[:, j:j + k_block], qblk, qp,
                                  k_pos[:, j:j + k_block], window, scale)
        _, l, acc = carry
        out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4))          # [B,qb,hkv,g,dh]
    return torch.cat(outs, 1)


def _banded(q, k, v, q_pos, k_pos, window, q_block):
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
        p = torch.softmax(s, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhgqk,bkhd->bqhgd", p, vs))
    return torch.cat(outs, 1)


def attention(q, k, v, q_pos, k_pos, *, window: int | None,
              k_valid=None, q_block: int = 512, k_block: int = 1024,
              dense_threshold: int = 2048):
    """GQA attention dispatcher.

    q: [B, Sq, Hq, Dh]; k/v: [B, Sk, Hkv, Dh]. Returns [B, Sq, Hq·Dh].
    """
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    sk = k.shape[1]
    g = hq // hkv
    q5 = q.reshape(b, sq, hkv, g, dh)

    if sq <= 1 or sq * sk <= dense_threshold ** 2 or k_valid is not None:
        out = _dense(q5, k, v, q_pos, k_pos, window, k_valid)
    elif window is not None and sk > 2 * (window + q_block):
        qb = min(q_block, sq)
        out = _banded(q5, k, v, q_pos, k_pos, window, qb)
    else:
        qb = min(q_block, sq)
        kbl = min(k_block, sk)
        qb = math.gcd(qb, sq)
        kbl = math.gcd(kbl, sk)
        out = _blocked(q5, k, v, q_pos, k_pos, window, qb, kbl)
    return out.reshape(b, sq, hq * dh)
