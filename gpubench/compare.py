"""The numbers that decide ``correct``: what the timed path served, against
the plain reference's ψ. Each returns a float; an answer of the wrong shape
reads ``inf``, which fails every limit."""
from __future__ import annotations

import numpy as np

__all__ = ["rel_max", "top_rel", "judge"]


def rel_max(got, ref: np.ndarray) -> float:
    """max_i |got_i − ref_i| / ref_i (every reference ψ is above 0: ψ ≥ d/N
    with d ≥ λ/(λ+μ) > 0)."""
    got = np.asarray(got, np.float64)
    if got.shape != ref.shape or not np.all(np.isfinite(got)):
        return float("inf")
    return float(np.max(np.abs(got - ref) / ref)) if ref.size else 0.0


def top_rel(ids, vals, k: int, ref: np.ndarray) -> float:
    """How far the served top-k list is from the reference's: at each rank
    r, the served value and the reference's ψ of the served id, each
    against the reference's r-th largest ψ, relative to it; the largest
    over the ranks. It reads a wrong member, a wrong order and a wrong
    value alike; ``inf`` when there are not k distinct ids in range with
    finite values."""
    ids = np.asarray(ids)
    vals = np.asarray(vals, np.float64)
    if ids.shape != (k,) or vals.shape != (k,) \
            or np.unique(ids).size != k or ids.min() < 0 \
            or ids.max() >= ref.size or not np.all(np.isfinite(vals)):
        return float("inf")
    best = np.sort(np.partition(ref, ref.size - k)[ref.size - k:])[::-1]
    err = np.maximum(np.abs(vals - best), np.abs(ref[ids] - best))
    return float(np.max(err / best))


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}). A
    number with no limit is an error in the configuration."""
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing} in the configuration")
    check = {name: dict(value=float(v), limit=float(limits[name]))
             for name, v in numbers.items()}
    ok = all(c["value"] <= c["limit"] for c in check.values())
    return ok, check
