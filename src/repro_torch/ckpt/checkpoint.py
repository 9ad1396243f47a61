"""Sharded, atomic checkpointing: numpy ``.npz`` shards plus a manifest.

Layout:  <dir>/step_<n>/host_<i>.npz  +  <dir>/step_<n>/MANIFEST.json
Writes go to ``step_<n>.tmp`` and are renamed only after the manifest is
fsynced — a torn write can never be mistaken for a valid checkpoint, so
restart always finds the last *complete* step.

The JAX package's on-disk format, key for key: a tree (dicts, lists,
tuples; leaves are tensors, numpy arrays or scalars) flattens to
``/``-joined paths (dict keys in sorted order, sequence indices), so a
checkpoint written by either package restores in the other. Leaves are
written as host numpy arrays; :func:`restore` returns numpy leaves in the
template's structure. A bfloat16 tensor is written as the JAX package
writes an ``ml_dtypes.bfloat16`` array: a 2-byte void (``|V2``) array with
the same bits; such a leaf restores as a bfloat16 CPU tensor (numpy has no
bfloat16), bit for bit.

Corruption + concurrency hardening:

* :func:`latest_step` only reports *complete* steps — the manifest must
  parse as JSON and every host shard it lists must exist on disk. A
  truncated manifest or a missing ``host_*.npz`` demotes that step with a
  warning (never an exception) and the previous complete step serves.
* :func:`restore_latest` walks complete steps newest-first and falls back
  on *any* load failure — including the race where a concurrent
  ``save(keep=…)`` GC pruned the step between ``latest_step`` and the
  ``np.load``.
* :func:`restore` (explicit step) still raises: a caller naming a step
  wants that step or an error, and a shape mismatch against the template
  is a caller bug, not corruption.
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile

import numpy as np
import torch

from ..device import host_array, host_tensor
from ..obs import log as obs_log

__all__ = ["save", "restore", "restore_latest", "latest_step", "all_steps",
           "complete_steps", "load_arrays"]

#: exceptions that mean "this step is corrupt / torn / concurrently pruned"
#: rather than a caller bug — the fallback walkers skip on exactly these
_CORRUPT_ERRORS = (OSError, EOFError, KeyError, ValueError,
                   json.JSONDecodeError, zipfile.BadZipFile)


def _leaves(tree, path=()):
    """``(path, leaf)`` pairs in the JAX package's tree order: dict keys
    sorted, sequences by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield "/".join(str(p) for p in path), tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return host_array(leaf)
    return np.asarray(leaf)


def _from_host(arr: np.ndarray):
    """A stored leaf: a ``|V2`` array (bfloat16 bits) as a bfloat16 CPU
    tensor, any other as the numpy array."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return host_tensor(arr)
    return arr


def _flatten(tree) -> dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in _leaves(tree)}


def _rebuild(template, data, path=()):
    """``template``'s structure with each leaf read from ``data`` (shapes
    validated)."""
    if isinstance(template, dict):
        return {k: _rebuild(v, data, path + (k,))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, data, path + (i,))
                              for i, v in enumerate(template))
    key = "/".join(str(p) for p in path)
    arr = data[key]
    want = tuple(template.shape) if hasattr(template, "shape") \
        else np.shape(template)
    if tuple(arr.shape) != want:
        raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {want}")
    return _from_host(arr)


def save(directory: str, step: int, tree, *, host: int = 0,
         keep: int = 3) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(tree)
    np.savez(os.path.join(tmp, f"host_{host}.npz"), **flat)
    manifest = dict(step=step, hosts=[host], keys=sorted(flat),
                    shapes={k: list(v.shape) for k, v in flat.items()})
    mpath = os.path.join(tmp, "MANIFEST.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = all_steps(directory)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(directory: str) -> list[int]:
    """Every step directory with a MANIFEST.json *present* (not validated —
    the GC uses this; readers should prefer :func:`complete_steps`)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "MANIFEST.json")):
                out.append(int(name.removeprefix("step_")))
    return sorted(out)


def _is_complete(directory: str, step: int) -> bool:
    """A step is complete when its manifest parses and every host shard it
    lists exists. Truncated manifests and missing ``host_*.npz`` (torn
    writes on filesystems without atomic rename, partial copies, …) fail
    here and are skipped by the readers instead of raising."""
    base = os.path.join(directory, f"step_{step:08d}")
    try:
        with open(os.path.join(base, "MANIFEST.json")) as f:
            manifest = json.load(f)
        hosts = manifest.get("hosts", [0])
        return all(os.path.exists(os.path.join(base, f"host_{h}.npz"))
                   for h in hosts)
    except _CORRUPT_ERRORS:
        return False


def complete_steps(directory: str) -> list[int]:
    """Steps whose manifest parses and whose host shards all exist."""
    return [s for s in all_steps(directory) if _is_complete(directory, s)]


def latest_step(directory: str) -> int | None:
    """The newest *complete* step (corrupt/truncated steps are skipped with
    a warning — restart falls back to the previous good one, it never
    crashes on a torn manifest)."""
    for s in reversed(all_steps(directory)):
        if _is_complete(directory, s):
            return s
        obs_log.warn(
            "ckpt_corrupt_step",
            f"checkpoint step {s} in {directory} is corrupt or incomplete "
            "(unparseable MANIFEST.json or missing host shard); falling "
            "back to the previous complete step", category=RuntimeWarning,
            stacklevel=3, step=int(s), directory=directory)
    return None


def load_arrays(directory: str, step: int, *, host: int = 0
                ) -> dict[str, np.ndarray]:
    """The flat ``key → array`` mapping of one host shard, template-free
    (keys are the ``/``-joined tree paths :func:`save` flattened): for a
    reader whose shapes are data, not a template. bfloat16 leaves come back
    as bfloat16 CPU tensors."""
    path = os.path.join(directory, f"step_{step:08d}", f"host_{host}.npz")
    with np.load(path) as data:
        return {k: _from_host(data[k].copy()) for k in data.files}


def restore(directory: str, step: int, template, *, host: int = 0):
    """Restore into the structure of ``template`` (shapes validated).

    Raises on a missing/corrupt step or a shape mismatch — callers naming
    an explicit step want that step or an error. Use :func:`restore_latest`
    for the fall-back-to-previous-complete-step behavior."""
    path = os.path.join(directory, f"step_{step:08d}", f"host_{host}.npz")
    with np.load(path) as data:
        return _rebuild(template, data)


def restore_latest(directory: str, template, *, host: int = 0):
    """Restore the newest step that actually loads, walking backwards.

    Any load failure — corrupt manifest, truncated npz, a shape that no
    longer matches the template, or the step vanishing because a
    concurrent ``save(keep=…)`` GC pruned it between listing and load —
    demotes that step with a warning and the walk continues. Returns the
    restored tree, or None when no step could be restored."""
    for s in reversed(all_steps(directory)):
        if not _is_complete(directory, s):
            obs_log.warn(
                "ckpt_corrupt_step",
                f"checkpoint step {s} in {directory} is corrupt or "
                "incomplete; trying the previous step",
                category=RuntimeWarning, stacklevel=3,
                step=int(s), directory=directory)
            continue
        try:
            return restore(directory, s, template, host=host)
        except _CORRUPT_ERRORS as e:
            # includes the GC race: _is_complete saw the step, the rmtree
            # landed before np.load — FileNotFoundError is an OSError
            obs_log.warn(
                "ckpt_load_failed",
                f"checkpoint step {s} in {directory} failed to load "
                f"({type(e).__name__}: {e}); trying the previous step",
                category=RuntimeWarning, stacklevel=3,
                step=int(s), directory=directory,
                error=type(e).__name__)
    return None
