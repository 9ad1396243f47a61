"""Build the CUDA kernels with ``nvcc`` at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface and compiles on its own
into ``build/repro_torch_kernels/<name>-<digest>.so`` at the repository root
(a directory git ignores); the digest covers the source, the shared headers
``csrc/*.cuh`` and the flags, so an edited source or header is rebuilt and an
unchanged one is reused. Nothing is built
when a module is imported: the first CUDA launch of a kernel builds its
library, and :func:`build_all` starts every ``nvcc`` at once when a caller
wants them all up front.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises on anything but 0. A wrapper on the dry run's traced
step (FakeTensors, which allocate nothing) launches nothing: ``seg_mm``'s
operator has a registered fake that returns an empty output of the
kernel's shape; :func:`is_fake` tells a FakeTensor from a real one. A
failed build raises with nvcc's stderr. There is no fallback: a kernel that does not build or launch is an
error, never a quiet switch to the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "build_all", "load",
           "entry", "check", "is_fake"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("power_step", "bsr_spmv", "edge_spmv", "seg_mm", "decode_attn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict[tuple[str, str], object] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc"]          # the toolkit's default install
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def _target(name: str) -> Path:
    text = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every named source that has no current library, all ``nvcc``
    processes running at once. Returns ``{name: library path}``; the
    compiler's ``-Xptxas -v`` report lands beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, target)
    failures = []
    for name, (proc, tmp, target) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed on {name}.cu "
                            f"(exit {proc.returncode}):\n{err}{out}")
            continue
        target.with_suffix(".log").write_text(err + out)
        os.replace(tmp, target)      # atomic: concurrent builds agree
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: _target(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all((name,))[name]))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def entry(name: str, symbol: str, argtypes: list):
    """C function ``symbol`` of library ``name`` with its argument types set
    (``c_void_p`` for every pointer and the stream, so none is cut to 32
    bits) and an ``int`` status as its result."""
    key = (name, symbol)
    fn = _ENTRIES.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[key] = fn
    return fn


def check(name: str, status: int) -> None:
    """Raise if a C entry point of library ``name`` reported a CUDA error."""
    if status != 0:
        msg = load(name).repro_error_string(status).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{status} ({msg})")


def is_fake(x) -> bool:
    """Whether ``x`` is a FakeTensor (shapes and dtypes, no storage)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(x, FakeTensor)
