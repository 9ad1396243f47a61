"""The benchmark's command: one run of one cell on this machine's card.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the compared numbers are the last lines of standard error.
``--control 1`` puts the control (the plain reference one precision down)
in the program's place and runs no window: its ``correct`` has to come out
false.
Without a CUDA card, or with fewer than the cell asks for, it exits 2 and
prints no result; a run that loaded JAX or the JAX package exits 3.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def set_cache_dirs() -> None:
    """Every build or kernel cache a library may write goes to a fixed
    directory inside the checkout (the program's own nvcc builds already
    go to ``build/repro_torch_kernels``)."""
    cache = ROOT / "build" / "gpubench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def main(argv=None) -> int:
    set_cache_dirs()
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    from gpubench import harness
    return harness.main(ROOT, harness.parse_args(argv), "cuda", T0)


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
