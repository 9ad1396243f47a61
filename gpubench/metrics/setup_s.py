"""setup_s (s, host clock): process start to the first timed request: CUDA
initialisation, loading the kernel libraries (building them on a
checkout's first run), input generation, the program's operator and
format builds, and the warm-up requests."""


def read(run):
    return run.setup_s
