"""Seconds from the process's start to the first timed request: imports, the
CUDA context, the map, the program's set-up and its warm requests (and the
nvcc build on a checkout's first run)."""


def read(run):
    return run.setup_s
