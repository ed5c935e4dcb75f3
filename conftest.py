"""Repo-wide pytest hook: keep each test process under the kernel's map limit.

Every executable that XLA compiles for the CPU holds a few memory mappings
until `jax.clear_caches()` drops it. A process that runs compile-heavy tests
from many files (pytest-xdist with `--dist load`) piles them up, and once it
reaches `vm.max_map_count` (65530 by default on Linux) the next compile's
mmap fails and XLA's CPU compiler aborts or segfaults, killing the worker.
After each test, where the process has imported jax and holds more than half
that many mappings, the caches are cleared; later tests recompile what they
use. jax is not imported here, so processes that never import it are untouched.
"""

import gc
import sys

import pytest

_MAPS = "/proc/self/maps"


def _map_limit() -> int | None:
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return None


_LIMIT = _map_limit()


def _n_maps() -> int:
    with open(_MAPS) as f:
        return sum(1 for _ in f)


@pytest.hookimpl(trylast=True)
def pytest_runtest_teardown(item, nextitem):
    jax = sys.modules.get("jax")
    if jax is None or _LIMIT is None or _n_maps() <= _LIMIT // 2:
        return
    jax.clear_caches()
    gc.collect()
