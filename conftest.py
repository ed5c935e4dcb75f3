"""Repo-wide pytest hook: keep each test process under the kernel's map limit.

Every executable that XLA compiles for the CPU holds a few memory mappings
until `jax.clear_caches()` drops it. A process that runs compile-heavy tests
from many files (pytest-xdist with `--dist load`) piles them up, and once it
reaches `vm.max_map_count` (65530 by default on Linux) the next compile's
mmap fails and XLA's CPU compiler aborts or segfaults, killing the worker.
After each test, where the process has imported jax and holds more than half
that many mappings, the caches are cleared; later tests recompile what they
use. jax is not imported here, so processes that never import it are untouched.

Under pytest-xdist the collection is also reordered: the few slowest
tests start at once on workers of their own, the quick ones follow and the
other slow ones run last, longest first (see _SLOW and slow_last_order);
and each worker's torch, OpenBLAS and XLA take its share of the cores.
"""

import gc
import os
import sys

import pytest


def _cores_per_worker() -> int:
    """cpu_count // workers under pytest-xdist (at least 1), else 0."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    return max(1, (os.cpu_count() or 1) // workers) if workers > 1 else 0


# Each xdist worker's XLA Eigen thread pool and scipy's OpenBLAS (the
# LAPACK that XLA's CPU linear algebra calls) start one thread a core, and
# their threads spin while they wait: with six workers on eight cores they
# slow each other down. The counts are read when the libraries load, so
# they are set here, before jax (and with it scipy) is imported; numpy's own
# OpenBLAS is loaded before this file and keeps its count.
_SHARE = _cores_per_worker()
if _SHARE:
    os.environ.setdefault("OPENBLAS_NUM_THREADS", str(_SHARE))
    _flags = os.environ.get("XLA_FLAGS", "")
    if _SHARE == 1 and "xla_cpu_multi_thread_eigen" not in _flags:
        os.environ["XLA_FLAGS"] = (_flags + " --xla_cpu_multi_thread_eigen=false").strip()

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


# Seconds of the tests that take half a minute or more on one worker of a
# whole tier-1 run (six xdist workers, `--dist load`, 8 cores shared with
# other work): the mean of two runs of 7532 and 7590 worker-seconds, which
# took 1378 and 1304 s. A key ending in ".py" names a module whose tests
# run together, so that one worker computes its module fixtures
# (tests/test_torch_pipeline.py's tour; the emulation runs that
# tests/test_torch_persistent_emu.py's cases share). Compare orderings on
# a run's junit XML with scripts/tier1_order_sim.py.
_SLOW = {
    "tests/test_dist_fused6.py::test_dist_fused6_gn_matches_mega_kernel_and_mesh_sizes": 682,
    "tests/test_gn6_kernel.py::test_fused_gn6_page_windowed_matches_plain": 500,
    "tests/test_dist_fused6.py::test_dist_fused6_lm_matches_mega_kernel": 412,
    "tests/test_gn6_kernel.py::test_fused_gn6_warm_start_and_ramp": 302,
    "tests/test_gn6_kernel.py::test_fused_gn6_matches_xla_gn_trajectory": 273,
    "tests/test_gn6_kernel.py::test_fused_lm6_matches_xla_lm": 267,
    "tests/test_gn6_kernel.py::test_fused_gn6_chain_only": 259,
    "tests/test_gn6_kernel.py::test_fused_gn6_masked_edges": 258,
    "tests/test_gn6_kernel.py::test_lm_solve_dispatches_gn_fused_se3": 234,
    "tests/test_torch_dist_fused6.py::test_plain_gn_matches_jax": 212,
    "tests/test_torch_dist_fused6.py::test_plain_lm_matches_jax": 188,
    "tests/test_torch_persistent_emu.py": 150,
    "tests/test_torch_gn6_kernel.py::test_twin_matches_jax_kernel_interpret": 149,
    "tests/test_torch_pipeline.py": 142,
    "tests/test_gn_kernel.py::test_fused_gn_warm_start_and_ramp": 137,
    "tests/test_dist_fused.py::test_dist_fused_cg_kernel_lm_and_mesh_invariance": 126,
    "tests/test_dist_fused.py::test_dist_fused_gn_page_windowed_matches_plain": 111,
    "tests/test_gn_kernel.py::test_bucketize_edge_cases": 105,
    "tests/test_dist_fused.py::test_dist_fused_gn_matches_mega_kernel_8dev": 103,
    "tests/test_gn_kernel.py::test_fused_lm_page_windowed_matches_plain": 99,
    "tests/test_dist_fused.py::test_dist_fused_gn_mesh_size_invariant": 90,
    "tests/test_dist_fused.py::test_dist_fused_lm_matches_mega_kernel": 87,
    "tests/test_gn_kernel.py::test_fused_gn_page_windowed_matches_plain": 80,
    "tests/test_pipeline.py::TestWarmStartedSolves::test_warm_bucketed_solve_in_pipeline": 74,
    "tests/test_gn_kernel.py::test_warm_start_at_optimum_stays_finite": 66,
    "tests/test_gn_kernel.py::test_fused_gn_matches_xla_gn_trajectory": 62,
    "tests/test_gn_kernel.py::test_fused_gn_huber_matches_xla_irls": 59,
    "tests/test_pcg6_kernel.py::test_fused_pcg6_chain_only_matches_dense": 59,
    "tests/test_dist_fused.py::test_dist_fused_cg_kernel_matches_xla_loop": 58,
    "tests/test_torch_lm.py::test_fused_lm_twin_matches_jax_kernel_interpret": 53,
    "tests/test_pcg6_kernel.py::test_fused_pcg6_converges_to_dense": 52,
    "tests/test_schur.py::test_dist_schur_gn_converges_sphere": 49,
    "tests/test_torch_dist.py::test_four_ranks_match_jax_four_devices": 49,
    "tests/test_dist_fused.py::test_dist_fused_slab_pcr_mesh_invariant": 45,
    "tests/test_factors.py::TestSE2Jacobians::test_se3_between_jacobians_match_jacfwd": 45,
    "tests/test_gn_kernel.py::test_gn_fused_mode_via_gn_loop": 45,
    "tests/test_distributed.py::TestDistributed::test_dist_lm_converges_se3": 44,
    "tests/test_dist_fused.py::test_dist_fused_gn_truncated_pcr_and_masks": 41,
    "tests/test_gn_kernel.py::test_fused_lm_matches_xla_lm": 40,
    "tests/test_schur.py::test_schur_matches_dense_se3": 40,
    "tests/test_gn_kernel.py::test_fused_gn_chain_only": 38,
    "tests/test_pcg_kernel.py::test_fused_pcg_tracks_xla_pcg_residuals": 38,
    "tests/test_gn_kernel.py::test_fused_gn_masked_edges": 37,
    "tests/test_pipeline.py::TestClosedLoop::test_enabled_solve_beats_reference_disabled_solve": 36,
    "tests/test_tridiag.py::test_cr_matches_dense[129]": 34,
    "tests/test_pipeline.py::TestClosedLoop::test_online_keyframe_covariances_match_dense_marginals": 33,
    "tests/test_torch_gn_kernel.py::test_twin_matches_jax_kernel_interpret[pcr_exact]": 33,
    "tests/test_schur.py::test_schur_matches_dense_se2[4]": 32,
    "tests/test_torch_pcg6_kernel.py::test_twin_matches_jax_kernel_interpret": 31,
}


_LEAD_S = 200  # a test this slow starts at once, on a worker of its own


def slow_last_order(items, workers: int):
    """The items reordered for xdist's load scheduling, which hands each of
    the `workers` a first chunk of max(2, len(items) // workers // 4)
    consecutive items and then more in this order as workers free up. The
    longest of the modules of _SLOW and the tests of at least _LEAD_S
    seconds lead the first chunks of distinct workers, one a worker (a
    module's tests together, so that one worker computes its module
    fixture); the modules left over and then the quick tests follow in
    collection order; the other slow tests come last, longest first: by
    then xdist hands out two items at a time, so each long test starts on
    the next free worker while the quick and shorter ones fill the others,
    and the workers finish together (shortest first left the longest of
    them to start near the end and run past the others). In collection
    order the slow tests sat next to each other in a few modules: one
    worker drew several of them and ran on long after the others."""
    lead, quick, tail = {}, [], []
    for it in items:
        module = it.nodeid.split("::")[0]
        if module in _SLOW:
            lead.setdefault(module, []).append(it)
        elif _SLOW.get(it.nodeid, 0) >= _LEAD_S:
            lead[it.nodeid] = [it]
        elif it.nodeid in _SLOW:
            tail.append(it)
        else:
            quick.append(it)
    chunk = max(2, len(items) // workers // 4)
    order = []
    for w, key in enumerate(sorted(lead, key=lambda k: -_SLOW[k])):
        head = lead[key]
        if w >= workers or len(head) > chunk:
            if key.endswith(".py"):
                quick = head + quick
            else:
                tail += head
            continue
        fill = chunk - len(head)
        order += head + quick[:fill]
        quick = quick[fill:]
    tail.sort(key=lambda it: -_SLOW[it.nodeid])
    return order + quick + tail


def pytest_collection_modifyitems(config, items):
    workers = getattr(config, "workerinput", {}).get("workercount", 0)
    if workers > 1:
        items[:] = slow_last_order(items, workers)
        # torch's CPU ops take the worker's share of the cores: with one
        # thread a core in every worker, the workers' OpenMP threads wait on
        # each other (the m3500 GN twin took 121-154 s in a whole run against
        # 14 s alone)
        torch = sys.modules.get("torch")
        if torch is not None:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
