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
and each worker's torch takes its share of the cores.
"""

import gc
import os
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


# Seconds of the tests that take half a minute or more on one worker of a
# whole tier-1 run (six xdist workers, `--dist load`, 8 cores; 6898
# worker-seconds in all). A key ending in ".py" names a module whose tests
# run together at the start, so that one worker computes its module
# fixtures (tests/test_torch_pipeline.py's tour; the emulation runs that
# tests/test_torch_persistent_emu.py's cases share).
_SLOW = {
    "tests/test_dist_fused6.py::test_dist_fused6_gn_matches_mega_kernel_and_mesh_sizes": 561,
    "tests/test_gn6_kernel.py::test_fused_gn6_page_windowed_matches_plain": 371,
    "tests/test_torch_pipeline.py": 350,
    "tests/test_torch_persistent_emu.py": 120,
    "tests/test_dist_fused6.py::test_dist_fused6_lm_matches_mega_kernel": 338,
    "tests/test_gn6_kernel.py::test_fused_gn6_matches_xla_gn_trajectory": 291,
    "tests/test_gn6_kernel.py::test_fused_gn6_masked_edges": 267,
    "tests/test_gn6_kernel.py::test_fused_gn6_warm_start_and_ramp": 240,
    "tests/test_gn6_kernel.py::test_fused_gn6_chain_only": 237,
    "tests/test_torch_dist_fused6.py::test_plain_lm_matches_jax": 215,
    "tests/test_gn6_kernel.py::test_fused_lm6_matches_xla_lm": 207,
    "tests/test_torch_dist_fused6.py::test_plain_gn_matches_jax": 197,
    "tests/test_gn6_kernel.py::test_lm_solve_dispatches_gn_fused_se3": 150,
    "tests/test_torch_solver.py::test_m3500_slice_end_to_end_cpu": 142,
    "tests/test_gn_kernel.py::test_fused_gn_warm_start_and_ramp": 108,
    "tests/test_gn_kernel.py::test_bucketize_edge_cases": 104,
    "tests/test_torch_gn6_kernel.py::test_twin_matches_jax_kernel_interpret": 101,
    "tests/test_gn_kernel.py::test_fused_lm_page_windowed_matches_plain": 89,
    "tests/test_dist_fused.py::test_dist_fused_gn_page_windowed_matches_plain": 85,
    "tests/test_gn_kernel.py::test_fused_gn_page_windowed_matches_plain": 82,
    "tests/test_dist_fused.py::test_dist_fused_gn_mesh_size_invariant": 79,
    "tests/test_dist_fused.py::test_dist_fused_cg_kernel_lm_and_mesh_invariance": 76,
    "tests/test_gn_kernel.py::test_warm_start_at_optimum_stays_finite": 69,
    "tests/test_pipeline.py::TestWarmStartedSolves::test_warm_bucketed_solve_in_pipeline": 62,
    "tests/test_dist_fused.py::test_dist_fused_lm_matches_mega_kernel": 60,
    "tests/test_pipeline.py::TestWarmStartedSolves::test_cov_refresh_on_loop_commits": 54,
    "tests/test_gn_kernel.py::test_fused_gn_huber_matches_xla_irls": 51,
    "tests/test_dist_fused.py::test_dist_fused_gn_matches_mega_kernel_8dev": 51,
    "tests/test_dist_fused.py::test_dist_fused_cg_kernel_matches_xla_loop": 48,
    "tests/test_torch_dist_fused.py::test_gloo_ranks_match_one_rank_and_jax": 42,
    "tests/test_torch_pcg6_kernel.py::test_twin_matches_jax_kernel_interpret": 42,
    "tests/test_dist_fused.py::test_dist_fused_slab_pcr_mesh_invariant": 41,
    "tests/test_gn_kernel.py::test_fused_lm_matches_xla_lm": 40,
    "tests/test_torch_gn_kernel.py::test_twin_matches_jax_kernel_interpret[pcr_exact]": 40,
    "tests/test_torch_dist.py::test_four_ranks_match_jax_four_devices": 39,
    "tests/test_factors.py::TestSE2Jacobians::test_se3_between_jacobians_match_jacfwd": 39,
    "tests/test_gn_kernel.py::test_fused_gn_matches_xla_gn_trajectory": 37,
    "tests/test_pipeline.py::TestClosedLoop::test_scan_to_map_matching": 36,
    "tests/test_gn_kernel.py::test_fused_gn_masked_edges": 36,
    "tests/test_gn_kernel.py::test_gn_fused_mode_via_gn_loop": 35,
    "tests/test_torch_pcg6_kernel.py::test_gn_and_lm_loops_pcg_fused_match_xla": 35,
    "tests/test_pcg6_kernel.py::test_fused_pcg6_converges_to_dense": 34,
    "tests/test_pipeline.py::TestClosedLoop::test_enabled_solve_beats_reference_disabled_solve": 33,
    "tests/test_schur.py::test_schur_matches_dense_se3": 31,
    "tests/test_distributed.py::TestDistributed::test_dist_lm_converges_se3": 30,
}


_LEAD_S = 300  # a test this slow starts at once, on a worker of its own


def slow_last_order(items, workers: int):
    """The items reordered for xdist's load scheduling, which hands each of
    the `workers` a first chunk of max(2, len(items) // workers // 4)
    consecutive items and then more in this order as workers free up. The
    modules of _SLOW and the tests of at least _LEAD_S seconds lead the
    first chunks of distinct workers (a module's tests together, so that
    one worker computes its module fixture); the quick tests follow in
    collection order; the other slow tests come last, longest first. In
    collection order the slow tests sat next to each other in a few
    modules: one worker drew several of them and ran on long after the
    others, and a run cut by its time limit lost quick tests behind them."""
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
    tail.sort(key=lambda it: -_SLOW[it.nodeid])
    chunk = max(2, len(items) // workers // 4)
    order = []
    for w, key in enumerate(sorted(lead, key=lambda k: -_SLOW[k])):
        head = lead[key]
        if w >= workers or len(head) > chunk:
            quick = head + quick
            continue
        fill = chunk - len(head)
        order += head + quick[:fill]
        quick = quick[fill:]
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
