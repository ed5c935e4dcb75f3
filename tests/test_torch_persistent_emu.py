"""The persistent kernels against their staged sequences, on the CPU.

K3 (`gn_pcg`) and K6a-c (`cg_stage_a`, `cg_gn_setup`, `cg_step`), the
whole solves of K1 (`gn_solve`,
`gn_lm_solve`, csrc/gn_kernel.cu) and K4 (`gn6_solve`, `gn6_lm_solve`,
csrc/gn6_kernel.cu), K5 (`gn6_pcg`), K7a-c (`cg6_stage_a`, `cg6_gn_setup`,
`cg6_step`, csrc/cg_step6.cu) and K2's IRLS loop and round (`icp_match`,
`icp_iteration`, csrc/icp_kernel.cu), each run as one launch of a
persistent kernel on a thread-block cluster (or a cooperative grid), with
a barrier where the staged sequences (`gn_factor` + `gn_cg`,
`cg_stage_a_staged`, `cg_gn_setup_staged`, `cg_step_staged`, `gn_solve_staged`, `gn_lm_solve_staged` and their gn6
twins, `gn6_factor` + `gn6_cg`, `cg6_stage_a_staged`, `cg6_gn_setup_staged`, `cg6_step_staged`,
`icp_match_staged`, `icp_iteration_staged`) have a kernel boundary; and K8
(`nn_search`, a group of threads a source point on a plain grid) against
the one-thread-a-point `nn_search_serial`. Without a card, the sources are built with g++ under the
emulation of scripts/emulate_gn_kernel.py: a cluster launch runs every
thread of every CTA at once, `cluster.sync()` is a barrier over all of
them, `__syncthreads` one per CTA, `__syncwarp` and the shuffles one per
warp. The cluster and the emulated card are capped at 2 CTAs. At 300
poses the SE(2) cluster has 2 CTAs, one 256-row block each; 600 poses make
CTA 0 walk two of the three blocks. K4's CTAs hold 60 rows at once (384
threads, a group of 6 a row) and form one cluster where one pass over the
rows takes at most the cap, else a cooperative grid with a grid barrier:
sphere(10, 10) (100 poses) runs on a cluster of 2 CTAs, and sphere(9, 60)
(540 poses: three 256-row blocks, so that the block partials' order
shows) on a grid of 2 CTAs that walk five passes; K5, K7b and K7c (K4's
wide stages, the same shape) and K7a (one thread a row on narrow CTAs)
ride in the same run (one build of gn6_kernel.cu and one of
cg_step6.cu). Each case holds the persistent
kernels to
their staged sequences with torch.equal (K3 at lam 0 and 1e-3, with
masked loop slots and on the chain alone, K5 at lam 0 and at 1e-3 with
masked loop slots; K6c on two ranks,
without and with Huber, the whole carry after 1 and 26 passes; K6a and K6b
on two ranks without Huber at lam 0, with Huber at lam 1e-3 and with a
chain-only rank 0 (no loop edge), both ranks' payloads, Aij stashes and
Setups (one thread a row on narrow CTAs: at 600 poses a cooperative grid
of 2 CTAs walking passes); K7b and K7c
on two ranks (half the loop edges each, the chain on rank 0) without Huber
at lam 0, with Huber at lam 1e-3, with masked loop slots and on the chain
alone, both ranks' Setups and whole carries after 1 and 26 passes; K7a on
two ranks without and with Huber, masked and with a chain-only rank 0,
both ranks' payloads and Aij stashes; K1 and K4
in GN mode with warm start and a cg ramp, poses and x, and in LM mode with
Huber, poses and stats). K2 runs once, on a simulated scan pair of 320
points (2 CTAs of 160, 128 a pass: 2 passes), bit for bit: the loop's
delta, H, stats, |upd| and [done, rounds run] with early exit (converged
after some rounds) and without (every round), the source scan on itself
(done after round 1), a tolerance of 0 (every round, never done), masked
source points with invalid and duplicate targets (ties), and 1700 random
targets (above the 1536 a CTA holds in shared memory: a tile at a time);
a round on random points, on targets above one tile, with no valid
target, with NaN points and with infinite points. K8 rides in K2's run:
idx and d2 bit for bit (NaNs by their bits) on random points (P = 300),
ties, duplicate targets, no valid target, 1700 targets, NaN and infinite
source points. Where the card cannot place the cluster (the emulated
occupancy query places none, and a cooperative grid finds no room), every
persistent entry raises, and nothing falls back to the staged sequences
(K8's plain grid needs no co-residency; on a card that cannot place its
CTA the launch itself fails and the wrapper raises).

The emulation runs in a subprocess with a timeout, so that a barrier that
not every thread reaches fails the test instead of hanging it. One build
and one subprocess serve both sizes of a family; under pytest-xdist the
cases share it through tests/_torch_port.py::once_per_session.
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from _torch_port import once_per_session

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 240
MAX_CLUSTER = 2
SE2_POSES = {"2ctas": 300, "ctas_walk_blocks": 600}
SE3_SPHERES = {"k4_cluster_2ctas": (10, 10), "k4_grid_ctas_walk_passes": (9, 60)}
K2_CASES = ("pair_early", "pair_fixed", "self_round1", "tol0_all_rounds", "masked_ties",
            "tiles")


@pytest.fixture(scope="module")
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the CPU emulation of the CUDA sources")


def _emulate(build_dir, *args) -> list:
    """The JSON lines of scripts/emulate_gn_kernel.py --persistent args,
    one a size."""
    cmd = [sys.executable, str(ROOT / "scripts" / "emulate_gn_kernel.py"), "--persistent",
           "--build-dir", str(build_dir), *args]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=TIMEOUT_S, cwd=ROOT)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the emulation did not end in {TIMEOUT_S} s: a barrier deadlock?")
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]


def _family(tmp_path_factory, name, *args) -> dict:
    """{case id: JSON line} of one emulation over a family's sizes."""
    sizes = {"se2": SE2_POSES, "se3": SE3_SPHERES, "k2": {"k2": None}}[name]

    def compute():
        outs = _emulate(tmp_path_factory.mktemp(f"emu_{name}"), *args,
                        "--max-cluster", str(MAX_CLUSTER))
        assert len(outs) == len(sizes), outs
        return dict(zip(sizes, outs))
    return once_per_session(f"persistent_emu_{name}", compute, tmp_path_factory)


@pytest.fixture(scope="module")
def se2_runs(gxx, tmp_path_factory):
    # K1's solves ride in the same run as K3 and K6a-c (one build of
    # gn_kernel.cu and one of cg_step.cu)
    return _family(tmp_path_factory, "se2", "--kernels", "k3,k6c,k6ab,k1",
                   "--poses", ",".join(str(n) for n in SE2_POSES.values()))


@pytest.fixture(scope="module")
def se3_runs(gxx, tmp_path_factory):
    # K5 rides in K4's run (one build of gn6_kernel.cu), K7a-c too
    # (cg_step6.cu built beside it)
    return _family(tmp_path_factory, "se3", "--kernels", "k4,k5,k7a,k7b,k7c",
                   "--rings", ",".join(str(r) for r, _ in SE3_SPHERES.values()),
                   "--per-ring", ",".join(str(p) for _, p in SE3_SPHERES.values()))


def _solves_near_their_twins(out, family):
    """K1's or K4's persistent solves near their plain twins (float32,
    another summation order), the LM steps accepted alike."""
    for mode in ("warm_ramp", "lm_huber"):
        assert out[f"{family}_{mode}_vs_twin"] < 1e-3, out
    stats, twin = out[f"{family}_lm_stats"]
    assert stats[2:] == twin[2:] and stats[2] > 0, out


@pytest.mark.parametrize("case", list(SE2_POSES))
def test_persistent_kernels_equal_their_staged_sequences(se2_runs, case):
    out, poses = se2_runs[case], SE2_POSES[case]
    nb = -(-poses // 256)
    assert (out["poses"], out["blocks"]) == (poses, nb)
    assert out["ctas"] == min(nb, MAX_CLUSTER) == 2
    checks = {k: v for k, v in out.items() if k.endswith(("_bitwise", "_finite"))}
    assert len(checks) == 25 and all(checks.values()), checks
    # K6a and K6b take one pass over the rows where the cap allows it, else
    # a cooperative grid of the CTAs the emulated card holds, walking passes
    assert abs(out["k6a_ctas"]) == abs(out["k6b_ctas"]) == MAX_CLUSTER, out
    if case == "ctas_walk_blocks":
        assert out["k6a_ctas"] < 0 and out["k6b_ctas"] < 0, out
    _solves_near_their_twins(out, "k1")


@pytest.mark.parametrize("case", list(SE3_SPHERES))
def test_persistent_solves_equal_their_staged_sequences(se3_runs, case):
    out = se3_runs[case]
    rings, per_ring = SE3_SPHERES[case]
    poses, slots = out["poses6"], out["slots6"]
    assert poses == rings * per_ring
    want = -(-poses // slots)  # CTAs of one pass over the rows
    assert out["grid6"] == (want > MAX_CLUSTER) and out["ctas6"] == min(want, MAX_CLUSTER) == 2
    walks = -(-poses // (slots * out["ctas6"]))
    assert walks >= 2 if out["grid6"] else walks == 1, out
    checks = {k: v for k, v in out.items()
              if k.endswith(("_bitwise", "_finite")) and not k.startswith("k7")}
    assert len(checks) == 8 and all(checks.values()), checks
    _solves_near_their_twins(out, "k4")


K7_CASES = ("plain", "huber_lam1e-3", "masked", "chain")


@pytest.mark.parametrize("case", list(SE3_SPHERES))
def test_k7_setup_and_cg_pass_equal_their_staged_sequences(se3_runs, case):
    # K7b and K7c take K4's launch shape: a cluster of 2 CTAs at
    # sphere(10, 10), a grid of 2 CTAs walking five passes at sphere(9, 60)
    out = se3_runs[case]
    assert (out["ctas7"], out["grid7"]) == (out["ctas6"], out["grid6"]), out
    checks = {k: v for k, v in out.items() if k.startswith(("k7b", "k7c"))}
    want = {f"k7{s}_{c}_{t}" for c in K7_CASES
            for s, t in (("b", "bitwise"), ("c", "bitwise"), ("c", "finite"))}
    assert set(checks) == want and all(checks.values()), checks


K7A_CASES = ("plain", "huber", "masked", "chain_rank", "small_chain_rank")


@pytest.mark.parametrize("case", list(SE3_SPHERES))
def test_k7a_stage_equals_its_staged_sequence(se3_runs, case):
    # K7a takes one thread a row on narrow CTAs, one pass over max(N, c +
    # El) rows where the cap allows it (the chain-only rank 0 of
    # sphere(6, 10): a cluster), else a cooperative grid of the 2 CTAs the
    # emulated card holds, walking passes (every rank of the case's sphere)
    out = se3_runs[case]
    for c in K7A_CASES:
        assert out[f"k7a_{c}_bitwise"] and out[f"k7a_{c}_finite"], (c, out)
    ctas = [n for c in K7A_CASES[:-1] for n in out[f"k7a_{c}_ctas"]]
    assert all(n == -MAX_CLUSTER for n in ctas), out
    assert 0 < out["k7a_small_chain_rank_ctas"][0] <= MAX_CLUSTER, out


@pytest.fixture(scope="module")
def k2_run(gxx, tmp_path_factory):
    # K8 rides in K2's run (one build of icp_kernel.cu)
    return _family(tmp_path_factory, "k2", "--kernels", "k2,k8")["k2"]


@pytest.mark.parametrize("case", K2_CASES)
def test_icp_loop_equals_its_staged_sequence(k2_run, case):
    out = k2_run
    assert out["k2_ctas"] == MAX_CLUSTER, out
    assert out[f"k2_{case}_bitwise"] and out[f"k2_{case}_finite"], out
    # [done, rounds run]; None: converged after a few of the 16 rounds
    done, rounds = out[f"k2_{case}_ctrl"]
    want_done, want_rounds = {"pair_early": (1, None), "pair_fixed": (0, 16),
                              "self_round1": (1, 1), "tol0_all_rounds": (0, 12),
                              "masked_ties": (1, None), "tiles": (0, 4)}[case]
    assert done == want_done, out
    assert 1 < rounds < 16 if want_rounds is None else rounds == want_rounds, out
    if case == "tiles":
        assert out["k2_tiles_q"] > out["k2_tile"], out


def test_icp_round_equals_its_staged_sequence(k2_run):
    out = k2_run
    for case in ("round", "round_tiles", "round_no_valid", "round_nan_points",
                 "round_inf_points"):
        assert out[f"k2_{case}_bitwise"], (case, out)
    assert out["k2_round_nan_points_nan"], out


K8_CASES = ("random", "ties", "duplicates", "no_valid", "tiles", "nan_points", "inf_points")


@pytest.mark.parametrize("case", K8_CASES)
def test_nn_search_equals_its_serial_shape(k2_run, case):
    # idx and d2 (NaNs by their bits) of nn_search those of
    # nn_search_serial; P = 300 is no multiple of a CTA's groups
    out = k2_run
    assert out[f"k8_{case}_bitwise"], out
    assert out["k8_points"] % 32 and out["k8_tiles_q"] > out["k2_tile"], out
    if case == "ties":
        assert out["k8_ties_twin_idx"], out
    if case == "no_valid":
        assert out["k8_no_valid_inf_at_0"], out


def test_unplaceable_cluster_raises_without_fallback(gxx, tmp_path):
    # K4 at 180 poses with 2 CTAs at most takes the cooperative grid, for
    # which the emulated card holds no CTA (gn6_wide_ctas: 0, an error)
    (out,) = _emulate(tmp_path, "--poses", "300", "--rings", "6", "--per-ring", "30",
                      "--max-cluster", str(MAX_CLUSTER), "--unplaceable")
    assert out["ctas6"] == 0, out
    for name in ("k3", "k6a", "k6b", "k6c", "k1", "k1_lm", "k4", "k4_lm", "k5", "k7a", "k7b",
                 "k7c", "k2", "k2_round"):
        assert out[f"{name}_raised"] and "failed: CUDA error" in out[f"{name}_raised"], out
        assert out[f"{name}_staged_raised"] is None, out
