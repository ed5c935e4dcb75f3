"""The port's checkpoints (io/checkpoint.py) and native g2o parser
(io/native_g2o.py, io/g2o.py's use_native switch) against the JAX package's,
on the CPU.

Tolerances: checkpoints are exact both ways (every array equal, in the same
dtype, under the same key); a graph reloaded in the port gets the
chain_prefix that from_dataset gave, and 2 GN iterations through K1's plain
version on it give the poses of the unsaved graph bit for bit. The native
parser's arrays equal the Python parsers' within atol 1e-12 on SE(2) files
and 1e-10 on SE(3) ones (tests/test_io.py:52-102); it is built here with
g++ and never skipped.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslam_tpu.config import FrontendConfig as JFrontendConfig
from graphslam_tpu.config import SLAMConfig as JSLAMConfig
from graphslam_tpu.factors import from_dataset as jfrom_dataset
from graphslam_tpu.io import checkpoint as jcheckpoint
from graphslam_tpu.io import g2o as jg2o
from graphslam_tpu.slam import init_state as jinit_state

from graphslam_tpu_torch.config import FrontendConfig, SLAMConfig
from graphslam_tpu_torch.factors import from_dataset
from graphslam_tpu_torch.io import checkpoint, datasets, g2o, native_g2o
from graphslam_tpu_torch.ops.gn_kernel import fused_gn_solve
from graphslam_tpu_torch.slam import init_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _small(cfg_cls, fe_cls):
    return cfg_cls(max_keyframes=16, max_factors=32, frontend=fe_cls(num_beams=8, max_points=16))


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_jax_slam_state_loads_in_port(tmp_path):
    s = jinit_state(_small(JSLAMConfig, JFrontendConfig))
    s = s.replace(num_kf=jnp.int32(3), anchor=jnp.array([1.0, 2.0, 0.3]),
                  kf_poses=jnp.asarray(np.random.default_rng(0).normal(size=(16, 3)),
                                       jnp.float32))
    path = str(tmp_path / "jax_state.npz")
    jcheckpoint.save_state(path, s)
    back = checkpoint.load_slam_state(path, device="cpu")
    assert int(back.num_kf) == 3
    for k, v in _npz(path).items():
        got = getattr(back, k).numpy()
        assert got.dtype == v.dtype, k
        assert np.array_equal(got, v), k


def test_port_slam_state_loads_in_jax(tmp_path):
    s = init_state(_small(SLAMConfig, FrontendConfig), device="cpu")
    s = s.replace(num_kf=torch.tensor(5, dtype=torch.int32),
                  anchor=torch.tensor([0.5, -1.0, 0.1]),
                  kf_masks=torch.rand(s.kf_masks.shape, generator=torch.Generator().manual_seed(1))
                  > 0.5)
    path = str(tmp_path / "port_state.npz")
    checkpoint.save_state(path, s)
    saved = _npz(path)
    jref = jinit_state(_small(JSLAMConfig, JFrontendConfig))
    jpath = str(tmp_path / "jax_ref.npz")
    jcheckpoint.save_state(jpath, jref)
    assert {k: v.dtype for k, v in saved.items()} == {k: v.dtype for k, v in _npz(jpath).items()}
    back = jcheckpoint.load_slam_state(path)
    assert int(back.num_kf) == 5
    for k, v in saved.items():
        got = np.asarray(getattr(back, k))
        assert got.dtype == v.dtype, k
        assert np.array_equal(got, getattr(s, k).numpy()), k


def test_jax_graph_reloads_with_chain_prefix_and_runs_k1(tmp_path):
    data = datasets.manhattan(n_poses=64, seed=0)
    jg = jfrom_dataset(data)
    path = str(tmp_path / "graph.npz")
    jcheckpoint.save_state(path, jg)
    assert len(_npz(path)) == 9
    # the JAX package drops the static field; the port recovers it
    assert jg.chain_prefix == 63 and jcheckpoint.load_factor_graph(path).chain_prefix == 0
    g = checkpoint.load_factor_graph(path, device="cpu")
    assert g.chain_prefix == 63
    unsaved = from_dataset(data, device="cpu")
    for f in ("edges", "measurements", "sqrt_info", "edge_mask", "is_loop", "prior_idx",
              "prior_meas", "prior_sqrt_info", "prior_mask"):
        assert torch.equal(getattr(g, f), getattr(unsaved, f)), f
    p0 = torch.from_numpy(data["poses"])
    a = fused_gn_solve(p0, g, iterations=2, cg_iters=10, pcr_levels=4)
    b = fused_gn_solve(p0, unsaved, iterations=2, cg_iters=10, pcr_levels=4)
    assert torch.equal(a, b)
    # and the port's own file of the graph: JAX's keys and dtypes
    ppath = str(tmp_path / "port_graph.npz")
    checkpoint.save_state(ppath, unsaved)
    assert {k: v.dtype for k, v in _npz(ppath).items()} == \
        {k: v.dtype for k, v in _npz(path).items()}
    assert checkpoint.load_factor_graph(ppath, device="cpu").chain_prefix == 63


@pytest.mark.parametrize("edges, prefix", [
    ([], 0), ([(0, 1), (1, 2), (2, 3)], 3), ([(0, 1), (1, 2), (0, 2), (2, 3)], 2),
    ([(1, 2), (0, 1)], 0),
])
def test_chain_prefix_of(edges, prefix):
    assert checkpoint.chain_prefix_of(np.asarray(edges, np.int32)) == prefix


def _messy(path, data, reverse=False):
    jg2o.save_g2o(path, data)
    lines = open(path).read().strip().split("\n")
    vx = [l for l in lines if l.startswith("VERTEX")]
    ed = [l for l in lines if l.startswith("EDGE")]
    body = lines[::-1] if reverse else ed[:3] + vx[::-1] + ed[3:]
    with open(path, "w") as f:
        f.write("# a comment\nFIX 0\n" + "\n".join(body) + "\n")


@pytest.mark.parametrize("kind", ["manhattan", "messy", "se3"])
def test_native_matches_python_parsers(tmp_path, kind):
    path = str(tmp_path / f"{kind}.g2o")
    if kind == "se3":
        jg2o.save_g2o(path, datasets.sphere(n_rings=4, poses_per_ring=6, radius=3.0))
        atol = 1e-10
    else:
        data = datasets.manhattan(n_poses=200 if kind == "manhattan" else 20, seed=21)
        if kind == "messy":
            _messy(path, data, reverse=True)
        else:
            g2o.save_g2o(path, data)
        atol = 1e-12
    raw = native_g2o.parse(path)
    for ref in (g2o._python_parse(path), jg2o._python_parse(path)):
        assert raw.keys() == ref.keys()
        for k in ref:
            assert np.allclose(raw[k], ref[k], atol=atol), k
    a = g2o.load_g2o(path, use_native=True)
    for ref in (g2o.load_g2o(path, use_native=False), jg2o.load_g2o(path, use_native=False)):
        for k in ("poses", "edges", "measurements", "information"):
            assert a[k].dtype == ref[k].dtype, k
            assert np.allclose(a[k], ref[k], atol=atol), k


def test_native_raises_where_load_g2o_falls_back(tmp_path, monkeypatch):
    data = datasets.manhattan(n_poses=20, seed=3)
    path = str(tmp_path / "m.g2o")
    g2o.save_g2o(path, data)
    monkeypatch.setattr(native_g2o, "_LIB", None)
    monkeypatch.setattr(native_g2o, "LIBRARY", tmp_path / "build" / "libg2o_parser.so")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native_g2o.parse(path)
    assert not (tmp_path / "build" / "libg2o_parser.so").exists()
    assert os.listdir(tmp_path / "build") == []
    a = g2o.load_g2o(path, use_native=True)
    b = g2o.load_g2o(path, use_native=False)
    for k in ("poses", "edges", "measurements", "information"):
        assert np.array_equal(a[k], b[k]), k


def test_concurrent_first_builds_leave_one_library(tmp_path):
    lib = tmp_path / "build" / "libg2o_parser.so"
    code = ("import sys; from graphslam_tpu_torch.io import native_g2o; "
            "native_g2o.build(library=sys.argv[1])")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(lib)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    assert os.listdir(lib.parent) == [lib.name]
    path = str(tmp_path / "m.g2o")
    g2o.save_g2o(path, datasets.manhattan(n_poses=20, seed=5))
    check = ("import sys, ctypes; from graphslam_tpu_torch.io import native_g2o as n; "
             "n.LIBRARY = n.Path(sys.argv[1]); print(len(n.parse(sys.argv[2])['ids']))")
    out = subprocess.run([sys.executable, "-c", check, str(lib), path], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "20"
