"""The port's numpy-only io/ against graphslam_tpu.io: bit-identical graphs."""

import numpy as np
import pytest

from graphslam_tpu.io import datasets as jds
from graphslam_tpu.io import g2o as jg2o
from graphslam_tpu_torch.io import datasets as tds
from graphslam_tpu_torch.io import g2o as tg2o


def _assert_identical(a, b):
    assert set(a) == set(b)
    for k in a:
        va, vb = np.asarray(a[k]), np.asarray(b[k])
        assert va.dtype == vb.dtype, k
        assert va.shape == vb.shape, k
        # bit-identical: same generator code, same seeds, same dtypes
        assert np.array_equal(va, vb), k


@pytest.mark.parametrize(
    "name, kw",
    [
        ("manhattan", dict(n_poses=260, loop_prob=0.25, seed=0)),
        ("m3500", {}),
        ("intel_like", {}),
        ("city10000", {}),
        ("sphere2500", {}),
        ("garage", {}),
    ],
)
def test_generators_bit_identical(name, kw):
    _assert_identical(getattr(jds, name)(**kw), getattr(tds, name)(**kw))


def test_load_by_name_matches():
    _assert_identical(jds.load("intel"), tds.load("intel"))


@pytest.mark.parametrize("dim", [2, 3])
def test_g2o_roundtrip_matches_reference_parser(tmp_path, dim):
    data = (
        tds.manhattan(n_poses=60, seed=3) if dim == 2
        else tds.sphere(n_rings=4, poses_per_ring=6, seed=1)
    )
    path = str(tmp_path / "g.g2o")
    tg2o.save_g2o(path, data)
    ours = tg2o.load_g2o(path)
    ref = jg2o.load_g2o(path, use_native=False)
    _assert_identical(ours, ref)
    assert ours["dim"] == dim
