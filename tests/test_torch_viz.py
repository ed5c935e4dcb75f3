"""The port's figures (viz.py) against the JAX package's, on the CPU, by
their data rather than their pixels.

Tolerance 1e-5 on every drawn coordinate: the lines' data, the scatter
offsets, the quiver positions and directions, and the ellipses' centres,
sizes and angles of plot_trajectory and plot_map (the map's points are
reprojected in float32 by each package's se2.transform). The PIL drawing
that the port uses on a host without matplotlib writes a PNG of the
figure's size.
"""

import sys

import matplotlib

matplotlib.use("Agg")

import jax.numpy as jnp  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from graphslam_tpu import viz as jviz  # noqa: E402
from graphslam_tpu_torch import viz  # noqa: E402
from graphslam_tpu_torch.io import datasets  # noqa: E402

TOL = 1e-5


def _artists(fig):
    """Every drawn datum of a figure's axes, in drawing order."""
    from matplotlib.collections import PathCollection
    from matplotlib.patches import Ellipse
    from matplotlib.quiver import Quiver

    ax = fig.axes[0]
    out = {"lines": [np.stack([l.get_xdata(), l.get_ydata()]) for l in ax.lines],
           "scatter": [c.get_offsets().data for c in ax.collections
                       if isinstance(c, PathCollection)],
           "quiver": [np.stack([c.X, c.Y, c.U, c.V]) for c in ax.collections
                      if isinstance(c, Quiver)],
           "ellipses": [np.array([*p.center, p.width, p.height, p.angle]) for p in ax.patches
                        if isinstance(p, Ellipse)],
           "title": ax.get_title()}
    plt.close(fig)
    return out


def _same(a, b):
    assert a["title"] == b["title"]
    for k in ("lines", "scatter", "quiver", "ellipses"):
        assert len(a[k]) == len(b[k]), k
        for x, y in zip(a[k], b[k]):
            assert x.shape == y.shape, k
            assert np.allclose(np.asarray(x, np.float64), np.asarray(y, np.float64),
                               atol=TOL, rtol=0), k


@pytest.fixture(scope="module")
def traj():
    d = datasets.manhattan(n_poses=100, seed=2)
    rng = np.random.default_rng(4)
    A = rng.normal(size=(100, 3, 3)).astype(np.float32) * 0.1
    covs = np.einsum("nij,nkj->nik", A, A) + 1e-3 * np.eye(3, dtype=np.float32)
    covs[9] = np.nan  # a non-finite block is skipped
    return d, covs


def test_plot_trajectory_matches_jax(traj):
    d, covs = traj
    kw = dict(gt=d["gt"], edges=d["edges"], is_loop=d["is_loop"], covariances=covs,
              ellipse_every=3, title="m100")
    ours = _artists(viz.plot_trajectory(torch.from_numpy(d["poses"]), **kw))
    ref = _artists(jviz.plot_trajectory(d["poses"], **kw))
    assert len(ours["ellipses"]) == 33 and len(ours["quiver"]) == 1
    _same(ours, ref)


def test_plot_trajectory_se3_matches_jax():
    d = datasets.sphere(n_rings=4, poses_per_ring=6)
    ours = _artists(viz.plot_trajectory(d["poses"], gt=torch.from_numpy(d["gt"]),
                                        edges=torch.from_numpy(d["edges"])))
    ref = _artists(jviz.plot_trajectory(d["poses"], gt=d["gt"], edges=d["edges"]))
    assert not ours["quiver"]
    _same(ours, ref)


def _map_inputs():
    rng = np.random.default_rng(0)
    kf_poses = rng.normal(size=(5, 3)).astype(np.float32)
    kf_points = rng.normal(size=(5, 32, 2)).astype(np.float32) * 3
    kf_masks = rng.random((5, 32)) > 0.3
    return kf_poses, kf_points, kf_masks


def test_plot_map_matches_jax():
    kf_poses, kf_points, kf_masks = _map_inputs()
    ours = _artists(viz.plot_map(torch.from_numpy(kf_poses), torch.from_numpy(kf_points),
                                 torch.from_numpy(kf_masks), torch.tensor(4)))
    ref = _artists(jviz.plot_map(jnp.asarray(kf_poses), jnp.asarray(kf_points), kf_masks, 4))
    assert len(ours["scatter"]) == 4
    _same(ours, ref)


def test_pil_drawing_writes_pngs(tmp_path, traj, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # a host without matplotlib
    d, covs = traj
    p = str(tmp_path / "traj.png")
    assert viz.plot_trajectory(d["poses"], gt=d["gt"], edges=d["edges"], is_loop=d["is_loop"],
                               covariances=covs, path=p) == p
    m = str(tmp_path / "map.png")
    assert viz.plot_map(*_map_inputs(), 5, path=m) == m
    s = datasets.sphere(n_rings=4, poses_per_ring=6)
    img = viz.plot_trajectory(s["poses"], gt=s["gt"])
    for im in (Image.open(p), Image.open(m), img):
        assert im.size == (910, 910)
        assert len(im.convert("RGB").getcolors(1 << 20)) > 2  # drawn, not blank
