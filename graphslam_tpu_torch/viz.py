"""Trajectory / map visualization, the markers-node + rviz replacement; port
of graphslam_tpu/viz.py.

The reference re-published every keyframe pose as an rviz ARROW marker at
20 Hz (basic_shapes.cpp:13-42,92-103) and optionally per-scan-point SPHERE
markers (disabled, :44-78). The batch equivalents: figures of the
trajectory with heading arrows, the factor-graph edges (loops highlighted),
and the reprojected map cloud.

The functions take tensors (on any device) or numpy arrays. They draw with
matplotlib (Agg) as the JAX package does, the same artists from the same
data; on a host without matplotlib they draw the same data with PIL
instead, which writes the PNG without a legend.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_FIGSIZE_IN, _DPI = 7, 130


def _np(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None where matplotlib is not
    installed (then PIL draws)."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _ellipses(xy, covariances, every: int, sigma: float):
    """(center, width, height, angle in degrees) of the sigma-contour of
    each `every`-th pose's xy covariance block; non-finite blocks skipped."""
    out = []
    covs = _np(covariances)
    for k in range(0, len(covs), max(every, 1)):
        C = covs[k][:2, :2]
        if not np.all(np.isfinite(C)):
            continue
        w, V = np.linalg.eigh(0.5 * (C + C.T))
        w = np.maximum(w, 0.0)
        ang = np.degrees(np.arctan2(V[1, 1], V[0, 1]))
        out.append((xy[k], 2 * sigma * np.sqrt(w[1]), 2 * sigma * np.sqrt(w[0]), ang))
    return out


def plot_trajectory(
    poses,
    gt=None,
    edges=None,
    is_loop=None,
    covariances=None,
    path: Optional[str] = None,
    title: str = "trajectory",
    arrow_every: int = 20,
    ellipse_every: int = 10,
    ellipse_sigma: float = 2.0,
):
    """Plot an SE(2) (N,3) or SE(3) (N,12) trajectory; optionally overlay
    ground truth, graph edges (loop closures in red), and per-pose
    uncertainty ellipses from (N, 3, 3) marginal covariances (the
    Pose2DWithCovariance contract drawn the way rviz renders covariance
    markers: `ellipse_sigma`-sigma contours of the xy block). Returns
    `path` when given, else the figure (a PIL image without matplotlib)."""
    poses = _np(poses)
    xy = poses[:, 9:11] if poses.shape[-1] == 12 else poses[:, :2]
    segs = []
    if edges is not None:
        edges = _np(edges)
        mask = np.ones(len(edges), bool) if is_loop is None else _np(is_loop)
        segs = [(np.array([[xy[i, 0], xy[j, 0]], [xy[i, 1], xy[j, 1]]]), bool(lp))
                for (i, j), lp in zip(edges, mask)]
    gxy = None
    if gt is not None:
        gt = _np(gt)
        gxy = gt[:, 9:11] if gt.shape[-1] == 12 else gt[:, :2]
    ells = [] if covariances is None else _ellipses(xy, covariances, ellipse_every,
                                                    ellipse_sigma)
    arrows = None
    if poses.shape[-1] == 3:
        sub = poses[::arrow_every]
        arrows = (sub[:, 0], sub[:, 1], np.cos(sub[:, 2]), np.sin(sub[:, 2]))

    plt = _pyplot()
    if plt is None:
        canvas = _Canvas(title)
        for (lx, ly), lp in segs:
            canvas.line(lx, ly, (255, 99, 71) if lp else (217, 217, 217), 1)
        if gxy is not None:
            canvas.line(gxy[:, 0], gxy[:, 1], (0, 128, 0), 1, dashed=True)
        canvas.line(xy[:, 0], xy[:, 1], (0, 0, 255), 1)
        for c, w, h, ang in ells:
            canvas.ellipse(c, w, h, ang, (255, 165, 0))
        if arrows is not None:
            canvas.arrows(*arrows, (0, 0, 128))
        return canvas.finish(path)

    fig, ax = plt.subplots(figsize=(_FIGSIZE_IN, _FIGSIZE_IN))
    for (lx, ly), lp in segs:
        ax.plot(lx, ly, color="tomato" if lp else "0.85", lw=0.7 if lp else 0.4, zorder=1)
    if gxy is not None:
        ax.plot(gxy[:, 0], gxy[:, 1], "g--", lw=0.8, label="ground truth", zorder=2)
    ax.plot(xy[:, 0], xy[:, 1], "b-", lw=1.0, label="estimate", zorder=3)
    if ells:
        from matplotlib.patches import Ellipse

        for c, w, h, ang in ells:
            ax.add_patch(Ellipse(c, width=w, height=h, angle=ang, facecolor="none",
                                 edgecolor="orange", lw=0.7, zorder=4))
    # Heading arrows (the rviz ARROW markers).
    if arrows is not None:
        ax.quiver(*arrows, scale=40, width=2.5e-3, color="navy", zorder=4)
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    ax.set_title(title)
    if path:
        fig.savefig(path, dpi=_DPI, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def plot_map(kf_poses, kf_points, kf_masks, num_kf, path: Optional[str] = None):
    """Reproject keyframe scans through optimized poses into one map cloud
    (the disabled create_scan spheres, done right), through
    geometry/se2.py::transform on the poses' device."""
    from graphslam_tpu_torch.geometry import se2

    n = int(num_kf)
    poses = torch.as_tensor(kf_poses)[:n]
    pts = torch.as_tensor(kf_points)[:n].to(poses.device)
    world = _np(se2.transform(poses, pts))
    masks = _np(kf_masks)[:n].astype(bool)
    p = _np(poses)
    title = f"map ({n} keyframes)"

    plt = _pyplot()
    if plt is None:
        canvas = _Canvas(title)
        for k in range(n):
            w = world[k][masks[k]]
            canvas.points(w[:, 0], w[:, 1], (153, 153, 153))
        canvas.line(p[:, 0], p[:, 1], (0, 0, 255), 1, marks=True)
        return canvas.finish(path)

    fig, ax = plt.subplots(figsize=(_FIGSIZE_IN, _FIGSIZE_IN))
    for k in range(n):
        w = world[k][masks[k]]
        ax.scatter(w[:, 0], w[:, 1], s=0.2, c="0.4", alpha=0.5)
    ax.plot(p[:, 0], p[:, 1], "b.-", lw=1.0, ms=2.5)
    ax.set_aspect("equal")
    ax.set_title(title)
    if path:
        fig.savefig(path, dpi=_DPI, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


class _Canvas:
    """The PIL drawing of a figure: primitives in data coordinates, laid out
    at equal aspect on a white square of the matplotlib figure's pixel size
    when `finish` draws them."""

    def __init__(self, title: str):
        self.title = title
        self.ops = []
        self.xs, self.ys = [], []

    def _add(self, x, y, *op):
        x, y = np.asarray(x, np.float64).ravel(), np.asarray(y, np.float64).ravel()
        keep = np.isfinite(x) & np.isfinite(y)
        self.xs.append(x[keep])
        self.ys.append(y[keep])
        self.ops.append((x, y) + op)

    def line(self, x, y, color, width, dashed=False, marks=False):
        self._add(x, y, "line", color, width, dashed, marks)

    def points(self, x, y, color):
        self._add(x, y, "points", color)

    def ellipse(self, center, width, height, angle_deg, color):
        t = np.linspace(0.0, 2 * np.pi, 65)
        a = np.radians(angle_deg)
        ex, ey = 0.5 * width * np.cos(t), 0.5 * height * np.sin(t)
        self._add(center[0] + ex * np.cos(a) - ey * np.sin(a),
                  center[1] + ex * np.sin(a) + ey * np.cos(a), "line", color, 1, False, False)

    def arrows(self, x, y, u, v, color):
        self._add(x, y, "arrows", color, np.asarray(u, np.float64), np.asarray(v, np.float64))

    def finish(self, path: Optional[str]):
        from PIL import Image, ImageDraw

        size, margin = _FIGSIZE_IN * _DPI, 40
        img = Image.new("RGB", (size, size), "white")
        draw = ImageDraw.Draw(img)
        xs = np.concatenate(self.xs) if self.xs else np.zeros(0)
        ys = np.concatenate(self.ys) if self.ys else np.zeros(0)
        if xs.size == 0:
            xs, ys = np.zeros(1), np.zeros(1)
        x0, y0 = xs.min(), ys.min()
        span = max(xs.max() - x0, ys.max() - y0, 1e-9)
        scale = (size - 2 * margin) / span
        ox = margin + 0.5 * (size - 2 * margin - (xs.max() - x0) * scale)
        oy = margin + 0.5 * (size - 2 * margin - (ys.max() - y0) * scale)

        def px(x, y):
            return ox + (x - x0) * scale, size - oy - (y - y0) * scale

        for op in self.ops:
            x, y, kind, color = op[:4]
            X, Y = px(x, y)
            if kind == "points":
                keep = np.isfinite(X) & np.isfinite(Y)
                draw.point(list(zip(X[keep].tolist(), Y[keep].tolist())), fill=color)
            elif kind == "line":
                width, dashed, marks = op[4:]
                pts = list(zip(X.tolist(), Y.tolist()))
                if dashed:
                    for k in range(0, len(pts) - 1, 2):
                        draw.line(pts[k:k + 2], fill=color, width=width)
                elif len(pts) > 1:
                    draw.line(pts, fill=color, width=width)
                if marks:
                    for a, b in pts:
                        draw.ellipse((a - 1.5, b - 1.5, a + 1.5, b + 1.5), fill=color)
            else:  # arrows: 1/40 of the plot's width, as matplotlib's quiver(scale=40)
                u, v = op[4:]
                length = (size - 2 * margin) / 40.0
                for a, b, du, dv in zip(X, Y, u, v):
                    ex, ey = a + length * du, b - length * dv
                    draw.line([(a, b), (ex, ey)], fill=color, width=2)
                    hx, hy = 0.35 * length * du, -0.35 * length * dv
                    draw.polygon([(ex, ey), (ex - hx - 0.5 * hy, ey - hy + 0.5 * hx),
                                  (ex - hx + 0.5 * hy, ey - hy - 0.5 * hx)], fill=color)
        draw.text((margin, 10), self.title, fill="black")
        if path:
            img.save(path, format="PNG")
            return path
        return img
