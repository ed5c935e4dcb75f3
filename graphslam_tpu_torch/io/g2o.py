"""g2o pose-graph file reader/writer.

Produces the struct-of-arrays factor-graph layout the solver consumes
(SURVEY.md §7.2). Supports the standard 2D and 3D tags:

  VERTEX_SE2 id x y theta
  EDGE_SE2 i j dx dy dtheta  i11 i12 i13 i22 i23 i33          (upper-tri info)
  VERTEX_SE3:QUAT id x y z qx qy qz qw
  EDGE_SE3:QUAT i j  x y z qx qy qz qw  21 upper-tri info entries

A copy of graphslam_tpu/io/g2o.py that needs no JAX. It parses in pure
numpy only: the native C++ parser (native/g2o_parser.cc) is not wired in
yet (ROADMAP.md, module queue).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _quat_to_mat(qx, qy, qz, qw):
    """Vectorized xyzw quaternion -> rotation matrix, shape (..., 3, 3)."""
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    R = np.empty((*np.shape(qx), 3, 3), dtype=np.float64)
    R[..., 0, 0] = 1 - 2 * (qy * qy + qz * qz)
    R[..., 0, 1] = 2 * (qx * qy - qz * qw)
    R[..., 0, 2] = 2 * (qx * qz + qy * qw)
    R[..., 1, 0] = 2 * (qx * qy + qz * qw)
    R[..., 1, 1] = 1 - 2 * (qx * qx + qz * qz)
    R[..., 1, 2] = 2 * (qy * qz - qx * qw)
    R[..., 2, 0] = 2 * (qx * qz - qy * qw)
    R[..., 2, 1] = 2 * (qy * qz + qx * qw)
    R[..., 2, 2] = 1 - 2 * (qx * qx + qy * qy)
    return R


def _mat_to_quat(R):
    """Rotation matrix (..., 3, 3) -> xyzw quaternion (robust Shepperd)."""
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = 0.5 * np.sqrt(np.maximum(0.0, 1.0 + tr))
    qx = 0.5 * np.sqrt(np.maximum(0.0, 1.0 + m00 - m11 - m22))
    qy = 0.5 * np.sqrt(np.maximum(0.0, 1.0 - m00 + m11 - m22))
    qz = 0.5 * np.sqrt(np.maximum(0.0, 1.0 - m00 - m11 + m22))
    qx = np.copysign(qx, R[..., 2, 1] - R[..., 1, 2])
    qy = np.copysign(qy, R[..., 0, 2] - R[..., 2, 0])
    qz = np.copysign(qz, R[..., 1, 0] - R[..., 0, 1])
    q = np.stack([qx, qy, qz, qw], axis=-1)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _upper_tri_to_full(vals: np.ndarray, d: int) -> np.ndarray:
    """(..., d*(d+1)/2) upper-triangular row-major entries -> (..., d, d)."""
    out = np.zeros((*vals.shape[:-1], d, d), dtype=vals.dtype)
    k = 0
    for i in range(d):
        for j in range(i, d):
            out[..., i, j] = vals[..., k]
            out[..., j, i] = vals[..., k]
            k += 1
    return out


def load_g2o(path: str) -> Dict[str, np.ndarray]:
    """Load a g2o file into the solver's struct-of-arrays layout.

    Returns a dict with:
      dim:        2 or 3
      poses:      (N, 3) [x,y,theta] for 2D; (N, 12) flat [R|t] for 3D
      edges:      (E, 2) int32 (i, j)
      measurements: (E, 3) or (E, 12) relative pose z_ij
      information:  (E, 3, 3) or (E, 6, 6) information matrices
    """
    return _finalize(_python_parse(path))


def _python_parse(path: str) -> Dict[str, np.ndarray]:
    v2_ids, v2 = [], []
    v3_ids, v3_t, v3_q = [], [], []
    e2_ij, e2_z, e2_info = [], [], []
    e3_ij, e3_t, e3_q, e3_info = [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "VERTEX_SE2":
                v2_ids.append(int(parts[1]))
                v2.append([float(x) for x in parts[2:5]])
            elif tag == "EDGE_SE2":
                e2_ij.append([int(parts[1]), int(parts[2])])
                e2_z.append([float(x) for x in parts[3:6]])
                e2_info.append([float(x) for x in parts[6:12]])
            elif tag == "VERTEX_SE3:QUAT":
                v3_ids.append(int(parts[1]))
                v3_t.append([float(x) for x in parts[2:5]])
                v3_q.append([float(x) for x in parts[5:9]])
            elif tag == "EDGE_SE3:QUAT":
                e3_ij.append([int(parts[1]), int(parts[2])])
                e3_t.append([float(x) for x in parts[3:6]])
                e3_q.append([float(x) for x in parts[6:10]])
                e3_info.append([float(x) for x in parts[10:31]])
    if v2_ids:
        return {
            "dim": 2,
            "ids": np.asarray(v2_ids, np.int64),
            "poses_raw": np.asarray(v2, np.float64),
            "edges": np.asarray(e2_ij, np.int64),
            "meas_raw": np.asarray(e2_z, np.float64),
            "info_raw": np.asarray(e2_info, np.float64),
        }
    return {
        "dim": 3,
        "ids": np.asarray(v3_ids, np.int64),
        "poses_t": np.asarray(v3_t, np.float64),
        "poses_q": np.asarray(v3_q, np.float64),
        "edges": np.asarray(e3_ij, np.int64),
        "meas_t": np.asarray(e3_t, np.float64),
        "meas_q": np.asarray(e3_q, np.float64),
        "info_raw": np.asarray(e3_info, np.float64),
    }


def _finalize(parsed: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    # Remap arbitrary vertex ids to dense [0, N) indices.
    ids = parsed["ids"]
    order = np.argsort(ids, kind="stable")
    id_to_idx = np.empty(int(ids.max()) + 1, dtype=np.int64)
    id_to_idx[ids[order]] = np.arange(len(ids))
    edges = id_to_idx[parsed["edges"]].astype(np.int32)

    if parsed["dim"] == 2:
        poses = parsed["poses_raw"][order].astype(np.float32)
        meas = parsed["meas_raw"].astype(np.float32)
        info = _upper_tri_to_full(parsed["info_raw"], 3).astype(np.float32)
        return {
            "dim": 2,
            "poses": poses,
            "edges": edges,
            "measurements": meas,
            "information": info,
        }
    q = parsed["poses_q"]
    R = _quat_to_mat(q[..., 0], q[..., 1], q[..., 2], q[..., 3])
    poses = np.concatenate(
        [R.reshape(-1, 9), parsed["poses_t"]], axis=-1
    )[order].astype(np.float32)
    qm = parsed["meas_q"]
    Rm = _quat_to_mat(qm[..., 0], qm[..., 1], qm[..., 2], qm[..., 3])
    meas = np.concatenate([Rm.reshape(-1, 9), parsed["meas_t"]], axis=-1).astype(
        np.float32
    )
    info = _upper_tri_to_full(parsed["info_raw"], 6).astype(np.float32)
    return {
        "dim": 3,
        "poses": poses,
        "edges": edges,
        "measurements": meas,
        "information": info,
    }


def save_g2o(path: str, graph: Dict[str, np.ndarray]) -> None:
    """Write the struct-of-arrays graph back to g2o text."""
    poses = np.asarray(graph["poses"], np.float64)
    edges = np.asarray(graph["edges"])
    meas = np.asarray(graph["measurements"], np.float64)
    info = np.asarray(graph["information"], np.float64)
    lines = []
    if graph["dim"] == 2:
        for i, p in enumerate(poses):
            lines.append(f"VERTEX_SE2 {i} {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}")
        for (i, j), z, I in zip(edges, meas, info):
            ut = [I[a, b] for a in range(3) for b in range(a, 3)]
            ut_s = " ".join(f"{x:.9g}" for x in ut)
            lines.append(
                f"EDGE_SE2 {i} {j} {z[0]:.9g} {z[1]:.9g} {z[2]:.9g} {ut_s}"
            )
    else:
        for i, p in enumerate(poses):
            R, t = p[:9].reshape(3, 3), p[9:12]
            q = _mat_to_quat(R)
            lines.append(
                f"VERTEX_SE3:QUAT {i} "
                f"{t[0]:.9g} {t[1]:.9g} {t[2]:.9g} "
                f"{q[0]:.9g} {q[1]:.9g} {q[2]:.9g} {q[3]:.9g}"
            )
        for (i, j), z, I in zip(edges, meas, info):
            R, t = z[:9].reshape(3, 3), z[9:12]
            q = _mat_to_quat(R)
            ut = [I[a, b] for a in range(6) for b in range(a, 6)]
            ut_s = " ".join(f"{x:.9g}" for x in ut)
            lines.append(
                f"EDGE_SE3:QUAT {i} {j} "
                f"{t[0]:.9g} {t[1]:.9g} {t[2]:.9g} "
                f"{q[0]:.9g} {q[1]:.9g} {q[2]:.9g} {q[3]:.9g} {ut_s}"
            )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
