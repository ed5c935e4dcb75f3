"""The cells at sizes a CPU test run can hold: each cell's config, cut in
size (the sphere's Schur cell at 500 poses, where TF32 already makes the
separator indefinite)."""

from benchmark import specs

SMALL = {
    "m3500": {"n_poses": 300},
    "sphere2500": {"n_rings": 8, "poses_per_ring": 10},
    "sphere2500.schur": {"n_rings": 20, "poses_per_ring": 25},
}
CELLS = tuple(w["name"] for w in specs.benchmark()["workloads"])


def small(cell: str) -> dict:
    return {"configs": SMALL.get(cell, SMALL[cell.split(".")[0]])}
