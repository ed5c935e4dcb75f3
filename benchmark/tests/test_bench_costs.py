"""The frozen cost arithmetic gives chip_smoke.py's bounds."""

import importlib.util
import math

import pytest

from benchmark import costs, run, specs


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", specs.ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shape(cfg_name, seed=3):
    cfg = specs.data("configs", cfg_name)
    data = specs.module("generators", cfg["generator"]).make(cfg, seed)
    c = run.chain_length(data["edges"])
    return data["poses"].shape[0], c, len(data["edges"]) - c


@pytest.mark.parametrize("name", ["gn_cost", "lm_cost", "gn6_cost"])
def test_the_copies_count_as_chip_smoke_does(name):
    cs = _chip_smoke()
    for args in ((3500, 3499, 1937, 4, 50, 25), (2500, 2499, 2450, 12, 20, 25), (100, 99, 7, 3, 2, 5)):
        assert getattr(costs, name)(*args) == getattr(cs, name)(*args)
        assert costs.bound_ms(*getattr(costs, name)(*args)) == cs._bound(*getattr(cs, name)(*args))[0]


def test_the_bounds_at_the_cells_shapes():
    # chip_smoke.py's m3500 (io/datasets.py::m3500, 1937 loops): 0.0243 ms
    assert round(costs.bound_ms(*costs.lm_cost(3500, 3499, 1937, 4, 50, 25)), 4) == 0.0243
    # the cell's graph (structure seed 0 of generators/manhattan.py) on every seed
    assert _shape("m3500", 3) == _shape("m3500", 2**31 + 5) == (3500, 3499, 1949)
    N, c, El = _shape("sphere2500")
    assert (N, c, El) == (2500, 2499, 2450)
    K = costs.pcr_levels(N, None)
    assert K == math.ceil(math.log2(2500)) == 12
    assert round(costs.bound_ms(*costs.gn6_cost(N, c, El, K, 20, 25)), 4) == 0.0704
