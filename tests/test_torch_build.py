"""The CUDA build's cache key (graphslam_tpu_torch/ops/_build.py): a library
is named by a hash of the flags, its source and every csrc/ header the
source includes, so an edited header rebuilds each library that includes
it. No nvcc is needed: only the names are computed."""

from graphslam_tpu_torch.ops import _build


def test_sources_follow_quoted_includes():
    names = {n: [p.name for p in _build.sources(n)] for n in
             ("gn_kernel", "cg_step", "gn6_kernel", "cg_step6", "icp_kernel")}
    assert names["gn_kernel"] == ["gn_kernel.cu", "se2_blocks.cuh", "persistent.cuh"]
    assert names["cg_step"] == ["cg_step.cu", "se2_blocks.cuh", "persistent.cuh"]
    assert names["gn6_kernel"] == ["gn6_kernel.cu", "se3_blocks.cuh", "persistent.cuh"]
    assert names["cg_step6"] == ["cg_step6.cu", "se3_blocks.cuh", "persistent.cuh"]
    assert names["icp_kernel"] == ["icp_kernel.cu", "persistent.cuh"]


def test_an_edited_header_renames_every_library_that_includes_it(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    (tmp_path / "a.cu").write_text('#include <cuda_runtime.h>\n#include "b.cuh"\nint a;\n')
    (tmp_path / "other.cu").write_text("int other;\n")
    (tmp_path / "b.cuh").write_text('#pragma once\n  #  include "c.cuh"\nint b;\n')
    (tmp_path / "c.cuh").write_text("int c;\n")
    assert [p.name for p in _build.sources("a")] == ["a.cu", "b.cuh", "c.cuh"]
    lib_a, lib_other = _build._target("a")[1], _build._target("other")[1]
    (tmp_path / "c.cuh").write_text("int c2;\n")
    assert _build._target("a")[1] != lib_a
    assert _build._target("other")[1] == lib_other
    lib_a = _build._target("a")[1]
    (tmp_path / "a.cu").write_text('#include <cuda_runtime.h>\n#include "b.cuh"\nint a2;\n')
    assert _build._target("a")[1] != lib_a
