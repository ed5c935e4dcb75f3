"""The benchmark of graphslam_tpu_torch: cells of BENCHMARK.json run by run.py."""
