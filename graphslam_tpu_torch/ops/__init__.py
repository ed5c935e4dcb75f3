"""Hand-written Hopper kernels (csrc/*.cu) with their plain torch twins.

Each wrapper takes its plain twin only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. Kernels are built with nvcc at
first use (ops/_build.py), never at import.
"""
