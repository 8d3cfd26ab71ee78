"""Hand-written Hopper kernels: Python wrappers of ``totsu_tpu_torch/csrc``.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain PyTorch version, which sits in the same module, for CPU tensors.
Kernels are built with ``nvcc`` at first use (``_build.py``), never when a
module is imported.
"""
