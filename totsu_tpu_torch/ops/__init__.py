"""Compute primitives: packed-symmetric storage and the CUDA kernels."""

from totsu_tpu_torch.ops import sympack
