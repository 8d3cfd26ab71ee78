"""Carry state across from the JAX package (``totsu_tpu``).

The JAX package's ``SolverParam``, ``Factor`` and ``ConeLayout`` are plain
frozen dataclasses, so their fields are read here without importing
``jax``: the caller hands the objects in. Problem data is handed over as
numpy arrays, which both packages accept; in the port it goes to the CUDA
card unless the caller names another device.
"""

import dataclasses

import numpy as np
import torch

from totsu_tpu_torch.solver.cone import CUSTOM, ConeLayout, Factor
from totsu_tpu_torch.solver.operator import target_device
from totsu_tpu_torch.solver.params import SolverParam


def param_from_reference(p) -> SolverParam:
    """The port's SolverParam with every field of the JAX one, by name.
    Raises if the JAX dataclass has a field the port does not know."""
    ours = {f.name for f in dataclasses.fields(SolverParam)}
    theirs = [f.name for f in dataclasses.fields(p)]
    unknown = [name for name in theirs if name not in ours]
    if unknown:
        raise ValueError(f"SolverParam fields without a port: {unknown}")
    return SolverParam(**{name: getattr(p, name) for name in theirs})


def cone_from_reference(layout) -> ConeLayout:
    """The port's ConeLayout from a JAX ConeLayout, factor by factor
    (``kind``, ``dim``, ``count``, ``variant``, ``alpha``). Custom factors
    carry JAX projection functions and cannot cross."""
    factors = []
    for f in layout.factors:
        if f.kind == CUSTOM:
            raise NotImplementedError(
                "custom cone factors hold JAX projections; build them in "
                "the port with totsu_tpu_torch.custom")
        factors.append(Factor(f.kind, f.dim, f.count, variant=f.variant,
                              alpha=f.alpha))
    return ConeLayout(factors)


def problem_from_numpy(c, a, b, *, device=None, dtype=torch.float64):
    """(c, A, b) as contiguous tensors of ``dtype`` on ``device`` (default
    the CUDA card; raises without one)."""
    dev = target_device(device)
    return tuple(torch.as_tensor(np.asarray(x), dtype=dtype,
                                 device=dev).contiguous()
                 for x in (c, a, b))
