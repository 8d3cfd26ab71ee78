"""Carry state across from the JAX package (``totsu_tpu``).

The JAX package's ``SolverParam``, ``Factor``, ``ConeLayout``,
``ResumeState`` and operators are plain frozen dataclasses, so their
fields are read here without importing ``jax``: the caller hands the
objects in. Problem data, an operator's arrays and a checkpoint's arrays
are handed over as numpy arrays, which both packages accept; in the port
they go to the CUDA card unless the caller names another device.
"""

import dataclasses

import numpy as np
import torch

from totsu_tpu_torch.solver.cone import CUSTOM, ConeLayout, Factor
from totsu_tpu_torch.solver.conic import ResumeState
from totsu_tpu_torch.solver import operator as op_
from totsu_tpu_torch.solver.operator import as_dtype, target_device
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


# the integer entries of a checkpoint's aux (epoch counters, the status)
_AUX_INTS = ("ke", "status")


def resume_state_from_reference(state, *, device=None, dtype=None
                                ) -> ResumeState:
    """The port's ResumeState from a JAX one, so a solve checkpointed in
    the JAX package continues in the port on the same path. Arrays go
    through numpy to ``device`` (default the CUDA card) in ``dtype``
    (default their own). The JAX direct engine's Cholesky factor is upper
    triangular (``cho_factor``), the port's lower: it is transposed. The
    indirect engine's CG warm start ``ws = (z1, worst_rel2)`` crosses as
    it is; the dense engine's ``ws`` is a 0-d placeholder the port does
    not keep."""
    dev = target_device(device)
    tdt = None if dtype is None else as_dtype(dtype)

    def tensor(x):
        return torch.as_tensor(np.array(x), dtype=tdt, device=dev)

    def tree(x):
        return tuple(tree(i) for i in x) if isinstance(x, tuple) \
            else tensor(x)

    aux = {}
    for key, val in state.aux.items():
        if key == "ws":
            if isinstance(val, tuple):
                aux[key] = tree(val)
            continue
        if key in _AUX_INTS:
            aux[key] = int(np.asarray(val))
        elif key == "chol_c":
            aux[key] = tensor(np.triu(np.asarray(val)).T)
        else:
            aux[key] = tree(val)
    if "chol_c" in aux or "prec" in aux:
        aux["refine_steps"] = 0 if "chol_c" in aux else 2
    return ResumeState(u=tree(state.u), v=tree(state.v),
                       k=int(np.asarray(state.k)), aux=aux,
                       engine=state.engine, accel=state.accel)


def operator_from_reference(op, *, device=None, dtype=None, batch=None
                            ) -> op_.LinOp:
    """The port's operator from a JAX one, field by field through numpy
    (arrays to ``device``, default the CUDA card, floating data in
    ``dtype``, default its own): ``DenseOp`` (and ``PallasDenseOp``),
    ``DiagOp``, ``ZeroOp``, the stacks recursively, ``ScaledOp``,
    ``BlockedEllOp`` (its tiles into the port's layout, the same slots and
    indices) and ``SparseOp`` (the BCOO coordinate list less its padding;
    coalesced when the BCOO says its indices are unique). A ``CustomOp``
    holds JAX functions and cannot cross.

    ``batch=B`` takes a batch-leading pytree (every array with a leading
    lane axis of B, a ``ScaledOp``'s alpha (B,), a ``SparseOp``'s BCOO
    batched with ``n_batch=1``) and returns the port's batch:
    ``BatchedOp.stack`` of its lanes (a ``BatchedDenseOp`` for a
    ``DenseOp``, the block-diagonal ``BatchedSparseOp`` for a
    ``SparseOp``)."""
    dev = target_device(device)
    if batch is None:
        return _from_reference(op, dev, dtype, None)
    return op_.BatchedOp.stack([_from_reference(op, dev, dtype, i)
                                for i in range(batch)])


def _from_reference(op, dev, dtype, lane):
    """The port's operator from a JAX one; ``lane`` None for a single
    operator, else the lane of a batch-leading one."""
    tdt = None if dtype is None else as_dtype(dtype)

    def arr(x):
        x = np.array(x)
        return x if lane is None else x[lane]

    def data(x):
        return torch.as_tensor(arr(x), dtype=tdt, device=dev)

    def child(o):
        return _from_reference(o, dev, dtype, lane)

    kind = type(op).__name__
    if kind in ("DenseOp", "PallasDenseOp"):
        return op_.DenseOp(data(op.a))
    if kind == "DiagOp":
        return op_.DiagOp(data(op.d))
    if kind == "ZeroOp":
        return op_.ZeroOp(op.m, op.n, device=dev, dtype=tdt)
    if kind in ("VStackOp", "HStackOp"):
        return getattr(op_, kind)(tuple(child(o) for o in op.ops))
    if kind == "ScaledOp":
        return op_.ScaledOp(float(arr(op.alpha)), child(op.op))
    if kind == "BlockedEllOp":
        ell = op_.BlockedEllOp.from_slots(
            arr(op.blocks), arr(op.cols), arr(op.blocks_t), arr(op.cols_t),
            m=op.m, n=op.n, bm=op.bm, bn=op.bn, device=dev)
        return ell if tdt is None else ell.astype(tdt)
    if kind == "SparseOp":
        mat = op.mat
        shape = tuple(mat.shape)[-2:]
        idx = arr(mat.indices).reshape(-1, 2)
        vals = arr(mat.data).reshape(-1)
        # BCOO pads with out-of-range coordinates (and zero data)
        keep = (idx[:, 0] < shape[0]) & (idx[:, 1] < shape[1])
        coo = torch.sparse_coo_tensor(
            torch.as_tensor(idx[keep].T.astype(np.int64), device=dev),
            torch.as_tensor(vals[keep], dtype=tdt, device=dev), shape,
            check_invariants=False)
        if mat.unique_indices:
            coo = coo.coalesce()  # unique: coalescing sums nothing
        return op_.SparseOp(coo)
    if kind == "CustomOp":
        raise NotImplementedError(
            "a CustomOp holds JAX functions; build it in the port with "
            "torch code (totsu_tpu_torch.CustomOp)")
    raise ValueError(f"no port of the operator {kind}")
