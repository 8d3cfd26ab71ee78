"""Linear operators (port of ``totsu_tpu.solver.operator`` for dense A).

The reference abstracts the constraint matrix behind a 4-method trait
(matvec, rmatvec, column and row absolute sums); :class:`LinOp` keeps that
contract plus the fused ``dual_matvec`` pair every HSDE application needs.
:class:`DenseOp` is the dense (m, n) operator; its ``dual_matvec`` is the
fused CUDA kernel on a CUDA tensor (the plain version on a CPU tensor).
The structured operators wait for ROADMAP §1 item 10.
"""

import dataclasses
from typing import Tuple

import numpy as np
import torch

from totsu_tpu_torch.ops.kernels.dual_matvec import dual_matvec


def target_device(device=None) -> torch.device:
    """Where data that is not a tensor yet goes: ``device`` when the
    caller names one, else the CUDA card. The port runs on the card unless
    asked for the CPU, so without a CUDA device this raises; it never
    falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: data that is not a tensor goes to the card "
            "unless device= names another one (e.g. device='cpu')")
    return torch.device("cuda")


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name (e.g. 'bfloat16')."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


class LinOp:
    """Abstract linear operator R^n -> R^m."""

    @property
    def shape(self) -> Tuple[int, int]:
        raise NotImplementedError

    def matvec(self, x):
        """A @ x."""
        raise NotImplementedError

    def rmatvec(self, y):
        """A.T @ y."""
        raise NotImplementedError

    def col_abssum(self):
        """(n,) vector of column absolute sums sum_i |A_ij|."""
        raise NotImplementedError

    def row_abssum(self):
        """(m,) vector of row absolute sums sum_j |A_ij|."""
        raise NotImplementedError

    def to_dense(self):
        """Materialize as a dense (m, n) matrix."""
        raise NotImplementedError

    def dual_matvec(self, u, v):
        """(A @ u, A^T @ v) — subclasses may fuse the two passes over A."""
        return self.matvec(u), self.rmatvec(v)

    def row_absmax(self):
        """(m,) vector of row absolute maxima max_j |A_ij| (Ruiz)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support row_absmax")

    def col_absmax(self):
        """(n,) vector of column absolute maxima max_i |A_ij| (Ruiz)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support col_absmax")

    def diag_scale(self, d, e):
        """diag(d) @ A @ diag(e) as an operator of the same structure."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support diag_scale")

    def astype(self, dtype):
        """This operator with its stored data cast to ``dtype``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support astype")

    def col_sqsum(self):
        """(n,) vector of column square sums sum_i A_ij^2."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support col_sqsum")


@dataclasses.dataclass(frozen=True)
class DenseOp(LinOp):
    """Dense (m, n) matrix operator (ref MatOp General, matop.rs:51-175)."""
    a: torch.Tensor

    @property
    def shape(self):
        return tuple(self.a.shape)

    def matvec(self, x):
        return self.a @ x

    def rmatvec(self, y):
        return y @ self.a

    def dual_matvec(self, u, v):
        return dual_matvec(self.a, u, v)

    def col_abssum(self):
        return self.a.abs().sum(dim=0)

    def row_abssum(self):
        return self.a.abs().sum(dim=1)

    def row_absmax(self):
        return self.a.abs().amax(dim=1)

    def col_absmax(self):
        return self.a.abs().amax(dim=0)

    def col_sqsum(self):
        return (self.a * self.a).sum(dim=0)

    def diag_scale(self, d, e):
        return type(self)(d[:, None] * self.a * e[None, :])

    def astype(self, dtype):
        return type(self)(self.a.to(as_dtype(dtype)).contiguous())

    def to_dense(self):
        return self.a


def as_linop(a, device=None) -> LinOp:
    """Coerce a tensor / array / LinOp to a LinOp. Tensors keep their
    device, which must be ``device`` when the caller names one; other data
    keeps its numpy dtype and goes to :func:`target_device` (``device``,
    else the CUDA card)."""
    if isinstance(a, LinOp):
        return a
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a)).to(target_device(device))
    elif device is not None:
        want = torch.device(device)
        if a.device.type != want.type or want.index not in (None,
                                                            a.device.index):
            raise ValueError(f"A is on {a.device}, not on device={want}")
    if a.dim() != 2:
        raise ValueError(f"expected 2-D array or LinOp, got shape "
                         f"{tuple(a.shape)}")
    return DenseOp(a)
