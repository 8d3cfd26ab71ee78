"""Linear operators (port of ``totsu_tpu.solver.operator``).

The reference abstracts the constraint matrix behind a 4-method trait
(matvec, rmatvec, column and row absolute sums); :class:`LinOp` keeps that
contract plus the fused ``dual_matvec`` pair every HSDE application needs.
:class:`DenseOp` is the dense (m, n) operator; its ``dual_matvec`` is the
fused CUDA kernel on a CUDA tensor (the plain version on a CPU tensor).
The structured compositions (``DiagOp``, ``ZeroOp``, ``VStackOp``,
``HStackOp``, ``BlockOp``, ``ScaledOp``), the matrix-free ``CustomOp`` and
the sparse ``SparseOp`` and ``BlockedEllOp`` compute in plain PyTorch:
their JAX counterparts hold no Pallas kernel.

Every operator lives on one device (``device``) and stores one dtype
(``dtype``; None for an operator with no data of its own). Data that is
not a tensor yet goes to the CUDA card unless ``device=`` names another
device; a stack's children must agree on both. Every product runs in full
f32 inside the solvers (:func:`full_f32_matmul`), the counterpart of the
JAX package's ``Precision.HIGHEST`` pins.
"""

import contextlib
import dataclasses
from typing import Any, Callable, List, Optional, Tuple

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


def _resolved(device) -> torch.device:
    """:func:`target_device` with the index a tensor there would carry
    (``cuda`` becomes ``cuda:0``), so devices compare equal."""
    return torch.empty(0, device=target_device(device)).device


def as_data(x, device=None, what: str = "data") -> torch.Tensor:
    """A tensor keeps its device, which must be ``device`` when the caller
    names one; other data keeps its numpy dtype and goes to
    :func:`target_device` (``device``, else the CUDA card)."""
    if not isinstance(x, torch.Tensor):
        return torch.from_numpy(np.array(x)).to(target_device(device))
    if device is not None:
        want = torch.device(device)
        if x.device.type != want.type or want.index not in (None,
                                                            x.device.index):
            raise ValueError(f"{what} is on {x.device}, not on "
                             f"device={want}")
    return x


@contextlib.contextmanager
def full_f32_matmul():
    """Full-f32 matrix products (no TF32) inside, whatever the caller set;
    the caller's setting is put back on the way out, also on a raise.
    The legacy ``allow_tf32`` flag is restored where the precision cannot
    be read (a caller that mixed the legacy and the new API)."""
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        precision = torch.get_float32_matmul_precision()
    except RuntimeError:
        precision = None
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if precision is not None:
            torch.set_float32_matmul_precision(precision)
        else:
            torch.backends.cuda.matmul.allow_tf32 = allow_tf32


class LinOp:
    """Abstract linear operator R^n -> R^m on ``device``, storing
    ``dtype`` (None: no data of its own)."""

    device: torch.device
    dtype: Optional[torch.dtype] = None

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
        """Materialize as a dense (m, n) matrix, column by column from
        ``matvec`` of the identity's columns (tests / small problems)."""
        n = self.shape[1]
        eye = torch.eye(n, dtype=self.dtype or torch.get_default_dtype(),
                        device=self.device)
        return torch.stack([self.matvec(eye[:, j]) for j in range(n)],
                           dim=1)

    def dual_matvec(self, u, v):
        """(A @ u, A^T @ v) — subclasses may fuse the two passes over A."""
        return self.matvec(u), self.rmatvec(v)

    # -- optional structure-preserving transforms: what lets Ruiz
    # equilibration, mixed precision and the indirect engine's Jacobi
    # preconditioner compose with every operator that has stored data

    def row_absmax(self):
        """(m,) vector of row absolute maxima max_j |A_ij| (Ruiz)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support row_absmax "
            "(needed by ruiz_equilibrate_op / equil_iters)")

    def col_absmax(self):
        """(n,) vector of column absolute maxima max_i |A_ij| (Ruiz)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support col_absmax "
            "(needed by ruiz_equilibrate_op / equil_iters)")

    def diag_scale(self, d, e):
        """diag(d) @ A @ diag(e) as an operator of the same structure."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support diag_scale "
            "(needed by ruiz_equilibrate_op / equil_iters)")

    def astype(self, dtype):
        """This operator with its stored data cast to ``dtype``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support astype "
            "(needed by SolverParam.matvec_dtype)")

    def col_sqsum(self):
        """(n,) vector of column square sums sum_i A_ij^2: the diagonal of
        A^T A, the indirect engine's Jacobi preconditioner."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support col_sqsum "
            "(needed by the indirect engine's cg_precond='jacobi')")


def _set(obj, **fields):
    """Set fields of a frozen dataclass from its ``__post_init__``."""
    for name, value in fields.items():
        object.__setattr__(obj, name, value)


@dataclasses.dataclass(frozen=True)
class DenseOp(LinOp):
    """Dense (m, n) matrix operator (ref MatOp General, matop.rs:51-175)."""
    a: torch.Tensor
    device: Any = None

    def __post_init__(self):
        a = as_data(self.a, self.device, "A")
        _set(self, a=a, device=a.device)

    @property
    def dtype(self):
        return self.a.dtype

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


@dataclasses.dataclass(frozen=True)
class BatchedDenseOp(LinOp):
    """B dense (m, n) operators, one per lane of a lockstep batch: ``a`` is
    (B, m, n), vectors are (B, n) and (B, m), and every method works lane
    by lane. ``shape`` is one lane's (m, n), ``batch`` is B.

    The pair {A u, A^T v} is two ``torch.bmm`` calls, in full f32 inside
    the solvers (:func:`full_f32_matmul`): the JAX package leaves its
    vmapped pair to XLA, not to its Pallas kernel. An A expanded from one
    (m, n) matrix (batch stride 0) is kept as it is, with no copy."""
    a: torch.Tensor
    device: Any = None

    def __post_init__(self):
        a = as_data(self.a, self.device, "A")
        if a.dim() != 3:
            raise ValueError(f"BatchedDenseOp: A must be (B, m, n), got "
                             f"{tuple(a.shape)}")
        _set(self, a=a, device=a.device)

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def shape(self):
        return tuple(self.a.shape[1:])

    @property
    def batch(self) -> int:
        return self.a.shape[0]

    def lane(self, i: int) -> DenseOp:
        """Lane ``i`` as a :class:`DenseOp` (a view)."""
        return DenseOp(self.a[i])

    def _widened(self, x):
        """A in the vectors' dtype: a low-precision copy (``astype``, for
        ``matvec_dtype``) is widened on the fly, as jnp promotes it."""
        return self.a if self.a.dtype == x.dtype else self.a.to(x.dtype)

    def matvec(self, x):
        return torch.bmm(self._widened(x), x.unsqueeze(-1)).squeeze(-1)

    def rmatvec(self, y):
        return torch.bmm(y.unsqueeze(1), self._widened(y)).squeeze(1)

    def col_abssum(self):
        return self.a.abs().sum(dim=1)

    def row_abssum(self):
        return self.a.abs().sum(dim=2)

    def row_absmax(self):
        return self.a.abs().amax(dim=2)

    def col_absmax(self):
        return self.a.abs().amax(dim=1)

    def col_sqsum(self):
        return (self.a * self.a).sum(dim=1)

    def diag_scale(self, d, e):
        return type(self)(d[:, :, None] * self.a * e[:, None, :])

    def astype(self, dtype):
        return type(self)(self.a.to(as_dtype(dtype)))

    def to_dense(self):
        return self.a


@dataclasses.dataclass(frozen=True)
class DiagOp(LinOp):
    """diag(d) operator — e.g. diagonal-P QPs (ref benchmark_qp's shape)."""
    d: torch.Tensor
    device: Any = None

    def __post_init__(self):
        d = as_data(self.d, self.device, "d")
        _set(self, d=d, device=d.device)

    @property
    def dtype(self):
        return self.d.dtype

    @property
    def shape(self):
        return (self.d.shape[0], self.d.shape[0])

    def matvec(self, x):
        return self.d * x

    def rmatvec(self, y):
        return self.d * y

    def col_abssum(self):
        return self.d.abs()

    def row_abssum(self):
        return self.d.abs()

    def row_absmax(self):
        return self.d.abs()

    def col_absmax(self):
        return self.d.abs()

    def col_sqsum(self):
        return self.d * self.d

    def diag_scale(self, d, e):
        return DiagOp(d * self.d * e)

    def astype(self, dtype):
        return DiagOp(self.d.to(as_dtype(dtype)))

    def to_dense(self):
        return torch.diag(self.d)


@dataclasses.dataclass(frozen=True)
class ZeroOp(LinOp):
    """The (m, n) zero operator (degenerate blocks, e.g. empty A in tests).
    It stores nothing: ``dtype`` None until ``astype`` gives it one, and
    its reductions come in that dtype (else torch's default, which a sum
    or concatenation with a sibling's promotes)."""
    m: int
    n: int
    device: Any = None
    dtype: Any = None

    def __post_init__(self):
        _set(self, device=_resolved(self.device),
             dtype=None if self.dtype is None else as_dtype(self.dtype))

    @property
    def shape(self):
        return (self.m, self.n)

    def _zeros(self, k):
        return torch.zeros(k, dtype=self.dtype or torch.get_default_dtype(),
                           device=self.device)

    def matvec(self, x):
        return torch.zeros(self.m, dtype=x.dtype, device=x.device)

    def rmatvec(self, y):
        return torch.zeros(self.n, dtype=y.dtype, device=y.device)

    def col_abssum(self):
        return self._zeros(self.n)

    def row_abssum(self):
        return self._zeros(self.m)

    def row_absmax(self):
        return self._zeros(self.m)

    def col_absmax(self):
        return self._zeros(self.n)

    def col_sqsum(self):
        return self._zeros(self.n)

    def diag_scale(self, d, e):
        return self

    def astype(self, dtype):
        return dataclasses.replace(self, dtype=as_dtype(dtype))

    def to_dense(self):
        return torch.zeros(self.m, self.n,
                           dtype=self.dtype or torch.get_default_dtype(),
                           device=self.device)


def _stack(ops, shape_axis: int):
    """The children of a stack as a tuple, checked to share one device,
    one dtype (children without data, ZeroOps, have none) and the
    stacked axis's width; returns (ops, device, dtype)."""
    ops = tuple(ops)
    if not ops:
        raise ValueError("a stack needs at least one operator")
    devices = {o.device for o in ops}
    if len(devices) > 1:
        raise ValueError(f"a stack's operators must share a device, got "
                         f"{sorted(str(d) for d in devices)}")
    dtypes = {o.dtype for o in ops} - {None}
    if len(dtypes) > 1:
        raise ValueError(f"a stack's operators must share a dtype, got "
                         f"{sorted(str(d) for d in dtypes)}")
    widths = {o.shape[shape_axis] for o in ops}
    if len(widths) > 1:
        raise ValueError(f"a stack's operators must agree on axis "
                         f"{shape_axis}, got sizes {sorted(widths)}")
    return ops, devices.pop(), dtypes.pop() if dtypes else None


def _sum(parts):
    out = None
    for t in parts:
        out = t if out is None else out + t
    return out


def _max(parts):
    out = None
    for t in parts:
        out = t if out is None else torch.maximum(out, t)
    return out


@dataclasses.dataclass(frozen=True)
class VStackOp(LinOp):
    """Row-stacked [A0; A1; ...]: matvec concatenates, rmatvec sums."""
    ops: Tuple[LinOp, ...]
    device: Any = dataclasses.field(default=None, init=False)
    dtype: Any = dataclasses.field(default=None, init=False)

    def __post_init__(self):
        ops, device, dtype = _stack(self.ops, 1)
        _set(self, ops=ops, device=device, dtype=dtype)

    @property
    def shape(self):
        return (sum(o.shape[0] for o in self.ops), self.ops[0].shape[1])

    def _rows(self, y):
        off = 0
        for o in self.ops:
            yield o, y[off:off + o.shape[0]]
            off += o.shape[0]

    def matvec(self, x):
        return torch.cat([o.matvec(x) for o in self.ops])

    def rmatvec(self, y):
        return _sum(o.rmatvec(yo) for o, yo in self._rows(y))

    def col_abssum(self):
        return _sum(o.col_abssum() for o in self.ops)

    def row_abssum(self):
        return torch.cat([o.row_abssum() for o in self.ops])

    def row_absmax(self):
        return torch.cat([o.row_absmax() for o in self.ops])

    def col_absmax(self):
        return _max(o.col_absmax() for o in self.ops)

    def col_sqsum(self):
        return _sum(o.col_sqsum() for o in self.ops)

    def diag_scale(self, d, e):
        return VStackOp(tuple(o.diag_scale(do, e) for o, do in self._rows(d)))

    def astype(self, dtype):
        return VStackOp(tuple(o.astype(dtype) for o in self.ops))


@dataclasses.dataclass(frozen=True)
class HStackOp(LinOp):
    """Column-stacked [A0, A1, ...]: matvec sums, rmatvec concatenates."""
    ops: Tuple[LinOp, ...]
    device: Any = dataclasses.field(default=None, init=False)
    dtype: Any = dataclasses.field(default=None, init=False)

    def __post_init__(self):
        ops, device, dtype = _stack(self.ops, 0)
        _set(self, ops=ops, device=device, dtype=dtype)

    @property
    def shape(self):
        return (self.ops[0].shape[0], sum(o.shape[1] for o in self.ops))

    def _cols(self, x):
        off = 0
        for o in self.ops:
            yield o, x[off:off + o.shape[1]]
            off += o.shape[1]

    def matvec(self, x):
        return _sum(o.matvec(xo) for o, xo in self._cols(x))

    def rmatvec(self, y):
        return torch.cat([o.rmatvec(y) for o in self.ops])

    def col_abssum(self):
        return torch.cat([o.col_abssum() for o in self.ops])

    def row_abssum(self):
        return _sum(o.row_abssum() for o in self.ops)

    def col_absmax(self):
        return torch.cat([o.col_absmax() for o in self.ops])

    def col_sqsum(self):
        return torch.cat([o.col_sqsum() for o in self.ops])

    def row_absmax(self):
        return _max(o.row_absmax() for o in self.ops)

    def diag_scale(self, d, e):
        return HStackOp(tuple(o.diag_scale(d, eo) for o, eo in self._cols(e)))

    def astype(self, dtype):
        return HStackOp(tuple(o.astype(dtype) for o in self.ops))


def BlockOp(rows):
    """Block matrix from a grid of operators: VStack of HStacks."""
    return VStackOp(tuple(
        HStackOp(tuple(row)) if len(row) > 1 else row[0] for row in rows
    ))


@dataclasses.dataclass(frozen=True)
class ScaledOp(LinOp):
    """alpha * A with a scalar alpha (a number or a 0-d tensor on A's
    device)."""
    alpha: Any
    op: LinOp
    device: Any = dataclasses.field(default=None, init=False)

    def __post_init__(self):
        if isinstance(self.alpha, torch.Tensor):
            as_data(self.alpha, self.op.device, "alpha")
        _set(self, device=self.op.device)

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def shape(self):
        return self.op.shape

    def matvec(self, x):
        return self.alpha * self.op.matvec(x)

    def rmatvec(self, y):
        return self.alpha * self.op.rmatvec(y)

    def col_abssum(self):
        return abs(self.alpha) * self.op.col_abssum()

    def row_abssum(self):
        return abs(self.alpha) * self.op.row_abssum()

    def row_absmax(self):
        return abs(self.alpha) * self.op.row_absmax()

    def col_absmax(self):
        return abs(self.alpha) * self.op.col_absmax()

    def col_sqsum(self):
        return self.alpha * self.alpha * self.op.col_sqsum()

    def diag_scale(self, d, e):
        return ScaledOp(self.alpha, self.op.diag_scale(d, e))

    def astype(self, dtype):
        return ScaledOp(self.alpha, self.op.astype(dtype))


def _first_tensor(tree):
    """The first tensor in nested tuples / lists / dicts, or None."""
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for item in tree:
            found = _first_tensor(item)
            if found is not None:
                return found
    return None


@dataclasses.dataclass(frozen=True)
class CustomOp(LinOp):
    """Matrix-free operator from user functions.

    ``matvec_fn(params, x)`` (torch code) is required. The adjoint
    defaults to autograd: the vector-Jacobian product of
    ``matvec_fn(params, .)`` at zero, the counterpart of
    ``jax.linear_transpose``. Absolute row/col sums default to
    materializing the operator — supply hand-derived functions for large
    matrix-free problems (the reference does exactly that for its
    Laplacian stencil, laplacian.rs:52-109). ``device`` and ``dtype`` come
    from the first tensor in ``params`` unless given.
    """
    params: Any
    m: int
    n: int
    matvec_fn: Callable
    rmatvec_fn: Optional[Callable] = None
    col_abssum_fn: Optional[Callable] = None
    row_abssum_fn: Optional[Callable] = None
    device: Any = None
    dtype: Any = None

    def __post_init__(self):
        t = _first_tensor(self.params)
        if t is not None:
            device = as_data(t, self.device, "params").device
        else:
            device = _resolved(self.device)
        if self.dtype is not None:
            dtype = as_dtype(self.dtype)
        else:
            dtype = t.dtype if t is not None and t.is_floating_point() \
                else None
        _set(self, device=device, dtype=dtype)

    @property
    def shape(self):
        return (self.m, self.n)

    def matvec(self, x):
        return self.matvec_fn(self.params, x)

    def rmatvec(self, y):
        if self.rmatvec_fn is not None:
            return self.rmatvec_fn(self.params, y)
        x = torch.zeros(self.n, dtype=y.dtype, device=y.device,
                        requires_grad=True)
        with torch.enable_grad():
            out = self.matvec_fn(self.params, x)
            if not out.requires_grad:       # a map that ignores x
                return torch.zeros(self.n, dtype=y.dtype, device=y.device)
            (g,) = torch.autograd.grad(out, x, grad_outputs=y,
                                       allow_unused=True)
        if g is None:
            return torch.zeros(self.n, dtype=y.dtype, device=y.device)
        return g.detach()

    def col_abssum(self):
        if self.col_abssum_fn is not None:
            return self.col_abssum_fn(self.params)
        return self.to_dense().abs().sum(dim=0)

    def row_abssum(self):
        if self.row_abssum_fn is not None:
            return self.row_abssum_fn(self.params)
        return self.to_dense().abs().sum(dim=1)


def _csr(indices, values, shape):
    """The CSR form of a coordinate list (duplicates summed)."""
    coo = torch.sparse_coo_tensor(indices, values, shape,
                                  check_invariants=False)
    return coo.to_sparse_csr()


def _spmv(csr, x):
    """csr @ x, the stored values widened to x's dtype per call (a bf16
    operator in an f32 loop)."""
    if csr.dtype != x.dtype:
        csr = csr.to(x.dtype)
    return torch.mv(csr, x)


@dataclasses.dataclass(frozen=True)
class SparseOp(LinOp):
    """Sparse (m, n) operator on a torch sparse COO tensor (the port of the
    JAX package's BCOO operator).

    ``mat`` keeps its coordinate list as given: a coalesced tensor has
    unique, sorted coordinates (BCOO's ``unique_indices`` and
    ``indices_sorted``); an uncoalesced one may repeat a coordinate, whose
    entries then add up. Both products are non-transposed CSR SpMVs, of A
    and of a prebuilt A^T; the reductions run on the coordinate list.
    """
    mat: torch.Tensor
    device: Any = dataclasses.field(default=None, init=False)
    csr: Any = dataclasses.field(default=None, init=False, repr=False,
                                 compare=False)
    csr_t: Any = dataclasses.field(default=None, init=False, repr=False,
                                   compare=False)

    def __post_init__(self):
        if not (isinstance(self.mat, torch.Tensor)
                and self.mat.layout == torch.sparse_coo):
            raise TypeError("SparseOp wraps a torch sparse COO tensor "
                            "(build one with SparseOp.from_dense)")
        idx, vals = self.mat._indices(), self.mat._values()
        m, n = self.mat.shape
        _set(self, device=self.mat.device, csr=_csr(idx, vals, (m, n)),
             csr_t=_csr(idx.flip(0), vals, (n, m)))

    @classmethod
    def from_dense(cls, a, device=None):
        """The nonzeros of a dense matrix (coalesced): ``a`` as a tensor
        keeps its device, other data goes to ``device`` (else the card)."""
        return cls(as_data(a, device, "A").to_sparse())

    @property
    def dtype(self):
        return self.mat.dtype

    @property
    def shape(self):
        return tuple(self.mat.shape)

    def matvec(self, x):
        return _spmv(self.csr, x)

    def rmatvec(self, y):
        return _spmv(self.csr_t, y)

    def _with(self, values):
        # keep the coordinate list and its coalesced flag: a scaled or cast
        # operator keeps the duplicate guard's answer
        return SparseOp(torch.sparse_coo_tensor(
            self.mat._indices(), values, self.mat.shape,
            is_coalesced=self.mat.is_coalesced(), check_invariants=False))

    def _segment_sum(self, axis, values):
        """Sum of ``values`` over the coordinates that share row (axis 0)
        or column (axis 1), through a CSR SpMV (fixed order)."""
        idx = self.mat._indices()
        k = self.shape[axis]
        other = self.shape[1 - axis]
        csr = _csr(idx if axis == 0 else idx.flip(0), values, (k, other))
        return torch.mv(csr, torch.ones(other, dtype=values.dtype,
                                        device=values.device))

    def _segment_max(self, axis, values):
        out = torch.zeros(self.shape[axis], dtype=values.dtype,
                          device=values.device)
        return out.scatter_reduce(0, self.mat._indices()[axis], values,
                                  reduce="amax", include_self=True)

    def col_abssum(self):
        return self._segment_sum(1, self.mat._values().abs())

    def row_abssum(self):
        return self._segment_sum(0, self.mat._values().abs())

    def row_absmax(self):
        return self._segment_max(0, self.mat._values().abs())

    def col_absmax(self):
        return self._segment_max(1, self.mat._values().abs())

    def col_sqsum(self):
        if not self.mat.is_coalesced():
            # summing squares of duplicate coordinates misstates
            # diag(A^T A) ((a+b)^2 != a^2 + b^2) and would feed the
            # Jacobi PCG a wrong preconditioner. (Under duplicates the
            # absolute sums above still bound the summed entries,
            # |a+b| <= |a| + |b|; the maxima take the larger of |a|, |b|,
            # which is no bound. The JAX package computes the same and
            # its comment calls both safe)
            raise NotImplementedError(
                "SparseOp.col_sqsum requires unique indices — coalesce() "
                "the tensor before wrapping, or construct via "
                "SparseOp.from_dense")
        vals = self.mat._values()
        return self._segment_sum(1, vals * vals)

    def diag_scale(self, d, e):
        rows, cols = self.mat._indices()
        return self._with(self.mat._values() * d[rows] * e[cols])

    def astype(self, dtype):
        return self._with(self.mat._values().to(as_dtype(dtype)))

    def to_dense(self):
        return self.mat.to_dense()


def _pad_to(v, size):
    """``v`` zero-padded at the end to ``size`` entries."""
    if v.shape[0] == size:
        return v
    return torch.nn.functional.pad(v, (0, size - v.shape[0]))


@dataclasses.dataclass(frozen=True)
class BlockedEllOp(LinOp):
    """Blocked-ELL sparse operator: the structured-sparse large-problem
    path.

    A is partitioned into a grid of (bm x bn) tiles; only nonzero tiles
    are stored, padded to a fixed K tiles per tile-row (ELL layout). Each
    product is one gather of input tiles and one batched matmul, with no
    scatter: the transpose structure is prebuilt (2x tile memory). It pays
    when the *tile-level* density is low (block-banded, stencil, arrow,
    multi-stage structures); uniformly random scalar sparsity does not
    tile.

    Fields (the JAX package's, its slot order and indices exactly; the
    tiles in a layout that makes each product one ``bmm`` with no copy):
      * blocks   (nbr, bm, K, bn)  — row i of slot k of tile-row r at
        ``blocks[r, i, k]``, zero-padded slots (JAX: (nbr, K, bm, bn))
      * cols     (nbr, K) int32    — tile-column index per slot
      * blocks_t (nbc, bn, Kt, bm) — tiles of A^T, same layout
      * cols_t   (nbc, Kt) int32
    :meth:`from_slots` takes the JAX layout.
    """
    blocks: torch.Tensor
    cols: torch.Tensor
    blocks_t: torch.Tensor
    cols_t: torch.Tensor
    m: int
    n: int
    bm: int
    bn: int
    device: Any = None

    def __post_init__(self):
        fields = {name: as_data(getattr(self, name), self.device, name)
                  for name in ("blocks", "cols", "blocks_t", "cols_t")}
        devices = {t.device for t in fields.values()}
        if len(devices) > 1:
            raise ValueError("BlockedEllOp's arrays must share a device, "
                             f"got {sorted(str(d) for d in devices)}")
        _set(self, device=devices.pop(), **fields)

    @classmethod
    def from_slots(cls, blocks, cols, blocks_t, cols_t, m, n, bm, bn,
                   device=None):
        """From the JAX package's layout (numpy or tensors): ``blocks``
        (nbr, K, bm, bn) and ``blocks_t`` (nbc, Kt, bn, bm), one transfer
        each to ``device`` (else the card) after the host transpose."""
        def port(t):
            return np.ascontiguousarray(np.asarray(t).transpose(0, 2, 1, 3))

        return cls(port(blocks), np.asarray(cols, np.int32), port(blocks_t),
                   np.asarray(cols_t, np.int32), m=m, n=n, bm=bm, bn=bn,
                   device=device)

    @classmethod
    def from_dense(cls, a, block=(128, 128), device=None):
        """Tile a dense matrix, keeping only nonzero tiles (host-side). A
        tensor ``a`` keeps its device; other data goes to ``device``."""
        if isinstance(a, torch.Tensor):
            device = as_data(a, device, "A").device
            a = a.detach().cpu().numpy()
        a = np.asarray(a)
        m, n = a.shape
        bm, bn = block
        mp = -(-m // bm) * bm
        np_ = -(-n // bn) * bn
        ap = np.zeros((mp, np_), dtype=a.dtype)
        ap[:m, :n] = a

        def build(mat, r, c):
            nbr, nbc = mat.shape[0] // r, mat.shape[1] // c
            tiles = mat.reshape(nbr, r, nbc, c).transpose(0, 2, 1, 3)
            nz = np.abs(tiles).sum(axis=(2, 3)) > 0        # (nbr, nbc)
            k = max(1, int(nz.sum(axis=1).max()))
            blocks = np.zeros((nbr, k, r, c), dtype=mat.dtype)
            colsk = np.zeros((nbr, k), dtype=np.int32)
            for i in range(nbr):
                js = np.nonzero(nz[i])[0]
                blocks[i, :len(js)] = tiles[i, js]
                colsk[i, :len(js)] = js
            return blocks, colsk

        blocks, cols = build(ap, bm, bn)
        blocks_t, cols_t = build(ap.T, bn, bm)
        return cls.from_slots(blocks, cols, blocks_t, cols_t, m=m, n=n,
                              bm=bm, bn=bn, device=device)

    @classmethod
    def from_tiles(cls, tiles, m, n, block=(128, 128), device=None):
        """Build from a sparse tile dict without materializing the dense
        matrix (a 65,536^2 banded operator is 16 GB dense but ~100 MB of
        tiles).

        ``tiles``: mapping ``(tile_row, tile_col) -> (bm, bn) array``
        (numpy or array-like; partial edge tiles are zero-padded).
        Duplicate coordinates are summed (BSR semantics). The transpose
        layout is built directly from the tile coordinates — each (i, j)
        tile contributes its transpose at (j, i).
        """
        bm, bn = block
        nbr = -(-m // bm)
        nbc = -(-n // bn)
        fwd = {}                     # tile_row -> {tile_col: array}
        for (i, j), t in tiles.items():
            if not (0 <= i < nbr and 0 <= j < nbc):
                raise ValueError(
                    f"tile ({i}, {j}) outside the {nbr} x {nbc} grid of "
                    f"a {m} x {n} matrix with block {block}")
            t = np.asarray(t)
            if t.shape != (bm, bn):
                raise ValueError(
                    f"tile ({i}, {j}) has shape {t.shape}, expected "
                    f"{(bm, bn)} (zero-pad partial edge tiles)")
            row = fwd.setdefault(i, {})
            row[j] = row[j] + t if j in row else t
        # dtype from the converted arrays (raw dict values may be
        # array-likes without a .dtype — lists, tuples)
        dtype = (next(iter(next(iter(fwd.values())).values())).dtype
                 if fwd else np.float32)

        def pack(grid, nrows, r, c):
            k = max(1, max((len(v) for v in grid.values()), default=1))
            blocks = np.zeros((nrows, k, r, c), dtype=dtype)
            colsk = np.zeros((nrows, k), dtype=np.int32)
            for i, row in grid.items():
                for s, j in enumerate(sorted(row)):
                    blocks[i, s] = row[j]
                    colsk[i, s] = j
            return blocks, colsk

        blocks, cols = pack(fwd, nbr, bm, bn)
        bwd = {}
        for i, row in fwd.items():
            for j, t in row.items():
                bwd.setdefault(j, {})[i] = t.T
        blocks_t, cols_t = pack(bwd, nbc, bn, bm)
        return cls.from_slots(blocks, cols, blocks_t, cols_t, m=m, n=n,
                              bm=bm, bn=bn, device=device)

    @classmethod
    def from_bsr(cls, mat, block=None, device=None):
        """Build from a ``scipy.sparse`` matrix (converted to BSR with
        ``block`` = (bm, bn), default 128 x 128) without densifying.
        scipy's BSR requires the block size to divide the shape; pad the
        matrix (or use :meth:`from_tiles`) otherwise."""
        from scipy import sparse
        bm, bn = block if block is not None else (128, 128)
        m, n = mat.shape
        if m % bm or n % bn:
            raise ValueError(
                f"from_bsr needs block {(bm, bn)} to divide the shape "
                f"{(m, n)} (scipy BSR limitation); pad the matrix or "
                "build with from_tiles")
        if sparse.issparse(mat) and mat.format == "bsr" \
                and mat.blocksize == (bm, bn):
            # never mutate the caller's matrix (sort_indices() reorders
            # indices/data in place)
            bsr = mat if mat.has_sorted_indices else mat.sorted_indices()
        else:
            bsr = sparse.bsr_matrix(mat, blocksize=(bm, bn))
            bsr.sort_indices()
        tiles = {}
        indptr, indices, data = bsr.indptr, bsr.indices, bsr.data
        for i in range(len(indptr) - 1):
            for p in range(indptr[i], indptr[i + 1]):
                t = np.asarray(data[p])
                if np.any(t):
                    tiles[(i, int(indices[p]))] = t
        return cls.from_tiles(tiles, m=m, n=n, block=(bm, bn),
                              device=device)

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def shape(self):
        return (self.m, self.n)

    @property
    def tile_density(self):
        """Stored slots per tile-row / tile-grid width (K / nbc) — the
        fraction of the dense tile grid this layout actually computes."""
        return self.cols.shape[1] / self.blocks_t.shape[0]

    @staticmethod
    def _product(blocks, cols, xp, width):
        """One direction on the padded input ``xp``: gather its tiles by
        ``cols``, one ``bmm`` of the (rows, K*width) tile rows with them.
        Tiles stored in another dtype than xp (bf16 under matvec_dtype)
        are widened per call."""
        nr, r, k, _ = blocks.shape
        if blocks.dtype != xp.dtype:
            blocks = blocks.to(xp.dtype)
        gathered = xp.reshape(-1, width).index_select(0, cols.view(-1))
        y = torch.bmm(blocks.view(nr, r, k * width),
                      gathered.view(nr, k * width, 1))
        return y.view(-1)

    def matvec(self, x):
        return self._product(self.blocks, self.cols,
                             _pad_to(x, self.blocks_t.shape[0] * self.bn),
                             self.bn)[:self.m]

    def rmatvec(self, y):
        return self._product(self.blocks_t, self.cols_t,
                             _pad_to(y, self.blocks.shape[0] * self.bm),
                             self.bm)[:self.n]

    def col_abssum(self):
        # col sums of |A| = row sums of |A^T|: local per-tile reduction
        return self.blocks_t.abs().sum(dim=(2, 3)).reshape(-1)[:self.n]

    def row_abssum(self):
        return self.blocks.abs().sum(dim=(2, 3)).reshape(-1)[:self.m]

    def row_absmax(self):
        return self.blocks.abs().amax(dim=(2, 3)).reshape(-1)[:self.m]

    def col_absmax(self):
        return self.blocks_t.abs().amax(dim=(2, 3)).reshape(-1)[:self.n]

    def col_sqsum(self):
        # col square sums of A = row square sums of A^T: per-tile local
        sq = self.blocks_t * self.blocks_t
        return sq.sum(dim=(2, 3)).reshape(-1)[:self.n]

    def diag_scale(self, d, e):
        """diag(d) A diag(e) tile-locally: row scales broadcast down each
        tile-row, col scales are gathered with the same ``cols`` indices the
        matvec uses (padding rows/cols get scale 0 — they are zero anyway).
        This is what lets Ruiz equilibration compose with the blocked-ELL
        path."""
        nbr, nbc = self.blocks.shape[0], self.blocks_t.shape[0]
        dt = _pad_to(d, nbr * self.bm).view(nbr, self.bm)
        et = _pad_to(e, nbc * self.bn).view(nbc, self.bn)

        def gather(t, cols):
            return t.index_select(0, cols.view(-1)).view(
                cols.shape[0], 1, cols.shape[1], t.shape[1])

        blocks = self.blocks * dt[:, :, None, None] * gather(et, self.cols)
        blocks_t = self.blocks_t * et[:, :, None, None] \
            * gather(dt, self.cols_t)
        return dataclasses.replace(self, blocks=blocks, blocks_t=blocks_t)

    def astype(self, dtype):
        """Tile storage in ``dtype`` (bf16: the update products stream half
        the bytes and widen per call, SolverParam.matvec_dtype)."""
        dtype = as_dtype(dtype)
        return dataclasses.replace(self, blocks=self.blocks.to(dtype),
                                   blocks_t=self.blocks_t.to(dtype))

    def to_dense(self):
        nbr, bm, k, bn = self.blocks.shape
        nbc = self.blocks_t.shape[0]
        d = torch.zeros(nbr, nbc, bm, bn, dtype=self.dtype,
                        device=self.device)
        rows = torch.arange(nbr, device=self.device)[:, None].expand(nbr, k)
        d.index_put_((rows, self.cols.long()),
                     self.blocks.permute(0, 2, 1, 3), accumulate=True)
        d = d.permute(0, 2, 1, 3).reshape(nbr * bm, nbc * bn)
        return d[:self.m, :self.n]


def _flatten(obj, every: bool = False
             ) -> Tuple[List[torch.Tensor], Callable]:
    """The floating (strided) tensors inside ``obj`` (a tensor, a LinOp
    dataclass, tuples, lists and dicts of them; ``every``: every strided
    tensor, integer indices too) and a function that rebuilds ``obj``
    with other tensors in their places."""
    if isinstance(obj, torch.Tensor):
        if obj.layout == torch.strided and (every
                                            or obj.is_floating_point()):
            return [obj], lambda ls: ls[0]
        return [], lambda ls: obj
    if isinstance(obj, LinOp) and dataclasses.is_dataclass(obj):
        names = [f.name for f in dataclasses.fields(obj) if f.init]
        inner, rebuild = _flatten([getattr(obj, k) for k in names], every)
        if not inner:
            return [], lambda ls: obj
        return inner, lambda ls: dataclasses.replace(
            obj, **dict(zip(names, rebuild(ls))))
    if isinstance(obj, dict):
        keys = list(obj)
        inner, rebuild = _flatten([obj[k] for k in keys], every)
        return inner, lambda ls: dict(zip(keys, rebuild(ls)))
    if isinstance(obj, (tuple, list)):
        parts = [_flatten(item, every) for item in obj]
        sizes = [len(p[0]) for p in parts]
        leaves = [t for p in parts for t in p[0]]

        def rebuild(ls):
            out, off = [], 0
            for (_, rb), k in zip(parts, sizes):
                out.append(rb(ls[off:off + k]))
                off += k
            return type(obj)(out)

        return leaves, rebuild
    return [], lambda ls: obj


def _structure(obj, path: str):
    """``(path, what)`` for every part of ``obj`` that two lanes of a
    batch must share: each operator's class, each tensor's shape, dtype
    and layout, every other field's value (a function by identity, as
    JAX compares the static fields of a pytree)."""
    if isinstance(obj, torch.Tensor):
        return [(path, ("tensor", tuple(obj.shape), obj.dtype, obj.layout))]
    if isinstance(obj, LinOp) and dataclasses.is_dataclass(obj):
        out = [(path, ("class", type(obj)))]
        for f in dataclasses.fields(obj):
            if f.init and f.name != "device":
                out += _structure(getattr(obj, f.name), f"{path}.{f.name}")
        return out
    if isinstance(obj, dict):
        return [(path, ("keys", tuple(obj)))] + [
            p for k in obj for p in _structure(obj[k], f"{path}[{k!r}]")]
    if isinstance(obj, (tuple, list)):
        return [(path, ("len", len(obj)))] + [
            p for i, o in enumerate(obj)
            for p in _structure(o, f"{path}[{i}]")]
    return [(path, ("value", obj))]


def _same(a, b) -> bool:
    if a[0] == "value" and b[0] == "value" and (callable(a[1])
                                                or callable(b[1])):
        return a[1] is b[1]
    return a == b


def _tensor_scalars(op: LinOp) -> LinOp:
    """``op`` with every ``ScaledOp`` factor a 0-d tensor of its data's
    dtype on its device, so that the lanes' factors stack."""
    if isinstance(op, ScaledOp):
        alpha = op.alpha
        if not isinstance(alpha, torch.Tensor):
            alpha = torch.tensor(alpha, device=op.device,
                                 dtype=op.dtype or torch.get_default_dtype())
        return ScaledOp(alpha, _tensor_scalars(op.op))
    if isinstance(op, (VStackOp, HStackOp)):
        return type(op)(tuple(_tensor_scalars(o) for o in op.ops))
    return op


def _sparse_inside(op: LinOp) -> bool:
    if isinstance(op, SparseOp):
        return True
    if isinstance(op, (VStackOp, HStackOp)):
        return any(_sparse_inside(o) for o in op.ops)
    return isinstance(op, ScaledOp) and _sparse_inside(op.op)


def _vjp_adjoint(matvec_fn, n: int):
    """A ``CustomOp`` adjoint from ``torch.func.vjp`` of ``matvec_fn(params,
    .)`` at zero: the default adjoint (``torch.autograd.grad``) does not
    compose with ``torch.func.vmap``, this one does (the counterpart of a
    vmapped ``jax.linear_transpose``)."""
    def rmatvec(params, y):
        x = torch.zeros(n, dtype=y.dtype, device=y.device)
        _, pull = torch.func.vjp(lambda z: matvec_fn(params, z), x)
        return pull(y)[0]
    return rmatvec


def _vmappable(op: LinOp) -> LinOp:
    """``op`` as the batch's vmapped methods rebuild it: every ``CustomOp``
    without an adjoint of its own gets :func:`_vjp_adjoint`."""
    if isinstance(op, CustomOp) and op.rmatvec_fn is None:
        return dataclasses.replace(op, rmatvec_fn=_vjp_adjoint(op.matvec_fn,
                                                               op.n))
    if isinstance(op, ScaledOp):
        return ScaledOp(op.alpha, _vmappable(op.op))
    if isinstance(op, (VStackOp, HStackOp)):
        return type(op)(tuple(_vmappable(o) for o in op.ops))
    return op


def _widen(t, x):
    """Stored data in the vectors' dtype (a bf16 copy, ``matvec_dtype``,
    widens per call)."""
    return t if t.dtype == x.dtype else t.to(x.dtype)


def _explicit(op: LinOp, leaves: list):
    """``(matvec, rmatvec)`` of a batch in lane-leading form, written out:
    ``op`` is one lane's operator and ``leaves`` the batch's lane-leading
    tensors in :func:`_flatten` order (``every``), consumed from the
    front. None where a part has no such form (a ``CustomOp``). A
    blocked-ELL product is one gather and one ``bmm`` over the B nbr tile
    rows; a stack cuts and joins on the last axis. Each lane's products
    are its single operator's."""
    if isinstance(op, DiagOp):
        d = leaves.pop(0)
        return (lambda x: _widen(d, x) * x), (lambda y: _widen(d, y) * y)
    if isinstance(op, ZeroOp):
        return (lambda x: x.new_zeros(x.shape[0], op.m),
                lambda y: y.new_zeros(y.shape[0], op.n))
    if isinstance(op, DenseOp):
        a = leaves.pop(0)
        return (lambda x: torch.bmm(_widen(a, x), x[:, :, None])[:, :, 0],
                lambda y: torch.bmm(y[:, None, :], _widen(a, y))[:, 0, :])
    if isinstance(op, BlockedEllOp):
        blocks, cols, blocks_t, cols_t = leaves[:4]
        del leaves[:4]
        return (_ell_product(blocks, cols, blocks_t.shape[1], op.bn, op.m),
                _ell_product(blocks_t, cols_t, blocks.shape[1], op.bm, op.n))
    if isinstance(op, ScaledOp):
        alpha = op.alpha
        if isinstance(alpha, torch.Tensor):
            alpha = leaves.pop(0)[:, None]
        inner = _explicit(op.op, leaves)
        if inner is None:
            return None
        return (lambda x: alpha * inner[0](x), lambda y: alpha * inner[1](y))
    if isinstance(op, (VStackOp, HStackOp)):
        parts = [_explicit(o, leaves) for o in op.ops]
        if any(p is None for p in parts):
            return None
        axis = 0 if isinstance(op, VStackOp) else 1
        offs = np.cumsum([0] + [o.shape[axis] for o in op.ops]).tolist()

        def join(k):
            return lambda x: torch.cat([p[k](x) for p in parts], dim=-1)

        def cut(k):
            return lambda y: _sum(p[k](y[:, o0:o1]) for p, o0, o1
                                  in zip(parts, offs[:-1], offs[1:]))

        return (join(0), cut(1)) if axis == 0 else (cut(0), join(1))
    del leaves[:len(_flatten(op, every=True)[0])]
    return None


def _ell_product(blocks, cols, n_in: int, width: int, rows: int):
    """The lane-leading blocked-ELL product of ``BlockedEllOp._product``:
    ``blocks`` (B, nr, r, K, width), ``cols`` (B, nr, K), the input padded
    to ``n_in`` tiles of ``width``, the output cut to ``rows``. The
    gather's indices carry each lane's offset into the flat input."""
    lanes, nr, r, k, _ = blocks.shape
    idx = (cols.long() + n_in * torch.arange(
        lanes, device=cols.device)[:, None, None]).reshape(-1)

    def product(x):
        xp = torch.nn.functional.pad(x, (0, n_in * width - x.shape[1]))
        gathered = xp.reshape(-1, width).index_select(0, idx)
        y = torch.bmm(_widen(blocks, x).reshape(lanes * nr, r, k * width),
                      gathered.view(lanes * nr, k * width, 1))
        return y.view(lanes, -1)[:, :rows]

    return product


class BatchedOp(LinOp):
    """B structured operators of one structure, one per lane of a lockstep
    batch: the port of the JAX package's operator pytree whose leaves
    carry a leading lane axis. ``shape`` is one lane's (m, n), ``batch`` is
    B; every method takes lane-leading vectors, (B, n) and (B, m), and
    returns lane-leading results.

    ``BatchedOp(op, batch)`` wraps one operator whose tensors (floating
    and index) all carry the lane axis, e.g. a ``BlockedEllOp`` with
    ``blocks`` (B, nbr, bm, K, bn) and ``cols`` (B, nbr, K);
    :meth:`stack` stacks B operators (the counterpart of
    ``jax.tree_util.tree_map(jnp.stack, *ops)``; stacks of lanes go this
    way). Stacking ``DenseOp`` s gives a :class:`BatchedDenseOp`, stacking
    ``SparseOp`` s a :class:`BatchedSparseOp`.

    Each method is ``torch.func.vmap`` of the single operator's method
    over (the lanes' tensors, the vectors), as JAX vmaps it: the single
    classes and their arithmetic are those of one solve. A ``CustomOp``
    without an adjoint of its own takes :func:`_vjp_adjoint` here (the
    single solve keeps its autograd adjoint). The products of every
    operator but a ``CustomOp`` run in a lane-leading form written out
    (:func:`_explicit`), which skips vmap's costs on the host (about
    0.5 ms a call on the CPU); ``tests/test_torch_batched_op.py`` holds it
    against the vmapped one. A ``SparseOp`` inside a stack does not batch
    (``torch.func.vmap`` takes no sparse layout)."""

    def __init__(self, op: LinOp, batch: int):
        if isinstance(op, (BatchedOp, BatchedDenseOp)):
            raise ValueError("BatchedOp wraps one operator, not a batch")
        leaves, rebuild = _flatten(op, every=True)
        if not leaves:
            raise ValueError(
                f"{type(op).__name__} holds no strided tensor with a lane "
                "axis; batch such operators with BatchedOp.stack (a "
                "SparseOp's batch is the batched BCOO's counterpart)")
        bad = [tuple(t.shape) for t in leaves
               if t.dim() == 0 or t.shape[0] != batch]
        if bad:
            raise ValueError(f"BatchedOp: every tensor of the operator needs "
                             f"a leading lane axis of {batch}, got shapes "
                             f"{bad}")
        self._init(rebuild([t[0] for t in leaves]), leaves, batch)

    def _init(self, template: LinOp, leaves, batch: int):
        if _sparse_inside(template):
            raise ValueError(
                "a SparseOp inside a stack does not batch (torch.func.vmap "
                "takes no sparse layout); batch the SparseOp alone with "
                "BatchedOp.stack")
        self.template = template
        self.leaves = list(leaves)
        self._batch = batch
        self._lane = _flatten(template, every=True)[1]
        self._vlane = _flatten(_vmappable(template), every=True)[1]
        self._products = _explicit(template, list(leaves))

    @classmethod
    def _of(cls, template: LinOp, leaves, batch: int) -> "BatchedOp":
        out = cls.__new__(cls)
        out._init(template, leaves, batch)
        return out

    @staticmethod
    def stack(ops) -> LinOp:
        """B operators of one class and structure as one batch. Static
        fields (``m``, ``n``, ``bm``, ``bn``, a stack's arity, a
        ``CustomOp``'s functions, compared by identity) and the tensors'
        shapes must agree across the lanes, else ``ValueError`` names the
        field, as JAX's tree structure check refuses the stack."""
        ops = [_tensor_scalars(o) for o in ops]
        if not ops:
            raise ValueError("BatchedOp.stack needs at least one operator")
        ref = _structure(ops[0], type(ops[0]).__name__)
        for i, o in enumerate(ops[1:], 1):
            got = _structure(o, type(o).__name__)
            # the static fields first, then the tensors' shapes, as JAX
            # compares tree structures before leaves
            for tensors in (False, True):
                for (p0, w0), (p1, w1) in zip(ref, got):
                    if (w0[0] == "tensor") == tensors and (
                            p0 != p1 or not _same(w0, w1)):
                        raise ValueError(
                            f"BatchedOp.stack: lane {i}'s {p1} is "
                            f"{_what(w1)}, lane 0's {p0} {_what(w0)}")
            if len(got) != len(ref):
                raise ValueError(f"BatchedOp.stack: lane {i}'s structure "
                                 "differs from lane 0's")
        if isinstance(ops[0], DenseOp):
            return BatchedDenseOp(torch.stack([o.a for o in ops]))
        if isinstance(ops[0], SparseOp):
            return BatchedSparseOp(ops)
        leaves = [torch.stack(ts) for ts in
                  zip(*(_flatten(o, every=True)[0] for o in ops))]
        return BatchedOp._of(ops[0], leaves, len(ops))

    @property
    def device(self):
        return self.template.device

    @property
    def dtype(self):
        return self.template.dtype

    @property
    def shape(self):
        return self.template.shape

    @property
    def batch(self) -> int:
        return self._batch

    @staticmethod
    def shared(op: LinOp, lanes: int) -> LinOp:
        """One operator as every lane's: its tensors expanded to ``lanes``
        (views, no copy); a ``SparseOp`` repeated in the block diagonal."""
        if isinstance(op, DenseOp):
            return BatchedDenseOp(op.a.expand(lanes, *op.a.shape))
        if isinstance(op, SparseOp):
            return BatchedSparseOp([op] * lanes)
        leaves = _flatten(op, every=True)[0]
        return BatchedOp._of(op, [t.expand(lanes, *t.shape) for t in leaves],
                             lanes)

    def lane(self, i: int) -> LinOp:
        """Lane ``i`` as its single operator (views of the lane's
        tensors)."""
        return self.lane_of([t[i] for t in self.leaves])

    def lane_of(self, leaves) -> LinOp:
        """The single operator of one lane's tensors, in the order of
        ``leaves``."""
        return self._lane(list(leaves))

    def lanes(self, i0: int, i1: int) -> "BatchedOp":
        """Lanes ``[i0, i1)`` as a batch (views)."""
        return BatchedOp._of(self.template, [t[i0:i1] for t in self.leaves],
                             len(range(self._batch)[i0:i1]))

    def with_leaves(self, leaves) -> "BatchedOp":
        """This batch with other lane-leading tensors in the places of
        ``leaves`` (same order, shapes and dtypes)."""
        return BatchedOp._of(self.template, leaves, self._batch)

    def _map(self, fn, *vecs):
        """``fn(lane operator, *lane vectors)`` over the lanes."""
        rebuild = self._vlane
        return torch.func.vmap(lambda ls, *vs: fn(rebuild(ls), *vs))(
            self.leaves, *vecs)

    def matvec(self, x):
        if self._products is not None:
            return self._products[0](x)
        return self._map(lambda op, v: op.matvec(v), x)

    def rmatvec(self, y):
        if self._products is not None:
            return self._products[1](y)
        return self._map(lambda op, v: op.rmatvec(v), y)

    def dual_matvec(self, u, v):
        if self._products is not None:
            return self._products[0](u), self._products[1](v)
        return self._map(lambda op, a, b: (op.matvec(a), op.rmatvec(b)), u, v)

    def col_abssum(self):
        return self._map(lambda op: op.col_abssum())

    def row_abssum(self):
        return self._map(lambda op: op.row_abssum())

    def row_absmax(self):
        return self._map(lambda op: op.row_absmax())

    def col_absmax(self):
        return self._map(lambda op: op.col_absmax())

    def col_sqsum(self):
        return self._map(lambda op: op.col_sqsum())

    def diag_scale(self, d, e):
        """Each lane's diag(d_i) A_i diag(e_i), d (B, m) and e (B, n), as a
        batch of the same structure."""
        template = self.template.diag_scale(d[0], e[0])
        leaves = self._map(
            lambda op, di, ei: _flatten(op.diag_scale(di, ei), True)[0],
            d, e)
        return BatchedOp._of(template, leaves, self._batch)

    def astype(self, dtype):
        template = self.template.astype(dtype)
        new = _flatten(template, every=True)[0]
        return BatchedOp._of(template, [t.to(s.dtype) for t, s in
                                        zip(self.leaves, new)], self._batch)

    def to_dense(self):
        return torch.stack([self.lane(i).to_dense()
                            for i in range(self._batch)])


def _what(w) -> str:
    if w[0] == "class":
        return w[1].__name__
    if w[0] == "tensor":
        return f"a tensor of shape {w[1]} ({w[2]})"
    return repr(w[1])


class BatchedSparseOp(BatchedOp):
    """B ``SparseOp`` s as one block-diagonal sparse matrix of (B m) x (B n),
    each lane's coordinates offset by its lane: one SpMV serves every
    lane, and the segment reductions reshape to (B, m) and (B, n).
    ``torch.func.vmap`` takes no sparse layout, so this form is written
    out; the lanes' coordinate lists may differ in length. Its tensors
    are sparse: ``leaves`` is empty (no autograd input)."""

    def __init__(self, ops):
        ops = list(ops)
        m, n = ops[0].shape
        idx, vals = [], []
        for i, o in enumerate(ops):
            idx.append(o.mat._indices() + self._offset(i, m, n, o.device))
            vals.append(o.mat._values())
        big = torch.sparse_coo_tensor(
            torch.cat(idx, dim=1), torch.cat(vals),
            (len(ops) * m, len(ops) * n),
            is_coalesced=all(o.mat.is_coalesced() for o in ops),
            check_invariants=False)
        self._hold(SparseOp(big), (m, n), [t.shape[1] for t in idx])

    @staticmethod
    def _offset(i, m, n, device):
        return torch.tensor([[i * m], [i * n]], dtype=torch.int64,
                            device=device)

    def _hold(self, big: SparseOp, lane_shape, counts):
        self.big = big
        self.leaves = []
        self._shape = lane_shape
        self._batch = len(counts)
        self._counts = list(counts)

    @property
    def device(self):
        return self.big.device

    @property
    def dtype(self):
        return self.big.dtype

    @property
    def shape(self):
        return self._shape

    def _with(self, big: SparseOp) -> "BatchedSparseOp":
        out = BatchedSparseOp.__new__(BatchedSparseOp)
        out._hold(big, self._shape, self._counts)
        return out

    def with_leaves(self, leaves) -> "BatchedSparseOp":
        return self

    def lane(self, i: int) -> SparseOp:
        m, n = self._shape
        p0 = sum(self._counts[:i])
        p1 = p0 + self._counts[i]
        mat = self.big.mat
        return SparseOp(torch.sparse_coo_tensor(
            mat._indices()[:, p0:p1] - self._offset(i, m, n, self.device),
            mat._values()[p0:p1], (m, n), is_coalesced=mat.is_coalesced(),
            check_invariants=False))

    def lanes(self, i0: int, i1: int) -> "BatchedSparseOp":
        return BatchedSparseOp([self.lane(i)
                                for i in range(self._batch)[i0:i1]])

    def _rows(self, t):
        return t.view(self._batch, -1)

    def matvec(self, x):
        return self._rows(self.big.matvec(x.reshape(-1)))

    def rmatvec(self, y):
        return self._rows(self.big.rmatvec(y.reshape(-1)))

    def dual_matvec(self, u, v):
        return self.matvec(u), self.rmatvec(v)

    def col_abssum(self):
        return self._rows(self.big.col_abssum())

    def row_abssum(self):
        return self._rows(self.big.row_abssum())

    def row_absmax(self):
        return self._rows(self.big.row_absmax())

    def col_absmax(self):
        return self._rows(self.big.col_absmax())

    def col_sqsum(self):
        return self._rows(self.big.col_sqsum())

    def diag_scale(self, d, e):
        return self._with(self.big.diag_scale(d.reshape(-1), e.reshape(-1)))

    def astype(self, dtype):
        return self._with(self.big.astype(dtype))


def as_linop(a, device=None) -> LinOp:
    """Coerce a tensor / array / LinOp to a LinOp. Tensors keep their
    device, which must be ``device`` when the caller names one; other data
    keeps its numpy dtype and goes to :func:`target_device` (``device``,
    else the CUDA card)."""
    if isinstance(a, LinOp):
        return a
    a = as_data(a, device, "A")
    if a.dim() != 2:
        raise ValueError(f"expected 2-D array or LinOp, got shape "
                         f"{tuple(a.shape)}")
    return DenseOp(a)


def pin_dtype(a_op: LinOp, dtype: torch.dtype) -> LinOp:
    """``a_op`` with its data in the iterate ``dtype``: a dense A always
    (as in the JAX package), any other operator through ``astype`` too
    (the JAX package leaves those unpinned, so f64 tiles with f32 c and b
    fail inside its CG; the port pins on purpose). An operator that holds
    data of another dtype and has no ``astype`` raises."""
    if isinstance(a_op, DenseOp):
        return DenseOp(a_op.a.to(dtype).contiguous())
    if a_op.dtype is None or a_op.dtype == dtype:
        return a_op
    try:
        return a_op.astype(dtype)
    except NotImplementedError:
        raise ValueError(
            f"the operator holds {a_op.dtype} data and the solve iterates "
            f"in {dtype}; {type(a_op).__name__} cannot be cast (no astype): "
            f"build it in {dtype}") from None
