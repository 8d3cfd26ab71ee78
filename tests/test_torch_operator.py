"""The port's operators against the JAX package's, twin by twin of
``tests/test_operator.py``.

Each operator is built from the same numpy data in both packages (the
port's on CPU tensors, f64) and every method is held against the JAX
operator and against the dense matrix, to 1e-10 (sums in other orders).
Solves hold the status and the iteration count equal and x to 1e-8.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
import totsu_tpu_torch as tt
from totsu_tpu.solver import operator as jop
from totsu_tpu_torch import interop

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its problems are small, and
    the suite runs several workers on one machine, where torch's thread
    pools would oversubscribe the cores (measured: the module ran ten
    times slower beside five busy workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def check_against_dense(op, dense, jax_op=None):
    """The port's ``op`` against ``dense`` (and the JAX twin ``jax_op``):
    shape, matvec, rmatvec, the absolute sums and to_dense."""
    dense = np.asarray(dense)
    m, n = dense.shape
    assert op.shape == (m, n)
    rng = np.random.default_rng(42)
    x = rng.normal(size=n)
    y = rng.normal(size=m)
    got = {
        "matvec": op.matvec(_t(x)), "rmatvec": op.rmatvec(_t(y)),
        "col_abssum": op.col_abssum(), "row_abssum": op.row_abssum(),
        "to_dense": op.to_dense(),
    }
    want = {
        "matvec": dense @ x, "rmatvec": dense.T @ y,
        "col_abssum": np.abs(dense).sum(axis=0),
        "row_abssum": np.abs(dense).sum(axis=1), "to_dense": dense,
    }
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), want[name], atol=1e-10,
                                   err_msg=name)
    if jax_op is not None:
        theirs = {
            "matvec": jax_op.matvec(jnp.asarray(x)),
            "rmatvec": jax_op.rmatvec(jnp.asarray(y)),
            "col_abssum": jax_op.col_abssum(),
            "row_abssum": jax_op.row_abssum(),
            "to_dense": jax_op.to_dense(),
        }
        for name, value in got.items():
            np.testing.assert_allclose(value.numpy(),
                                       np.asarray(theirs[name]),
                                       atol=1e-10, err_msg=name)


def test_dense_op():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 3))
    check_against_dense(tt.DenseOp(_t(a)), a, jt.DenseOp(jnp.asarray(a)))


def test_zero_op():
    # the port's ZeroOp has a device like every operator (it stores no
    # data: its reductions come in torch's default dtype until a stack or
    # astype gives it one)
    op = tt.ZeroOp(3, 2, device=CPU)
    assert op.dtype is None and op.device == torch.device(CPU)
    check_against_dense(op.astype(torch.float64), np.zeros((3, 2)),
                        jt.ZeroOp(3, 2))


def test_vstack():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(2, 3))
    b = rng.normal(size=(4, 3))
    op = tt.VStackOp((tt.DenseOp(_t(a)), tt.DenseOp(_t(b))))
    jax_op = jt.VStackOp((jt.DenseOp(jnp.asarray(a)),
                          jt.DenseOp(jnp.asarray(b))))
    check_against_dense(op, np.vstack([a, b]), jax_op)


def test_hstack():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(3, 2))
    b = rng.normal(size=(3, 4))
    op = tt.HStackOp((tt.DenseOp(_t(a)), tt.DenseOp(_t(b))))
    jax_op = jt.HStackOp((jt.DenseOp(jnp.asarray(a)),
                          jt.DenseOp(jnp.asarray(b))))
    check_against_dense(op, np.hstack([a, b]), jax_op)


def test_block_with_zero():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(2, 3))
    op = tt.BlockOp([
        [tt.DenseOp(_t(a)), tt.ZeroOp(2, 1, device=CPU)],
        [tt.ZeroOp(1, 3, device=CPU), tt.DenseOp(_t([[2.0]]))],
    ])
    jax_op = jt.BlockOp([
        [jt.DenseOp(jnp.asarray(a)), jt.ZeroOp(2, 1)],
        [jt.ZeroOp(1, 3), jt.DenseOp(jnp.asarray(np.array([[2.0]])))],
    ])
    dense = np.block([[a, np.zeros((2, 1))],
                      [np.zeros((1, 3)), np.array([[2.0]])]])
    check_against_dense(op, dense, jax_op)
    # the stack's dtype is its data's; the ZeroOps hold none
    assert op.dtype == torch.float64
    assert op.col_abssum().dtype == op.row_absmax().dtype == torch.float64


def test_scaled():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(3, 3))
    check_against_dense(tt.ScaledOp(-2.5, tt.DenseOp(_t(a))), -2.5 * a,
                        jt.ScaledOp(-2.5, jt.DenseOp(jnp.asarray(a))))


def test_custom_op_default_adjoint():
    # matrix-free operator: the adjoint from autograd (the VJP at zero,
    # where the JAX package takes jax.linear_transpose), the absolute sums
    # by materialization
    rng = np.random.default_rng(5)
    a = rng.normal(size=(5, 4))
    op = tt.CustomOp(params=_t(a), m=5, n=4, matvec_fn=lambda p, x: p @ x)
    assert op.device == torch.device(CPU) and op.dtype == torch.float64
    jax_op = jt.CustomOp(params=jnp.asarray(a), m=5, n=4,
                         matvec_fn=lambda p, x: p @ x)
    check_against_dense(op, a, jax_op)


def test_custom_op_stencil():
    # 1-D Laplacian stencil (the imgnr_udef pattern) with no params: the
    # device and dtype are given
    n = 8

    def lap(params, x):
        del params
        return x - 0.5 * (torch.roll(x, 1) + torch.roll(x, -1))

    def jlap(params, x):
        del params
        return x - 0.5 * (jnp.roll(x, 1) + jnp.roll(x, -1))

    op = tt.CustomOp(params=None, m=n, n=n, matvec_fn=lap, device=CPU,
                     dtype=torch.float64)
    jax_op = jt.CustomOp(params=None, m=n, n=n, matvec_fn=jlap)
    dense = np.asarray(jax.vmap(lambda e: jlap(None, e), in_axes=1,
                                out_axes=1)(jnp.eye(n)))
    check_against_dense(op, dense, jax_op)


def test_ops_are_frozen_dataclasses():
    # the JAX operators are pytrees whose only leaf here is the dense
    # matrix; the port's are frozen dataclasses holding the same one
    # tensor, on one device
    rng = np.random.default_rng(6)
    a = rng.normal(size=(3, 3))
    op = tt.VStackOp((tt.DenseOp(_t(a)), tt.ZeroOp(2, 3, device=CPU)))
    jax_op = jt.VStackOp((jt.DenseOp(jnp.asarray(a)), jt.ZeroOp(2, 3)))
    tensors = [getattr(o, f.name) for o in op.ops
               for f in dataclasses.fields(o)
               if isinstance(getattr(o, f.name), torch.Tensor)]
    assert len(tensors) == len(jax.tree_util.tree_leaves(jax_op)) == 1
    with pytest.raises(dataclasses.FrozenInstanceError):
        op.ops = ()
    x = np.ones(3)
    np.testing.assert_allclose(op.matvec(_t(x)).numpy(),
                               np.asarray(jax_op.matvec(jnp.asarray(x))),
                               atol=1e-12)


def test_diag_op():
    d = np.array([1.0, -2.0, 0.5])
    check_against_dense(tt.DiagOp(_t(d)), np.diag(d),
                        jt.DiagOp(jnp.asarray(d)))


def test_sparse_op():
    rng = np.random.default_rng(11)
    a = rng.normal(size=(9, 6)) * (rng.random((9, 6)) < 0.3)
    op = tt.SparseOp.from_dense(a, device=CPU)
    assert op.mat.is_coalesced()
    check_against_dense(op, a, jop.SparseOp.from_dense(a))


def _box_lp(n=6):
    eye = np.eye(n)
    g = np.concatenate([eye, -eye])
    h = np.ones(2 * n)
    c = np.linspace(-1.0, 1.0, n) + 0.1
    return c, g, h


def test_sparse_op_end_to_end_solve():
    # a sparse LP through the whole pdhg solve: the JAX package's status,
    # iterations and x
    c, g, h = _box_lp()
    lay = jt.ConeLayout([jt.rpos(12)])
    p = dict(max_iter=50_000)
    rj = jt.solve(jnp.asarray(c), jop.SparseOp.from_dense(jnp.asarray(g)),
                  jnp.asarray(h), lay, jt.SolverParam(**p))
    rt = tt.solve(_t(c), tt.SparseOp.from_dense(g, device=CPU), _t(h),
                  interop.cone_from_reference(lay), tt.SolverParam(**p))
    np.testing.assert_allclose(rt.x.numpy(), -np.sign(c), atol=1e-3)
    assert rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-8)


def test_sparse_op_ruiz_trio_and_sqsum():
    rng = np.random.default_rng(11)
    a = rng.normal(size=(9, 6)) * (rng.random((9, 6)) < 0.4)
    a[3] = 0.0                                     # an empty row
    op = tt.SparseOp.from_dense(a, device=CPU)
    jax_op = jop.SparseOp.from_dense(a)
    for name, want in (("row_absmax", np.abs(a).max(axis=1)),
                       ("col_absmax", np.abs(a).max(axis=0)),
                       ("col_sqsum", (a * a).sum(axis=0))):
        got = getattr(op, name)().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got, np.asarray(getattr(jax_op, name)()),
                                   rtol=1e-12, atol=1e-12)
    d = rng.random(9) + 0.5
    e = rng.random(6) + 0.5
    scaled = op.diag_scale(_t(d), _t(e))
    np.testing.assert_allclose(scaled.to_dense().numpy(),
                               d[:, None] * a * e[None, :], atol=1e-12)
    np.testing.assert_allclose(
        scaled.to_dense().numpy(),
        np.asarray(jax_op.diag_scale(jnp.asarray(d),
                                     jnp.asarray(e)).to_dense()), atol=1e-12)
    out = op.astype(torch.float32).matvec(torch.ones(6, dtype=torch.float32))
    assert out.dtype == torch.float32


def _banded_box(n=48, seed=5):
    rng = np.random.default_rng(seed)
    band = np.zeros((n, n))
    for i in range(n):
        lo, hi = max(0, i - 3), min(n, i + 4)
        band[i, lo:hi] = rng.normal(size=hi - lo)
    a = np.concatenate([band, np.eye(n), -np.eye(n)])
    h = np.concatenate([band @ rng.normal(size=n) + rng.random(n) + 0.1,
                        np.full(2 * n, 5.0)])
    c = rng.normal(size=n)
    return c, a, h, jt.ConeLayout([jt.rpos(3 * n)])


def test_sparse_op_indirect_engine_with_equil():
    # SparseOp through the indirect engine with Jacobi PCG and Ruiz: the
    # JAX package's iterations and x, and the dense solve's objective
    c, a, h, lay = _banded_box()
    p = dict(max_iter=100_000, method="direct", accel="halpern",
             check_period=10, cg_precond="jacobi", equil_iters=10)
    rj = jt.solve_jit(jnp.asarray(c), jop.SparseOp.from_dense(jnp.asarray(a)),
                      jnp.asarray(h), lay, jt.SolverParam(**p))
    tl = interop.cone_from_reference(lay)
    rt = tt.solve_jit(_t(c), tt.SparseOp.from_dense(a, device=CPU), _t(h),
                      tl, tt.SolverParam(**p))
    assert rt.status == int(rj.status) == tt.SolverStatus.CONVERGED
    assert rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-8)
    r_ref = tt.solve_jit(_t(c), _t(a), _t(h), tl,
                         tt.SolverParam(max_iter=100_000, method="direct",
                                        accel="halpern", check_period=10))
    np.testing.assert_allclose(float(c @ rt.x.numpy()),
                               float(c @ r_ref.x.numpy()), rtol=1e-3,
                               atol=1e-3)


def test_sparse_op_duplicate_indices_guard():
    # col_sqsum on duplicate coordinates would overstate diag(A^T A): it
    # refuses, as the JAX package's does on a BCOO without
    # unique_indices (in torch: an uncoalesced tensor; coalescing would sum
    # the duplicates silently). diag_scale and astype keep the flag
    from jax.experimental import sparse
    idx = np.array([[0, 0], [0, 0]])
    vals = np.array([3.0, -3.0])
    dup = torch.sparse_coo_tensor(torch.as_tensor(idx.T), _t(vals), (2, 2))
    with pytest.raises(NotImplementedError, match="unique indices"):
        tt.SparseOp(dup).col_sqsum()
    jdup = sparse.BCOO((jnp.asarray(vals), jnp.asarray(idx)), shape=(2, 2))
    with pytest.raises(NotImplementedError):
        jop.SparseOp(jdup).col_sqsum()
    # the same BCOO across interop keeps its duplicates and the guard
    crossed = interop.operator_from_reference(jop.SparseOp(jdup), device=CPU)
    with pytest.raises(NotImplementedError, match="unique indices"):
        crossed.col_sqsum()
    # abs sums and maxima add the duplicates' magnitudes, as BCOO's do
    np.testing.assert_allclose(crossed.col_abssum().numpy(),
                               np.asarray(jop.SparseOp(jdup).col_abssum()))
    uni = tt.SparseOp.from_dense(np.eye(3), device=CPU)
    scaled = uni.diag_scale(torch.ones(3, dtype=torch.float64),
                            torch.ones(3, dtype=torch.float64))
    assert scaled.mat.is_coalesced()
    assert uni.astype(torch.float32).mat.is_coalesced()


def test_the_package_exports_the_jax_package_s_operators():
    names = ["LinOp", "DenseOp", "DiagOp", "SparseOp", "BlockedEllOp",
             "ZeroOp", "CustomOp", "VStackOp", "HStackOp", "BlockOp",
             "ScaledOp", "as_linop"]
    assert set(names) <= set(jt.__all__)
    assert set(names) <= set(tt.__all__)
    assert all(hasattr(tt, name) for name in names)


def _ruiz_cases():
    rng = np.random.default_rng(31)
    a = rng.normal(size=(6, 4)) * 10.0 ** rng.uniform(-2, 2, size=(6, 1))
    d = rng.uniform(0.1, 10.0, size=4)
    sp = a * (rng.random((6, 4)) < 0.6)
    return {
        "VStackOp": (lambda: tt.VStackOp((tt.DenseOp(_t(a)),
                                          tt.DiagOp(_t(d)))),
                     np.vstack([a, np.diag(d)])),
        "HStackOp": (lambda: tt.HStackOp((tt.DenseOp(_t(a)),
                                          tt.ZeroOp(6, 2, device=CPU))),
                     np.hstack([a, np.zeros((6, 2))])),
        "ScaledOp": (lambda: tt.ScaledOp(-3.0, tt.DenseOp(_t(a))), -3.0 * a),
        "DiagOp": (lambda: tt.DiagOp(_t(d)), np.diag(d)),
        "SparseOp": (lambda: tt.SparseOp.from_dense(sp, device=CPU), sp),
    }


@pytest.mark.parametrize("kind", list(_ruiz_cases()))
def test_ruiz_composes_with_every_operator(kind):
    # operator-form Ruiz on each structured operator: the scales and the
    # scaled matrix of the dense Ruiz on its dense form
    from totsu_tpu_torch.solver.scaling import ruiz_equilibrate_op
    build, dense = _ruiz_cases()[kind]
    m, n = dense.shape
    lay = tt.ConeLayout([tt.rpos(m)])
    b, c = _t(np.linspace(1.0, 2.0, m)), _t(np.linspace(-1.0, 1.0, n))
    op, _, _, d, e = ruiz_equilibrate_op(build(), b, c, lay, 10)
    ref, _, _, d_ref, e_ref = ruiz_equilibrate_op(tt.DenseOp(_t(dense)), b,
                                                  c, lay, 10)
    assert type(op).__name__ == kind
    np.testing.assert_allclose(d.numpy(), d_ref.numpy(), rtol=1e-12)
    np.testing.assert_allclose(e.numpy(), e_ref.numpy(), rtol=1e-12)
    np.testing.assert_allclose(op.to_dense().numpy(), ref.a.numpy(),
                               atol=1e-12)
