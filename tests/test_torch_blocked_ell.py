"""The port's BlockedEllOp against the JAX package's, twin by twin of
``tests/test_blocked_ell.py``, plus the layouts array for array and the
operators across ``interop.operator_from_reference``.

The port keeps the JAX package's slots and indices (``cols``, ``cols_t``)
exactly and stores each tile row's slots side by side, (nbr, bm, K, bn),
so that a product is one ``bmm``: ``blocks.permute(0, 2, 1, 3)`` is the
JAX package's (nbr, K, bm, bn). Products and reductions agree to 1e-12
in f64 (sums in other orders); f64 solves take the JAX package's
iterations with x to 1e-8.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
import totsu_tpu_torch as tt
from totsu_tpu.solver import operator as jop
from totsu_tpu_torch import interop
from totsu_tpu_torch.solver.scaling import ruiz_equilibrate_op

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


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def block_banded(m, n, bm, bn, band=1, seed=0, dtype=np.float64):
    """Dense matrix that is block-banded at tile granularity."""
    rng = np.random.default_rng(seed)
    a = np.zeros((m, n), dtype=dtype)
    nbr, nbc = -(-m // bm), -(-n // bn)
    for i in range(nbr):
        for j in range(nbc):
            if abs(i * nbc // nbr - j) <= band:
                r0, c0 = i * bm, j * bn
                a[r0:min(r0 + bm, m), c0:min(c0 + bn, n)] = rng.normal(
                    size=(min(bm, m - r0), min(bn, n - c0)))
    return a


def assert_same_layout(op, jax_op):
    """The port's arrays are the JAX package's, the tiles permuted."""
    assert (op.m, op.n, op.bm, op.bn) == (jax_op.m, jax_op.n, jax_op.bm,
                                          jax_op.bn)
    for ours, theirs in ((op.blocks, jax_op.blocks),
                         (op.blocks_t, jax_op.blocks_t)):
        np.testing.assert_array_equal(ours.permute(0, 2, 1, 3).numpy(),
                                      np.asarray(theirs))
    for ours, theirs in ((op.cols, jax_op.cols), (op.cols_t, jax_op.cols_t)):
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def check_operator(op, dense, seed=0):
    """The operator contract (the reference's operator-oracle
    discipline, utils2/operator_ref.rs): <A x, y> = <x, A^T y>, the
    absolute sums and to_dense against the dense matrix."""
    rng = np.random.default_rng(seed)
    m, n = dense.shape
    x, y = rng.normal(size=n), rng.normal(size=m)
    ax = op.matvec(_t(x)).numpy()
    aty = op.rmatvec(_t(y)).numpy()
    assert abs(ax @ y - x @ aty) <= 1e-10 * (1.0 + abs(ax @ y))
    np.testing.assert_allclose(ax, dense @ x, atol=1e-12)
    np.testing.assert_allclose(aty, dense.T @ y, atol=1e-12)
    np.testing.assert_allclose(op.col_abssum().numpy(),
                               np.abs(dense).sum(axis=0), atol=1e-12)
    np.testing.assert_allclose(op.row_abssum().numpy(),
                               np.abs(dense).sum(axis=1), atol=1e-12)
    np.testing.assert_allclose(op.to_dense().numpy(), dense, atol=1e-12)


def test_blocked_ell_matches_dense():
    a = block_banded(70, 50, bm=16, bn=8)   # non-multiple dims -> padding
    op = tt.BlockedEllOp.from_dense(a, block=(16, 8), device=CPU)
    jax_op = jt.BlockedEllOp.from_dense(a, block=(16, 8))
    assert_same_layout(op, jax_op)
    rng = np.random.default_rng(1)
    x = rng.normal(size=50)
    y = rng.normal(size=70)
    for got, want in (
            (op.matvec(_t(x)), jax_op.matvec(jnp.asarray(x))),
            (op.rmatvec(_t(y)), jax_op.rmatvec(jnp.asarray(y))),
            (op.col_abssum(), jax_op.col_abssum()),
            (op.row_abssum(), jax_op.row_abssum()),
            (op.to_dense(), jnp.asarray(a))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)


def test_blocked_ell_operator_contract():
    a = block_banded(48, 32, bm=8, bn=8, seed=2)
    check_operator(tt.BlockedEllOp.from_dense(a, block=(8, 8), device=CPU),
                   a)


def test_blocked_ell_solve_matches_dense_solve():
    # a block-banded LP through the pdhg engine: the ELL solve follows the
    # dense solve's iterate path, and the JAX package's. The JAX test runs
    # it to eps_acc 1e-6 (tens of thousands of iterations, minutes on the
    # port's CPU host loop); here the first 3,000 iterations, where the
    # three paths must already agree to 1e-8
    rng = np.random.default_rng(3)
    n, m = 32, 64
    a = block_banded(m, n, bm=8, bn=8, band=1, seed=3)
    x0 = rng.normal(size=n)
    h = a @ x0 + rng.random(m) + 0.1
    c = rng.normal(size=n) * 0.1
    lay = jt.ConeLayout([jt.rpos(m)])
    kw = dict(max_iter=3_000, eps_acc=1e-6, check_period=10)
    rj = jt.solve_jit(jnp.asarray(c),
                      jt.BlockedEllOp.from_dense(a, block=(8, 8)),
                      jnp.asarray(h), lay, jt.SolverParam(**kw))
    tl = interop.cone_from_reference(lay)
    rd = tt.solve_jit(_t(c), _t(a), _t(h), tl, tt.SolverParam(**kw))
    rs = tt.solve_jit(_t(c), tt.BlockedEllOp.from_dense(a, block=(8, 8),
                                                        device=CPU),
                      _t(h), tl, tt.SolverParam(**kw))
    assert rs.status == rd.status == int(rj.status)
    assert rs.iters == rd.iters == int(rj.iters)
    np.testing.assert_allclose(rs.x.numpy(), rd.x.numpy(), atol=1e-8)
    np.testing.assert_allclose(rs.x.numpy(), np.asarray(rj.x), atol=1e-8)


def test_blocked_ell_tile_density():
    a = block_banded(64, 64, bm=8, bn=8, band=1, seed=4)
    op = tt.BlockedEllOp.from_dense(a, block=(8, 8), device=CPU)
    assert op.tile_density < 0.5   # banded: ~3/8 of the grid
    assert op.tile_density == jt.BlockedEllOp.from_dense(
        a, block=(8, 8)).tile_density


def test_blocked_ell_absmax_and_diag_scale():
    a = block_banded(70, 50, bm=16, bn=8, seed=4)
    op = tt.BlockedEllOp.from_dense(a, block=(16, 8), device=CPU)
    jax_op = jt.BlockedEllOp.from_dense(a, block=(16, 8))
    np.testing.assert_allclose(op.row_absmax().numpy(),
                               np.abs(a).max(axis=1), atol=1e-12)
    np.testing.assert_allclose(op.col_absmax().numpy(),
                               np.abs(a).max(axis=0), atol=1e-12)
    np.testing.assert_allclose(op.col_sqsum().numpy(),
                               np.asarray(jax_op.col_sqsum()), rtol=1e-12)
    rng = np.random.default_rng(5)
    d = rng.random(70) + 0.5
    e = rng.random(50) + 0.5
    scaled = op.diag_scale(_t(d), _t(e))
    assert isinstance(scaled, tt.BlockedEllOp)
    np.testing.assert_allclose(scaled.to_dense().numpy(),
                               d[:, None] * a * e[None, :], atol=1e-12)
    # the same elementwise products as the JAX package's, tile for tile
    assert_same_layout(scaled, jax_op.diag_scale(jnp.asarray(d),
                                                 jnp.asarray(e)))


def test_blocked_ell_ruiz_matches_dense_ruiz():
    a = block_banded(64, 48, bm=16, bn=16, seed=6)
    a *= 10.0 ** np.random.default_rng(7).uniform(-2, 2, size=(64, 1))
    lay = tt.ConeLayout([tt.rpos(64)])
    b = _t(np.random.default_rng(8).random(64))
    c = _t(np.random.default_rng(9).random(48))
    op_e, b_e, c_e, d_e, e_e = ruiz_equilibrate_op(
        tt.BlockedEllOp.from_dense(a, block=(16, 16), device=CPU), b, c,
        lay, 10)
    dn_e, b_d, c_d, d_d, e_d = ruiz_equilibrate_op(tt.DenseOp(_t(a)), b, c,
                                                   lay, 10)
    np.testing.assert_allclose(d_e.numpy(), d_d.numpy(), atol=1e-12)
    np.testing.assert_allclose(e_e.numpy(), e_d.numpy(), atol=1e-12)
    np.testing.assert_allclose(op_e.to_dense().numpy(), dn_e.a.numpy(),
                               atol=1e-12)
    from totsu_tpu.solver.scaling import ruiz_equilibrate_op as jruiz
    _, _, _, d_j, e_j = jruiz(jt.BlockedEllOp.from_dense(a, block=(16, 16)),
                              jnp.asarray(b.numpy()), jnp.asarray(c.numpy()),
                              jt.ConeLayout([jt.rpos(64)]), 10)
    np.testing.assert_allclose(d_e.numpy(), np.asarray(d_j), rtol=1e-12)
    np.testing.assert_allclose(e_e.numpy(), np.asarray(e_j), rtol=1e-12)


def test_blocked_ell_astype_bf16_matvec_dtype():
    # bf16 tile storage for the update products (widened to f32 per call,
    # as the JAX package's einsum does) while the criteria keep the exact
    # f32 operator: CONVERGED certifies the original problem, as in JAX
    a = block_banded(96, 48, bm=16, bn=16, seed=10)
    cast = tt.BlockedEllOp.from_dense(a, block=(16, 16),
                                      device=CPU).astype("bfloat16")
    assert cast.blocks.dtype == cast.blocks_t.dtype == torch.bfloat16
    assert cast.cols.dtype == torch.int32      # indices untouched
    x = torch.ones(48, dtype=torch.float32)
    assert cast.matvec(x).dtype == torch.float32
    rng = np.random.default_rng(11)
    x0 = rng.normal(size=48)
    h = a @ x0 + rng.random(96) + 0.1
    c = rng.normal(size=48)
    lay = jt.ConeLayout([jt.rpos(96)])
    kw = dict(max_iter=300_000, eps_acc=1e-2, check_period=20,
              accel="halpern", normalize=True, matvec_dtype="bfloat16")
    a32, c32, h32 = (v.astype(np.float32) for v in (a, c, h))
    rj = jt.solve_jit(jnp.asarray(c32),
                      jt.BlockedEllOp.from_dense(a32, block=(16, 16)),
                      jnp.asarray(h32), lay, jt.SolverParam(**kw))
    rt = tt.solve_jit(_t(c32, torch.float32),
                      tt.BlockedEllOp.from_dense(a32, block=(16, 16),
                                                 device=CPU),
                      _t(h32, torch.float32), interop.cone_from_reference(lay),
                      tt.SolverParam(**kw))
    assert rt.status == int(rj.status) == tt.SolverStatus.CONVERGED


def test_blocked_ell_pdhg_equilibrated_solve():
    a0 = block_banded(48, 48, bm=16, bn=16, seed=12)
    a = np.concatenate([a0, np.eye(48), -np.eye(48)])
    a *= 10.0 ** np.random.default_rng(13).uniform(-1.5, 1.5, size=(144, 1))
    rng = np.random.default_rng(14)
    x0 = rng.normal(size=48)
    h = a @ x0 + rng.random(144) + 0.1
    c = rng.normal(size=48)
    lay = jt.ConeLayout([jt.rpos(144)])
    kw = dict(max_iter=400_000, eps_acc=1e-6, check_period=20,
              accel="halpern", normalize=True, equil_iters=10)
    tl = interop.cone_from_reference(lay)
    ell = tt.BlockedEllOp.from_dense(a, block=(16, 16), device=CPU)
    r = tt.solve_jit(_t(c), ell, _t(h), tl, tt.SolverParam(**kw))
    assert r.status == tt.SolverStatus.CONVERGED
    r_ref = tt.solve_jit(_t(c), _t(a), _t(h), tl, tt.SolverParam(**kw))
    np.testing.assert_allclose(float(c @ r.x.numpy()),
                               float(c @ r_ref.x.numpy()), rtol=1e-4,
                               atol=1e-4)
    rj = jt.solve_jit(jnp.asarray(c),
                      jt.BlockedEllOp.from_dense(a, block=(16, 16)),
                      jnp.asarray(h), lay, jt.SolverParam(**kw))
    assert r.iters == int(rj.iters)
    np.testing.assert_allclose(r.x.numpy(), np.asarray(rj.x), atol=1e-8)


def _tiles_of(a, bm, bn):
    """The nonzero tiles of the zero-padded grid of ``a``."""
    m, n = a.shape
    ap = np.zeros((-(-m // bm) * bm, -(-n // bn) * bn))
    ap[:m, :n] = a
    tiles = {}
    for i in range(ap.shape[0] // bm):
        for j in range(ap.shape[1] // bn):
            t = ap[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn]
            if np.abs(t).sum() > 0:
                tiles[(i, j)] = t
    return tiles


def test_blocked_ell_from_tiles_matches_from_dense():
    bm, bn = 16, 8
    a = block_banded(64, 40, bm=bm, bn=bn, seed=3)
    ref = tt.BlockedEllOp.from_dense(a, block=(bm, bn), device=CPU)
    tiles = _tiles_of(a, bm, bn)
    op = tt.BlockedEllOp.from_tiles(tiles, m=64, n=40, block=(bm, bn),
                                    device=CPU)
    check_operator(op, a)
    assert_same_layout(op, jt.BlockedEllOp.from_tiles(tiles, m=64, n=40,
                                                      block=(bm, bn)))
    rng = np.random.default_rng(4)
    x = _t(rng.normal(size=40))
    y = _t(rng.normal(size=64))
    np.testing.assert_allclose(op.matvec(x).numpy(), ref.matvec(x).numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(op.rmatvec(y).numpy(),
                               ref.rmatvec(y).numpy(), atol=1e-12)
    # duplicate tile coordinates sum (BSR semantics)
    t00 = next(iter(tiles.values()))
    dup = tt.BlockedEllOp.from_tiles({(0, 0): t00, (0, 1): t00}, m=bm,
                                     n=2 * bn, block=(bm, bn), device=CPU)
    two = tt.BlockedEllOp.from_tiles({(0, 0): 2.0 * t00}, m=bm, n=bn,
                                     block=(bm, bn), device=CPU)
    np.testing.assert_allclose(
        dup.matvec(torch.ones(2 * bn, dtype=torch.float64)).numpy(),
        two.matvec(torch.ones(bn, dtype=torch.float64)).numpy(), atol=1e-12)


def test_blocked_ell_from_bsr_matches_dense():
    from scipy import sparse
    bm, bn = 8, 8
    a = block_banded(64, 32, bm=bm, bn=bn, seed=5)
    op = tt.BlockedEllOp.from_bsr(sparse.csr_matrix(a), block=(bm, bn),
                                  device=CPU)
    check_operator(op, a)
    assert_same_layout(op, jt.BlockedEllOp.from_bsr(sparse.csr_matrix(a),
                                                    block=(bm, bn)))
    with pytest.raises(ValueError, match="divide the shape"):
        tt.BlockedEllOp.from_bsr(sparse.csr_matrix(np.ones((10, 10))),
                                 block=(8, 8), device=CPU)


def test_blocked_ell_from_tiles_large_virtual_no_dense():
    # an operator built from its band tiles only (4096^2, 128 MB if dense
    # in f64), solved through the fast profile's routing to the indirect
    # engine; the JAX package's status and iterations. (The same
    # constructor builds the 65,536^2 case on the card: chip_smoke.py
    # phase 20.)
    bm = bn = 128
    n = 4096
    rng = np.random.default_rng(7)
    nb = n // bm
    tiles = {}
    for i in range(nb):
        for j in (i - 1, i, i + 1):
            if 0 <= j < nb:
                tiles[(i, j)] = rng.normal(size=(bm, bn)) / np.sqrt(3 * bn)
    op = tt.BlockedEllOp.from_tiles(tiles, m=n, n=n, block=(bm, bn),
                                    device=CPU)
    assert op.cols.shape[1] <= 3          # K = band tiles, not nb
    x0 = rng.normal(size=n)
    ax = op.matvec(_t(x0)).numpy()
    ones = torch.ones(n, dtype=torch.float64)
    a_full = tt.VStackOp((op, tt.DiagOp(ones), tt.DiagOp(-ones)))
    b = np.concatenate([ax + rng.random(n) + 0.1, np.full(n, 10.0),
                        np.full(n, 10.0)])
    c = rng.normal(size=n)
    kw = dict(max_iter=50_000, eps_acc=1e-3, profile="fast")
    res = tt.solve(_t(c), a_full, _t(b), tt.ConeLayout([tt.rpos(3 * n)]),
                   tt.SolverParam(**kw))
    assert res.status == tt.SolverStatus.CONVERGED
    jop_full = jop.VStackOp((jt.BlockedEllOp.from_tiles(
        tiles, m=n, n=n, block=(bm, bn)), jop.DiagOp(jnp.ones(n)),
        jop.DiagOp(-jnp.ones(n))))
    rj = jt.solve(jnp.asarray(c), jop_full, jnp.asarray(b),
                  jt.ConeLayout([jt.rpos(3 * n)]), jt.SolverParam(**kw))
    assert res.iters == int(rj.iters)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(rj.x), atol=1e-8)


def test_from_tiles_accepts_array_likes():
    ell = tt.BlockedEllOp.from_tiles({(0, 0): [[1.0, 2.0], [3.0, 4.0]]},
                                     m=2, n=2, block=(2, 2), device=CPU)
    np.testing.assert_allclose(ell.to_dense().numpy(),
                               [[1.0, 2.0], [3.0, 4.0]])


def test_from_bsr_does_not_mutate_caller():
    from scipy import sparse as sp
    data = np.stack([np.full((2, 2), 2.0), np.full((2, 2), 1.0)])
    indices = np.array([1, 0])          # deliberately unsorted
    indptr = np.array([0, 2, 2])
    bu = sp.bsr_matrix((data, indices, indptr), shape=(4, 4))
    before = bu.indices.copy()
    ell = tt.BlockedEllOp.from_bsr(bu, block=(2, 2), device=CPU)
    assert (bu.indices == before).all()      # caller untouched
    np.testing.assert_allclose(ell.to_dense().numpy(), bu.toarray())


# ---- the operators across interop.operator_from_reference


def _reference_ops():
    rng = np.random.default_rng(21)
    a = rng.normal(size=(6, 4))
    band = block_banded(24, 16, bm=8, bn=8, seed=21)
    sp_dense = a * (rng.random((6, 4)) < 0.5)
    return {
        "DenseOp": jt.DenseOp(jnp.asarray(a)),
        "DiagOp": jop.DiagOp(jnp.asarray(rng.normal(size=5))),
        "ZeroOp": jop.ZeroOp(3, 4),
        "VStackOp": jop.VStackOp((jt.DenseOp(jnp.asarray(a)),
                                  jop.ZeroOp(2, 4))),
        "HStackOp": jop.HStackOp((jt.DenseOp(jnp.asarray(a)),
                                  jop.DiagOp(jnp.ones(6)))),
        "ScaledOp": jop.ScaledOp(-1.5, jt.DenseOp(jnp.asarray(a))),
        "BlockedEllOp": jt.BlockedEllOp.from_dense(band, block=(8, 8)),
        "SparseOp": jop.SparseOp.from_dense(jnp.asarray(sp_dense)),
    }


@pytest.mark.parametrize("kind", list(_reference_ops()))
def test_operator_from_reference_round_trip(kind):
    # the same operator on both sides: its dense form, products and
    # reductions agree; a BlockedEllOp keeps the JAX arrays exactly
    jax_op = _reference_ops()[kind]
    op = interop.operator_from_reference(jax_op, device=CPU)
    assert type(op).__name__ == kind
    dense = np.asarray(jax_op.to_dense(), dtype=np.float64)
    if kind == "ZeroOp":
        op = op.astype(torch.float64)
    check_operator(op, dense)
    if kind == "BlockedEllOp":
        assert_same_layout(op, jax_op)
    if kind == "SparseOp":
        assert op.mat.is_coalesced()           # BCOO.fromdense: unique
    f32 = interop.operator_from_reference(jax_op, device=CPU,
                                          dtype="float32")
    assert f32.dtype in (torch.float32, None)


def test_operator_from_reference_refuses_custom_op():
    jax_op = jt.CustomOp(params=jnp.eye(3), m=3, n=3,
                         matvec_fn=lambda p, x: p @ x)
    with pytest.raises(NotImplementedError, match="JAX functions"):
        interop.operator_from_reference(jax_op, device=CPU)
