"""``BatchedOp``, the port's batch of structured operators (the JAX
package's operator pytree with lane-leading leaves), against its lanes:
every method on lane-leading vectors against ``lane(i)``'s single method
within 1e-12 relative in f64, for the seven forms of
``tests/torch_structured.py``; the products written out in lane-leading
form against the vmapped ones; ``BatchedOp.stack``'s refusals, each naming
the field; ``lanes``, ``shared`` and ``operator_from_reference(...,
batch=)``."""

import numpy as np
import pytest
import torch

import totsu_tpu_torch as tt
from totsu_tpu_torch import interop
from totsu_tpu_torch.solver import operator as op_
from torch_structured import FORMS, box_lp, jax_batch, port_batch, port_lanes
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

RTOL = 1e-12
#: the methods every form has; the CustomOp (no Ruiz, no Jacobi) stops
#: there
METHODS = ("matvec", "rmatvec", "dual_matvec", "col_abssum", "row_abssum")
MORE = ("row_absmax", "col_absmax", "col_sqsum")


def _close(got, want):
    scale = float(want.abs().max()) or 1.0
    assert float((got - want).abs().max()) <= RTOL * scale


def _vectors(m, n, lanes=3, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.normal(size=(lanes, n))),
            torch.tensor(rng.normal(size=(lanes, m))))


def _call(op, name, x, y):
    if name == "matvec":
        return op.matvec(x)
    if name == "rmatvec":
        return op.rmatvec(y)
    if name == "dual_matvec":
        return torch.cat(op.dual_matvec(x, y), dim=-1)
    return getattr(op, name)()


@pytest.mark.parametrize("form", FORMS)
def test_every_method_is_the_lane_s(form):
    """Each method of the batch, lane i of its result against lane i's
    single operator; ``diag_scale`` (d (B, m), e (B, n)) and ``astype``
    give batches whose lanes are the lanes' own; ``to_dense`` stacks the
    lanes'. The lanes hold the dense matrices they were built from."""
    _, a, _ = box_lp()
    batch = port_batch(form, a)
    m, n = batch.shape
    assert (m, n) == a.shape[1:] and batch.batch == 3
    assert torch.equal(batch.to_dense(), torch.tensor(a))
    x, y = _vectors(m, n)
    names = METHODS + (() if form == "custom" else MORE)
    for name in names:
        out = _call(batch, name, x, y)
        for i in range(3):
            _close(out[i], _call(batch.lane(i), name, x[i], y[i]))
    if form == "custom":
        return
    rng = np.random.default_rng(1)
    d = torch.tensor(rng.random((3, m)) + 0.5)
    e = torch.tensor(rng.random((3, n)) + 0.5)
    scaled = batch.diag_scale(d, e)
    low = batch.astype(torch.float32)
    assert low.dtype == torch.float32
    for i in range(3):
        _close(scaled.lane(i).to_dense(),
               batch.lane(i).diag_scale(d[i], e[i]).to_dense())
        assert torch.equal(low.lane(i).to_dense(),
                           batch.lane(i).astype(torch.float32).to_dense())
    for name in ("matvec", "col_abssum"):
        out = _call(scaled, name, x, y)
        for i in range(3):
            _close(out[i], _call(scaled.lane(i), name, x[i], y[i]))
    # a low-precision batch widens its data to the vectors' per call
    _close(low.matvec(x)[1], low.lane(1).astype(torch.float64).matvec(x[1]))


@pytest.mark.parametrize("form", [f for f in FORMS
                                  if f not in ("custom", "sparse")])
def test_written_out_products_are_the_vmapped_ones(form):
    """The lane-leading products written out (one gather and one bmm over
    every lane's tiles, stacks cut on the last axis) against
    ``torch.func.vmap`` of the single operator's, in f64 and in f32
    (there within f32's rounding)."""
    _, a, _ = box_lp()
    for dtype, rtol in ((torch.float64, RTOL), (torch.float32, 1e-6)):
        batch = port_batch(form, a).astype(dtype)
        assert batch._products is not None
        x, y = (v.to(dtype) for v in _vectors(*batch.shape, seed=2))
        for got, want in ((batch.matvec(x),
                           batch._map(lambda o, v: o.matvec(v), x)),
                          (batch.rmatvec(y),
                           batch._map(lambda o, v: o.rmatvec(v), y))):
            assert float((got - want).abs().max()) \
                <= rtol * float(want.abs().max())


def test_custom_op_adjoint_composes_with_vmap():
    """A CustomOp without an adjoint of its own takes torch.func.vjp's in
    a batch (autograd's does not compose with vmap); its lanes keep the
    autograd adjoint, and both agree; a hand adjoint is kept as it is."""
    _, a, _ = box_lp()
    batch = port_batch("custom", a)
    assert batch._products is None and batch.lane(0).rmatvec_fn is None
    _, y = _vectors(*batch.shape)
    out = batch.rmatvec(y)
    for i in range(3):
        _close(out[i], torch.tensor(a[i]).T @ y[i])

    def rmv(p, v):
        return v @ p

    hand = tt.BatchedOp.stack([
        tt.CustomOp(params=torch.tensor(ai), m=48, n=16,
                    matvec_fn=port_lanes("custom", a)[0].matvec_fn,
                    rmatvec_fn=rmv) for ai in a])
    assert hand.lane(2).rmatvec_fn is rmv
    _close(hand.rmatvec(y), out)


def test_stack_names_the_field_that_differs():
    """Lanes of another tile count K, another m, n, bm, or another
    CustomOp function are no batch: ValueError naming the field, as JAX's
    tree structure check refuses the stack; a stack of DenseOps is a
    BatchedDenseOp and one of SparseOps the block-diagonal form."""
    _, a, _ = box_lp()
    ell = port_lanes("ell", a)
    wide = a[0].copy()
    wide[:16, :] = 1.0                   # every tile nonzero: another K
    with pytest.raises(ValueError, match=r"BlockedEllOp\.blocks"):
        tt.BatchedOp.stack([ell[0], tt.BlockedEllOp.from_dense(
            wide, block=(4, 4), device="cpu")])
    with pytest.raises(ValueError, match=r"BlockedEllOp\.m is 44"):
        tt.BatchedOp.stack([ell[0], tt.BlockedEllOp.from_dense(
            a[1][:44], block=(4, 4), device="cpu")])
    with pytest.raises(ValueError, match=r"BlockedEllOp\.bm is 8"):
        tt.BatchedOp.stack([ell[0], tt.BlockedEllOp.from_dense(
            a[1], block=(8, 4), device="cpu")])
    custom = port_lanes("custom", a)
    other = tt.CustomOp(params=custom[1].params, m=48, n=16,
                        matvec_fn=lambda p, x: p @ x)
    with pytest.raises(ValueError, match=r"CustomOp\.matvec_fn"):
        tt.BatchedOp.stack([custom[0], other])
    with pytest.raises(ValueError, match=r"VStackOp\.ops"):
        vs = port_lanes("vstack", a)
        tt.BatchedOp.stack([vs[0], tt.VStackOp(vs[1].ops[:2] + (
            tt.DiagOp(torch.ones(16, dtype=torch.float64)),) * 2)])
    dense = tt.BatchedOp.stack([tt.DenseOp(torch.tensor(ai)) for ai in a])
    assert isinstance(dense, tt.BatchedDenseOp) and dense.batch == 3
    assert isinstance(port_batch("sparse", a), op_.BatchedSparseOp)


@pytest.mark.parametrize("form", FORMS)
def test_lanes_and_shared(form):
    """``lanes(i0, i1)`` is a batch of those lanes (the mesh's share);
    ``BatchedOp.shared`` makes one operator every lane's (expanded views
    for the tensor forms)."""
    _, a, _ = box_lp()
    batch = port_batch(form, a)
    part = batch.lanes(1, 3)
    assert part.batch == 2
    for j in range(2):
        assert torch.equal(part.lane(j).to_dense(),
                           batch.lane(j + 1).to_dense())
    one = port_lanes(form, a)[2]
    shared = tt.BatchedOp.shared(one, 4)
    assert shared.batch == 4
    x, _ = _vectors(*batch.shape, lanes=4)
    out = shared.matvec(x)
    for i in range(4):
        _close(out[i], one.matvec(x[i]))


def test_operator_from_reference_takes_a_batch():
    """``batch=B`` carries a batch-leading pytree across: the lanes of a
    stacked BlockedEllOp, a ScaledOp's (B,) alpha, a BCOO batched with
    n_batch=1 (the block-diagonal form) and a stacked DenseOp (a
    BatchedDenseOp); a BatchedOp of a SparseOp's single form is refused."""
    _, a, _ = box_lp()
    for form, kind in (("ell", tt.BatchedOp), ("scaled", tt.BatchedOp),
                       ("sparse", op_.BatchedSparseOp)):
        batch = interop.operator_from_reference(jax_batch(form, a),
                                                device="cpu", batch=3)
        assert type(batch) is kind
        assert torch.equal(batch.to_dense(), torch.tensor(a))
    scaled = interop.operator_from_reference(jax_batch("scaled", a),
                                             device="cpu", batch=3)
    assert [float(scaled.lane(i).alpha) for i in range(3)] == [0.5, 1.0, 2.0]
    from totsu_tpu.solver import operator as jop
    import jax
    import jax.numpy as jnp
    dense = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[jop.DenseOp(jnp.asarray(ai)) for ai in a])
    got = interop.operator_from_reference(dense, device="cpu", batch=3)
    assert isinstance(got, tt.BatchedDenseOp)
    with pytest.raises(ValueError, match=r"BatchedOp\.stack"):
        tt.BatchedOp(port_lanes("sparse", a)[0], 3)
