"""Batches of structured operators for the port's CPU twins: one banded
box LP per lane (``benchmarks/benchmark_indirect.py``'s
``make_banded_box_lp`` at n = 16 with 4 x 4 tiles, seeds 0-2), and each
lane's A in seven operator forms, built for the JAX package as a
batch-leading pytree and for the port as ``BatchedOp`` s of the same
lanes.

Every form is the same (3n, n) matrix [band; I; -I], so each lane's
problem is one LP whatever its form."""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import torch

import totsu_tpu as jt
from totsu_tpu.parallel import solve_batch as jsolve_batch
from totsu_tpu.solver import operator as jop
import totsu_tpu_torch as tt
from totsu_tpu_torch import interop
from totsu_tpu_torch.parallel import solve_batch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "benchmarks"))

#: the seven forms of tests/test_torch_batch_structured.py
FORMS = ("ell", "vstack", "hstack", "block", "scaled", "custom", "sparse")

N, TILE, LANES = 16, 4, 3

#: x and y of a lane against the JAX package's, f64
XTOL = 1e-8

#: per engine: the parameters, and the lanes' statuses they give (lane 0
#: stops at its cap on either engine, the others converge)
ENGINES = {
    "pdhg": (dict(max_iter=1000, eps_acc=1e-6, accel="halpern",
                  normalize=True, check_period=10), [2, 1, 1]),
    "direct": (dict(max_iter=400, eps_acc=1e-6, accel="halpern",
                    check_period=10, method="direct"), [2, 1, 1]),
}


def box_lp():
    """(C (B, n), A (B, 3n, n), B (B, 3n)) in f64, one lane per seed."""
    from benchmark_indirect import make_banded_box_lp
    lanes = [make_banded_box_lp(N, tile=TILE, seed=s) for s in range(LANES)]
    return tuple(np.stack([lp[j] for lp in lanes]).astype(np.float64)
                 for j in range(3))


def _matvec(p, x):
    """The CustomOp form's shared matvec (one function object for every
    lane, as JAX's static field requires)."""
    return p @ x


def _jax_lane(form, a, i):
    """Lane i's JAX operator of the dense (3n, n) ``a``."""
    n = a.shape[1]
    h = n // 2

    def ell(x):
        return jop.BlockedEllOp.from_dense(x, block=(TILE, TILE))

    def dense(x):
        return jop.DenseOp(jnp.asarray(x))

    if form == "ell":
        return ell(a)
    if form == "vstack":
        return jop.VStackOp((ell(a[:n]), jop.DiagOp(jnp.diag(a[n:2 * n])),
                             jop.DiagOp(jnp.diag(a[2 * n:]))))
    if form == "hstack":
        return jop.HStackOp((dense(a[:, :h]), dense(a[:, h:])))
    if form == "block":
        one = jop.DiagOp(jnp.ones(h))
        neg = jop.DiagOp(-jnp.ones(h))
        zero = jop.ZeroOp(h, h)
        return jop.BlockOp([[dense(a[:n, :h]), dense(a[:n, h:])],
                            [one, zero], [zero, one], [neg, zero],
                            [zero, neg]])
    if form == "scaled":
        alpha = 2.0 ** (i - 1)
        return jop.ScaledOp(jnp.asarray(alpha), ell(a / alpha))
    raise ValueError(form)


def jax_batch(form, a_stack):
    """The JAX package's batch-leading operator of ``a_stack`` (B, m, n):
    ``tree_map(jnp.stack)`` of the lanes, a ``CustomOp`` with lane-leading
    params, a ``SparseOp`` on a BCOO batched with ``n_batch=1``."""
    from jax.experimental import sparse
    m, n = a_stack.shape[1:]
    if form == "custom":
        return jop.CustomOp(params=jnp.asarray(a_stack), m=m, n=n,
                            matvec_fn=jnp.matmul)
    if form == "sparse":
        return jop.SparseOp(sparse.BCOO.fromdense(jnp.asarray(a_stack),
                                                  n_batch=1))
    lanes = [_jax_lane(form, a, i) for i, a in enumerate(a_stack)]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *lanes)


def port_lanes(form, a_stack):
    """The port's single operators of the lanes (CPU)."""
    if form == "custom":
        m, n = a_stack.shape[1:]
        return [tt.CustomOp(params=torch.tensor(a), m=m, n=n,
                            matvec_fn=_matvec) for a in a_stack]
    if form == "sparse":
        return [tt.SparseOp.from_dense(torch.tensor(a))
                for a in a_stack]
    return [interop.operator_from_reference(_jax_lane(form, a, i),
                                            device="cpu")
            for i, a in enumerate(a_stack)]


def port_batch(form, a_stack, jbatch=None):
    """The port's batch: ``operator_from_reference(..., batch=B)`` of the
    JAX pytree (built here when ``jbatch`` is None), or ``BatchedOp.stack``
    of torch ``CustomOp`` s for the custom form (JAX functions do not
    cross)."""
    if form == "custom":
        return tt.BatchedOp.stack(port_lanes(form, a_stack))
    if jbatch is None:
        jbatch = jax_batch(form, a_stack)
    return interop.operator_from_reference(jbatch, device="cpu",
                                           batch=a_stack.shape[0])


def run_both(form, pkw, **kw):
    """(JAX result, port result, the port's arguments) of the three lanes
    in ``form``."""
    c, a, b = box_lp()
    jbatch = jax_batch(form, a)
    lay = jt.ConeLayout([jt.rpos(a.shape[1])])
    pj = jt.SolverParam(**pkw)
    rj = jsolve_batch(jnp.asarray(c), jbatch, jnp.asarray(b), lay, pj, **kw)
    targs = (torch.tensor(c), port_batch(form, a, jbatch), torch.tensor(b),
             interop.cone_from_reference(lay))
    rt = solve_batch(*targs, interop.param_from_reference(pj), **kw)
    return rj, rt, targs


def assert_lanes_match(rj, rt):
    """Each lane's status and iteration count equal, x and y within
    :data:`XTOL`."""
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=XTOL,
                               rtol=0)
    np.testing.assert_allclose(rt.y.numpy(), np.asarray(rj.y), atol=XTOL,
                               rtol=0)
