"""The paths of a structured batch besides its plain solve, in the PyTorch
port against the JAX package (``tests/test_torch_batch_structured.py``
holds the forms): chunked solves on both engines, Ruiz, the fast
profile, the megakernel's refusal, a lane-less operator, a 1-rank
``batch`` mesh and the structured partitioning SDP on 'jacobi'. In f64
on the CPU each lane's status and iteration count equal the JAX
package's, x within 1e-8; a chunked or meshed run is bitwise the port's
whole run."""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
from totsu_tpu.parallel import solve_batch as jsolve_batch
import totsu_tpu_torch as tt
from totsu_tpu_torch import interop
from totsu_tpu_torch.parallel import solve_batch
from torch_structured import (ENGINES, assert_lanes_match, box_lp,
                              port_batch, run_both)
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "benchmarks"))

#: the fields of two SolveResults that must agree bit for bit
FIELDS = ("x", "y", "status", "iters", "cri_pri", "cri_dual", "cri_gap",
          "cri_unbdd", "cri_infeas")


def _ell():
    """The port's arguments of the BlockedEllOp batch."""
    c, a, b = box_lp()
    return (torch.tensor(c), port_batch("ell", a), torch.tensor(b),
            tt.ConeLayout([tt.rpos(a.shape[1])]))


def _both(pkw, **kw):
    return run_both("ell", pkw, **kw)


def assert_bitwise(r1, r2):
    for name in FIELDS:
        assert torch.equal(getattr(r1, name), getattr(r2, name)), name


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_chunked_matches_jax_and_the_whole_batch(engine):
    """chunk_iters=100: every lane as JAX's chunked batch, and bit for bit
    the port's whole batch (the indirect engine's CG warm start and the
    Halpern epoch cross each chunk in the checkpoint)."""
    pkw, statuses = ENGINES[engine]
    rj, rt, targs = _both(pkw, chunk_iters=100)
    assert rt.status.tolist() == statuses
    assert_lanes_match(rj, rt)
    whole = solve_batch(*targs, tt.SolverParam(**pkw))
    assert_bitwise(rt, whole)


def test_ruiz_on_blocked_ell():
    """equil_iters=10: Ruiz scales each lane's tiles on its own
    (``BatchedOp.diag_scale``), as JAX's vmapped ``ruiz_equilibrate_op``
    does."""
    pkw = dict(ENGINES["pdhg"][0], equil_iters=10, max_iter=3000)
    rj, rt, _ = _both(pkw)
    assert_lanes_match(rj, rt)
    assert (rt.status == 1).any()


def test_fast_profile_resolves_as_jax():
    """profile='fast' resolves on lane 0's operator, as inside jax.vmap: a
    structured A goes to the indirect engine with Halpern."""
    rj, rt, _ = _both(dict(profile="fast", max_iter=2000, eps_acc=1e-6))
    assert_lanes_match(rj, rt)
    assert "cg_worst_rel" in rt.diag and (rt.status == 1).all()


def test_megakernel_refuses_and_auto_keeps_the_loop():
    """kernel='mega' needs a dense f32 A: a structured batch raises, as
    the single solve does; 'auto' keeps the lockstep loop."""
    c, a, b, lay = _ell()
    f32 = (c.float(), a.astype(torch.float32), b.float(), lay)
    with pytest.raises(ValueError, match="kernel='mega' requires a dense"):
        solve_batch(*f32, tt.SolverParam(kernel="mega", max_iter=100))
    res = solve_batch(*f32, tt.SolverParam(kernel="auto", max_iter=100))
    assert res.diag["route"] == "loop" and (res.iters == 100).all()


def test_lane_less_operator_raises():
    """A structured operator without a lane axis is no batch: ValueError
    naming BatchedOp.stack (JAX's vmap refuses the leaf the same way);
    so do BatchedOp(op, B) on tensors without the lane axis and a stack
    of lanes whose SparseOp sits inside a stack."""
    c, a, b = box_lp()
    lay = tt.ConeLayout([tt.rpos(a.shape[1])])
    ell = tt.BlockedEllOp.from_dense(a[0], block=(4, 4), device="cpu")
    with pytest.raises(ValueError, match=r"BatchedOp\.stack"):
        solve_batch(torch.tensor(c), ell, torch.tensor(b), lay)
    with pytest.raises(ValueError, match="leading lane axis of 3"):
        tt.BatchedOp(ell, 3)
    d = tt.DiagOp(torch.ones(2, dtype=torch.float64))
    sp = tt.SparseOp.from_dense(torch.eye(2, dtype=torch.float64))
    inner = tt.VStackOp((sp, d))
    with pytest.raises(ValueError, match="SparseOp inside a stack"):
        tt.BatchedOp.stack([inner, inner])


def test_one_rank_batch_mesh_is_the_whole_batch():
    """solve_batch(mesh=) on a 1-rank gloo mesh: the rank's lanes through
    BatchedOp.lanes, bit for bit the whole batch on both engines; a
    shard_batch of a BatchedOp is its lanes."""
    import torch.distributed as dist
    from totsu_tpu_torch import parallel
    targs = _ell()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = parallel.make_mesh(devices="cpu")
        (part,) = parallel.shard_batch((targs[1],), mesh)
        assert part.batch == 3 and torch.equal(part.lane(2).blocks,
                                               targs[1].lane(2).blocks)
        for engine in sorted(ENGINES):
            p = tt.SolverParam(**ENGINES[engine][0])
            assert_bitwise(solve_batch(*targs, p, mesh=mesh),
                           solve_batch(*targs, p))
    finally:
        dist.destroy_process_group()


def test_row_sharding_refuses_a_structured_batch(monkeypatch):
    """A mesh whose row axis is above 1 splits the rows of a dense batch
    only: a structured one raises ValueError (the JAX package shards a
    batch over its batch axis alone). The mesh's sizes are stubbed: a
    row axis of 2 needs two ranks."""
    from totsu_tpu_torch.parallel import batch as pbatch
    monkeypatch.setattr(pbatch, "axis_size",
                        lambda mesh, axis: 2 if axis == "row" else 1)
    with pytest.raises(ValueError, match="batch axis only"):
        solve_batch(*_ell(), tt.SolverParam(max_iter=10), mesh=object())


def test_structured_partitioning_sdp_on_jacobi():
    """Three structured partitioning SDPs at k = 4 (benchmark_sdp.py's
    VStackOp((DiagOp, DenseOp)), the lanes differing in c only) on psd
    'jacobi' (kernel J's plain version here): each lane as JAX's."""
    from benchmark_sdp import build_partitioning
    k = 4
    lanes = [build_partitioning(k, seed=10_000 + i) for i in range(3)]
    c = np.stack([np.asarray(lp[0], np.float64) for lp in lanes])
    b = np.stack([np.asarray(lp[2], np.float64) for lp in lanes])
    jop = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs).astype(jnp.float64),
        *[lp[1] for lp in lanes])
    lay = jt.ConeLayout([jt.psd(k, method="jacobi"), jt.zero(k)])
    pj = jt.SolverParam(max_iter=5000, eps_acc=1e-6, check_period=10)
    rj = jsolve_batch(jnp.asarray(c), jop, jnp.asarray(b), lay, pj)
    top = interop.operator_from_reference(jop, device="cpu", batch=3)
    assert isinstance(top, tt.BatchedOp)
    rt = solve_batch(torch.tensor(c), top, torch.tensor(b),
                     interop.cone_from_reference(lay),
                     interop.param_from_reference(pj))
    assert (rt.status == 1).all()
    assert_lanes_match(rj, rt)
    # a lane is its own single solve (lane 1, the shortest)
    one = tt.solve_jit(torch.tensor(c[1]), top.lane(1), torch.tensor(b[1]),
                       interop.cone_from_reference(lay),
                       interop.param_from_reference(pj))
    assert one.iters == int(rt.iters[1])
