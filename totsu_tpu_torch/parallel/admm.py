"""Consensus ADMM over conic agents (port of ``totsu_tpu.parallel.admm``).

Solves the global consensus program

    minimize    sum_i c_i^T x
    subject to  A_i x + s_i = b_i,  s_i in K   (for every agent i)

by splitting into per-agent local variables x_i coupled through a
consensus variable z (Boyd et al., Distributed Optimization via ADMM,
ch. 7):

    x_i <- argmin  c_i^T x + (rho/2) ||x - (z - u_i)||^2   s.t. agent i's cone
    z   <- mean_i (x_i + u_i)
    u_i <- u_i + x_i - z

Each x-update is a strongly convex QP in conic form (the ``qp``
embedding with P = rho I, whose square root is sqrt(rho) I), solved for
every agent in one lockstep batch (:func:`solve_batch`), warm-started
from the previous round's primal solution. The JAX package runs
``rounds_per_sync`` rounds as one jitted ``lax.scan``; here they are a
host loop whose residuals and statuses stay on the device and reach the
host in one read per ``rounds_per_sync`` rounds.

With a mesh, each rank runs the subsolves of its share of the agents
(its place on the ``batch`` axis). The z-update's sum over agents is one
all_reduce per round; each agent's residual and status stay on its rank
until the sync, where one gather brings every round's of them.
"""

import dataclasses
import warnings
from typing import Any, Optional

import numpy as np
import torch

from totsu_tpu_torch.parallel import _collectives as coll
from totsu_tpu_torch.parallel.batch import shard_batch
from totsu_tpu_torch.parallel.sharded import even_split
from totsu_tpu_torch.solver import cone as cones
from totsu_tpu_torch.solver.batched import solve_batch_jit
from totsu_tpu_torch.solver.cone import ConeLayout
from totsu_tpu_torch.solver.operator import as_data
from totsu_tpu_torch.solver.params import SolverParam, SolverStatus


@dataclasses.dataclass
class AdmmResult:
    z: Any                 # consensus solution (n,), numpy
    x: Any                 # per-agent solutions (N, n), numpy
    outer_iters: int
    pri_res: float         # max_i ||x_i - z||
    dual_res: float        # rho * ||z - z_prev||
    converged: bool
    #: per-agent statuses of the final outer round only; earlier rounds'
    #: health is summarized by rounds_with_unconverged_subsolves (and the
    #: warning quotes the last bad round's statuses)
    subproblem_statuses: Any
    #: outer rounds in which at least one agent's subsolve did not converge
    rounds_with_unconverged_subsolves: int = 0


def consensus_admm(
    c_batch,
    a_batch,
    b_batch,
    cone: ConeLayout,
    rho: float = 1.0,
    max_outer: int = 200,
    tol: float = 1e-4,
    param: Optional[SolverParam] = None,
    mesh=None,
    verbose: bool = False,
    adapt_rho: bool = True,
    strict_subsolves: bool = False,
    rounds_per_sync: int = 1,
    *,
    device=None,
) -> AdmmResult:
    """Run consensus ADMM.

    * ``c_batch``: (N, n) per-agent linear costs
    * ``a_batch``: (N, m, n) per-agent constraint blocks (same shape)
    * ``b_batch``: (N, m); ``cone`` shared across agents. Data that is not
      a tensor goes to ``device``, else to the CUDA card.
    * ``mesh``: ``parallel.make_mesh``; its ``batch`` axis shards the
      agents (N must split evenly over it). Every rank passes every
      agent's data; the result is whole on every rank.
    * ``strict_subsolves``: every sync checks the agents' subsolve
      statuses. ``False`` warns once and counts offending rounds in
      ``AdmmResult.rounds_with_unconverged_subsolves``; ``True`` raises
      ``RuntimeError`` at the sync where they surface.
    * ``rounds_per_sync``: outer rounds run between host reads of the
      residuals and statuses. Convergence is detected, and rho adapted
      (residual balancing, the one host-side step), once per such chunk,
      so up to ``rounds_per_sync - 1`` extra rounds may run past the
      tolerance.
    """
    a_batch = as_data(a_batch, device, "a_batch")
    dev = a_batch.device
    c_batch = as_data(c_batch, dev, "c_batch")
    b_batch = as_data(b_batch, dev, "b_batch")
    n_agents, n = c_batch.shape
    if mesh is not None:
        first = even_split(mesh, "batch", n_agents, "agents")[
            mesh.get_local_rank("batch")]
        group = mesh.get_group("batch")
        c_batch, a_batch, b_batch = shard_batch((c_batch, a_batch, b_batch),
                                                mesh)

    def whole(t, dim=-1):
        """Every agent's ``t`` from this rank's agents along ``dim``."""
        if mesh is None:
            return t
        return coll.gather(t, first, n_agents, group, dim)

    def agent_mean(t):
        if mesh is None:
            return torch.mean(t, dim=0)
        return coll.reduce_sum(t.sum(dim=0), group) / n_agents

    lanes = c_batch.shape[0]
    m = b_batch.shape[1]
    dtype = c_batch.dtype
    a_batch = a_batch.to(dtype)
    b_batch = b_batch.to(dtype)
    if param is None:
        param = SolverParam(max_iter=20_000, eps_acc=1e-6, check_period=10)

    # subproblem cone: rotated-SOC epigraph block + the agent's own cone
    sub_cone = ConeLayout((cones.rsoc(2 + n),) + tuple(cone.factors))
    eye = torch.eye(n, dtype=dtype, device=dev)
    # the rows that do not move between rounds: 0 | ... | A_i 0
    conic_a = torch.zeros(lanes, 2 + n + m, n + 1, dtype=dtype,
                          device=dev)
    conic_a[:, 1, n] = -1.0
    conic_a[:, 2 + n:, :n] = a_batch
    conic_b = torch.cat([
        torch.ones(lanes, 1, dtype=dtype, device=dev),
        torch.zeros(lanes, 1 + n, dtype=dtype, device=dev), b_batch],
        dim=1)
    conic_c = torch.zeros(lanes, n + 1, dtype=dtype, device=dev)
    conic_c[:, n] = 1.0

    def solve_agents(v, ws_x, rho_t):
        """Every agent's x-update (the qp embedding with P^(1/2) =
        sqrt(rho) I and q = c_i - rho v_i; the constant of ||x - v_i||^2
        does not move the argmin), warm-started from the primal seed
        only: an (x, y) seed is pathological on this subproblem class
        (the JAX package measured 1570 subsolve iterations against 200)."""
        a_r = conic_a.clone()
        a_r[:, 1, :n] = c_batch - rho_t * v
        a_r[:, 2:2 + n, :n] = -torch.sqrt(rho_t) * eye
        return solve_batch_jit(conic_c, a_r, conic_b, sub_cone, param,
                               warm_start=(ws_x, None))

    # over-relaxation (Boyd et al. sec. 3.4.3): x_hat = alpha x + (1 -
    # alpha) z_old in the z/u updates, which damps the slow primal/dual
    # oscillation consensus ADMM shows on LPs
    alpha = 1.6

    def one_round(z, u, ws_x, rho_t):
        v = z[None, :] - u
        res = solve_agents(v, ws_x, rho_t)
        x = res.x[:, :n]
        x_hat = alpha * x + (1.0 - alpha) * z[None, :]
        z_new = agent_mean(x_hat + u)
        u_new = u + x_hat - z_new[None, :]
        # each agent's primal residual; their maximum is taken at the sync
        pri = torch.linalg.vector_norm(x - z_new[None, :], dim=1)
        dual = rho_t * torch.linalg.vector_norm(z_new - z)
        return z_new, u_new, res.x, (pri, dual, res.status)

    rps = max(1, int(rounds_per_sync))
    z = torch.zeros(n, dtype=dtype, device=dev)
    u = torch.zeros(lanes, n, dtype=dtype, device=dev)
    ws_x = torch.zeros(lanes, n + 1, dtype=dtype, device=dev)
    statuses = None
    pri = dual = np.inf
    k = 0
    rho_t = torch.tensor(float(rho), dtype=dtype, device=dev)
    bad_rounds = 0
    while k < max_outer:
        rps_i = min(rps, max_outer - k)
        outs = []
        for _ in range(rps_i):
            z, u, ws_x, out = one_round(z, u, ws_x, rho_t)
            outs.append(out)
        k += rps_i
        # one host read per chunk: every round's residuals and statuses
        # together (with a mesh, every agent's, in one gather)
        per_agent = whole(torch.stack([
            torch.stack([o[0] for o in outs]),
            torch.stack([o[2] for o in outs]).to(dtype)]))
        pris = per_agent[0].amax(dim=1).tolist()
        duals = torch.stack([o[1] for o in outs]).tolist()
        stat_all = per_agent[1].cpu().numpy().astype(np.int32)
        pri, dual = float(pris[-1]), float(duals[-1])
        nbads = np.count_nonzero(stat_all != SolverStatus.CONVERGED, axis=1)
        statuses = stat_all[-1]
        chunk_bad = int(np.count_nonzero(nbads))
        if chunk_bad:
            bad_rounds += chunk_bad
            bad_idx = np.nonzero(nbads)[0]
            n_bad = int(nbads[bad_idx[-1]])
            bad_stats = sorted(set(stat_all[bad_idx[-1]].tolist()))
            msg = (f"consensus_admm rounds {k - rps_i + 1}..{k}: agent "
                   f"subsolves did not converge in {chunk_bad} round(s) "
                   f"(last bad round: {n_bad}/{n_agents}, its statuses "
                   f"{bad_stats}); the "
                   "x-update is biased. Raise param.max_iter or loosen "
                   "param.eps_acc.")
            if strict_subsolves:
                raise RuntimeError(msg)
            if bad_rounds == chunk_bad:
                warnings.warn(msg, RuntimeWarning, stacklevel=2)
        if verbose:
            print(f"[admm] outer {k}: pri={pri:.3e} dual={dual:.3e} "
                  f"rho={float(rho_t):.2g}"
                  + (f" unconverged_rounds={chunk_bad}" if chunk_bad
                     else ""))
        if pri <= tol and dual <= tol:
            break
        if adapt_rho:
            # residual balancing (Boyd et al. sec. 3.4.1); the scaled dual
            # u rescales inversely with rho (the 5x trigger, as in the JAX
            # package: 10x can stall where pri and dual oscillate)
            if pri > 5.0 * dual:
                rho_t = rho_t * 2.0
                u = u / 2.0
            elif dual > 5.0 * pri:
                rho_t = rho_t / 2.0
                u = u * 2.0

    return AdmmResult(
        z=z.cpu().numpy(), x=whole(ws_x[:, :n], dim=0).cpu().numpy(),
        outer_iters=k,
        pri_res=pri, dual_res=dual,
        converged=(pri <= tol and dual <= tol),
        subproblem_statuses=np.asarray(statuses),
        rounds_with_unconverged_subsolves=bad_rounds)
