"""Receding-horizon MPC fleet through the serving BatchRunner (port of
``examples/mpc_qp.py``).

A fleet of double-integrator vehicles is steered to per-vehicle targets
by solving, at every control tick, one QP per vehicle, all of them in one
lockstep batch through ``runtime.BatchRunner``, warm-started from the
previous tick's solutions (``map(..., warm_starts=...)``). Across ticks
the problems change only through the current state (the QP's linear
term), so the previous optimum seeds the next solve; the example pins
``method='direct'``, where warm starts pay (plain-pdhg warm starts are a
wash on shifting problems).

Per vehicle, with horizon H and time step dt, the controls u_0..u_{H-1}
(2-D thrust each) determine the terminal position affinely,

    p_H = p + H dt v + sum_k G_k u_k,     G_k = (H - k - 0.5) dt^2 I,

and the tick's QP is

    minimize    || p_H - target ||^2 + lam * sum ||u_k||^2
    subject to  |u_k,i| <= u_max            (box rows, R+ cone),

a dense-P QP through ``problems.qp``, built per vehicle on the host. The
first control is applied, the state advances (with a small seeded
disturbance), and the loop repeats.

    python examples_torch/mpc_qp.py [--cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from examples_torch._common import setup


def build_tick_qp(state, target, h_horizon, dt, lam, u_max):
    """QP data for one vehicle at its current state; P, G and h do not
    depend on the state (one signature for the whole run)."""
    p0, v0 = state[:2], state[2:]
    n = 2 * h_horizon
    w_v = 0.6        # terminal-velocity weight (arrive AND stop)
    # terminal state [p_H; w_v v_H] = base + M u   (M: 4 x n)
    base = np.concatenate([p0 + h_horizon * dt * v0, w_v * v0])
    m_mat = np.zeros((4, n))
    for k in range(h_horizon):
        m_mat[0, 2 * k] = m_mat[1, 2 * k + 1] = (h_horizon - k - 0.5) * dt**2
        m_mat[2, 2 * k] = m_mat[3, 2 * k + 1] = w_v * dt
    resid0 = base - np.concatenate([target, np.zeros(2)])
    p_mat = 2.0 * (m_mat.T @ m_mat + lam * np.eye(n))
    q = 2.0 * m_mat.T @ resid0
    g = np.concatenate([np.eye(n), -np.eye(n)])
    h = np.full(2 * n, u_max)
    return p_mat, q, g, h, m_mat


def tick_problem(state, target, h_horizon, dt, lam, u_max, dtype):
    """One vehicle's tick QP in conic form, built on the host in
    ``dtype``; the runner moves the batch to its device."""
    import torch
    from totsu_tpu_torch.problems import qp
    p_mat, q, g, h, _ = build_tick_qp(state, target, h_horizon, dt, lam,
                                      u_max)
    return qp(*(torch.tensor(v, dtype=dtype) for v in (p_mat, q, g, h)))


def fleet(n_vehicles, seed):
    """The fleet's initial states (positions, velocities) and targets."""
    rng = np.random.default_rng(seed)
    states = np.concatenate(
        [rng.normal(scale=2.0, size=(n_vehicles, 2)),     # positions
         rng.normal(scale=0.5, size=(n_vehicles, 2))], 1)  # velocities
    targets = rng.normal(scale=3.0, size=(n_vehicles, 2))
    return rng, states, targets


def tick_param():
    """The fleet's solver settings: the direct (Douglas-Rachford) engine
    with Halpern, which both needs about 10x fewer iterations on these
    dense QPs than pdhg and profits from warm starts."""
    import totsu_tpu_torch as tt
    return tt.SolverParam(max_iter=100_000, eps_acc=1e-5, check_period=10,
                          method="direct", accel="halpern")


def main(n_vehicles=6, h_horizon=8, ticks=18, dt=0.25, lam=1e-2,
         u_max=4.0, seed=3, use_warm=True, cpu=None):
    device, dtype, backend = setup(cpu)
    from totsu_tpu_torch.runtime import BatchRunner

    rng, states, targets = fleet(n_vehicles, seed)
    runner = BatchRunner(tick_param(), device=device)
    warm = None
    iters_per_tick = []
    t0 = time.perf_counter()
    for tick in range(ticks):
        probs = [tick_problem(states[i], targets[i], h_horizon, dt, lam,
                              u_max, dtype) for i in range(n_vehicles)]
        results = runner.map(probs, warm_starts=warm)
        assert all(r.status == 1 for r in results), \
            [r.status for r in results]
        iters_per_tick.append(max(r.iters for r in results))
        # apply the first control, advance the dynamics (+ a small
        # disturbance)
        for i, r in enumerate(results):
            u0 = r.x[:2].double().cpu().numpy()
            states[i, :2] += dt * states[i, 2:] + 0.5 * dt**2 * u0
            states[i, 2:] += dt * u0 + rng.normal(scale=0.01, size=2)
        # the next tick warm-starts from this tick's full solutions
        if use_warm:
            warm = [(r.x, r.y) for r in results]
    wall = time.perf_counter() - t0

    final_dist = np.linalg.norm(states[:, :2] - targets, axis=1)
    cold, warm_mean = iters_per_tick[0], float(np.mean(iters_per_tick[1:]))
    print(f"[mpc_qp] {n_vehicles} vehicles x {ticks} ticks "
          f"(H={h_horizon}, warm={use_warm}) in {wall:.2f}s "
          f"backend={backend}; iters: tick0 {cold}, later mean "
          f"{warm_mean:.0f}; max final dist {final_dist.max():.3f}")
    # the fleet must actually arrive
    assert final_dist.max() < 0.5, final_dist
    return iters_per_tick


if __name__ == "__main__":
    main()
