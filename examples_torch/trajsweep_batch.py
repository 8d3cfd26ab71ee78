"""Parameter sweep solved in lockstep: trajectory QCQPs for a range of
acceleration caps, one batched solve (port of
``examples/trajsweep_batch.py``).

The JAX package builds and solves every cap in one jitted, vmapped
program; here each cap's QCQP is built on the host (the ``qcqp``
reduction, which only moves b with the cap), then the sweep is one
``solve_batch``.

    python examples_torch/trajsweep_batch.py [--cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from examples_torch._common import setup
from examples_torch.trajplan_qcqp import build


def sweep_problems(caps, t_cap, dtype):
    """One conic problem per acceleration cap, built on the host in
    ``dtype``, and the data the objective needs."""
    import torch
    from totsu_tpu_torch.problems import qcqp
    p_mats, q_vecs, r_base, a, b, t_cap, _ = build(t_cap, 1.0)
    probs = []
    for cap in caps:
        # r_i = -cap^2/2 for the acceleration constraints (index >= 1)
        r = np.asarray(r_base, dtype=np.float64).copy()
        r[1:] = -0.5 * cap * cap
        probs.append(qcqp(*(torch.tensor(v, dtype=dtype)
                            for v in (p_mats, q_vecs, r, a, b))))
    return probs, p_mats, t_cap


def main(t_cap=12, caps=(140.0, 170.0, 200.0, 300.0), cpu=None):
    device, dtype, backend = setup(cpu)
    import torch
    import totsu_tpu_torch as tt
    from totsu_tpu_torch.utils import set_par_by_env

    param = set_par_by_env(
        tt.SolverParam(max_iter=600_000, eps_acc=1e-3, equil_iters=10))
    probs, p_mats, t_cap = sweep_problems(caps, t_cap, dtype)

    def stack(get):
        return torch.stack([get(p) for p in probs]).to(device)

    t0 = time.time()
    res = tt.solve_batch(stack(lambda p: p.c), stack(lambda p: p.a.a),
                         stack(lambda p: p.b), probs[0].cone, param)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_solve = time.time() - t0

    n = 2 * t_cap
    objs = []
    xs = res.x.double().cpu().numpy()
    for i, cap in enumerate(caps):
        sol = xs[i, :n]
        objs.append(float(0.5 * sol @ p_mats[0] @ sol))
        status = int(res.status[i])
        assert status == tt.SolverStatus.CONVERGED, (cap, status)
    # tighter acceleration budget => higher velocity objective
    assert all(objs[i] >= objs[i + 1] - 1e-3
               for i in range(len(objs) - 1)), objs
    print(f"[trajsweep_batch] backend={backend} {len(objs)} caps in lockstep "
          f"{t_solve:.2f}s iters={res.iters.tolist()} objs=" +
          ",".join(f"{o:.1f}" for o in objs))
    return objs


if __name__ == "__main__":
    main()
