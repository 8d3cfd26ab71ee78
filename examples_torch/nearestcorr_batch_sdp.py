"""Batch of nearest-correlation-matrix SDPs solved in lockstep (port of
``examples/nearestcorr_batch_sdp.py``).

For each noisy covariance estimate S_i, find the nearest correlation
matrix: minimize ||X - S_i||_F subject to diag(X) = 1 and X >= 0 (PSD),
the classic SDP of risk-model cleanup. The batch runs in lockstep
(``solve_batch``), and every lane's PSD block goes through one launch of
the Jacobi kernel per projection on the card (``psd(k,
method='jacobi')``): many small PSD blocks per iteration.

Conic form over variables u = (x [sn], t [1]), sn = k(k+1)/2 packed
scaled-vec entries of X:

    minimize    t
    subject to  (t, x - vec(S_i))  in SOC^{1+sn}   (epigraph of the F-norm)
                x                  in vec(PSD_k)
                diag entries of x  == 1            (zero cone)

Only b depends on S_i: A is built once and shared by every lane (an
expanded view). Self-checks: unit diagonal, eigenvalue floor, objective
== ||X - S||_F.

    python examples_torch/nearestcorr_batch_sdp.py [--cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from examples_torch._common import setup, report


def make_noisy_covs(batch, k, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batch):
        f = rng.normal(size=(k, 3)) / np.sqrt(3)
        s = f @ f.T + 0.3 * np.diag(rng.random(k))
        d = 1.0 / np.sqrt(np.diag(s))
        corr = d[:, None] * s * d[None, :]
        # perturb off the cone: symmetric noise, possibly indefinite
        e = rng.normal(size=(k, k)) * 0.15
        out.append(corr + (e + e.T) / 2)
    return np.stack(out)


def build(k, dtype, device=None):
    """Static problem pieces: (A, c, cone layout, packed diag positions,
    sn), A and c tensors on ``device`` (else the CUDA card)."""
    import torch
    import totsu_tpu_torch as tt
    from totsu_tpu_torch.ops import sympack
    from totsu_tpu_torch.solver.operator import target_device

    sn = sympack.tri_len(k)
    n = sn + 1  # x (packed X) + t
    # rows: SOC (1 + sn) | PSD (sn) | zero (k)
    m = (1 + sn) + sn + k
    a = np.zeros((m, n))
    # SOC: s0 = t  -> A[0, t] = -1 ; s1.. = x - vecS -> A = -I, b = -vecS
    a[0, sn] = -1.0
    a[1:1 + sn, :sn] = -np.eye(sn)
    # PSD: s = x -> A = -I, b = 0
    a[1 + sn:1 + 2 * sn, :sn] = -np.eye(sn)
    # zero cone: diag(X) = 1. Packed position of (j, j) is j(j+1)/2 + j.
    diag_pos = np.array([j * (j + 1) // 2 + j for j in range(k)])
    for r, p in enumerate(diag_pos):
        a[1 + 2 * sn + r, p] = 1.0
    layout = tt.ConeLayout([
        tt.soc(1 + sn),
        tt.psd(k, method="jacobi"),
        tt.zero(k),
    ])
    c = np.zeros(n)
    c[sn] = 1.0  # minimize t
    dev = target_device(device)
    return (torch.tensor(a, dtype=dtype, device=dev),
            torch.tensor(c, dtype=dtype, device=dev), layout, diag_pos, sn)


def lane_b(s_mat, k, sn, dtype, device):
    """One lane's b from its covariance S: (0, -vec(S), 0, 1)."""
    import torch
    from totsu_tpu_torch.ops import sympack
    vec_s = sympack.pack(torch.tensor(s_mat, dtype=dtype, device=device),
                         scaled=True)
    return torch.cat([torch.zeros(1, dtype=dtype, device=device), -vec_s,
                      torch.zeros(sn, dtype=dtype, device=device),
                      torch.ones(k, dtype=dtype, device=device)])


def self_checks(res, covs, k, sn, eps_acc):
    """The example's checks on every lane; returns (diag_err, eig_min,
    mean ||X - S||_F)."""
    import torch
    from totsu_tpu_torch.ops import sympack
    xs = res.x.double().cpu()
    x_mats = sympack.unpack(xs[:, :sn], k, scaled=True).numpy()
    tol = 50 * eps_acc
    diag_err = np.abs(np.diagonal(x_mats, axis1=1, axis2=2) - 1.0).max()
    eig_min = np.linalg.eigvalsh(x_mats).min()
    fro = np.linalg.norm(x_mats - covs, axis=(1, 2))
    t_err = np.abs(xs[:, sn].numpy() - fro).max()
    assert torch.all(res.status == 1), res.status
    assert diag_err < tol, diag_err
    assert eig_min > -tol, eig_min
    assert t_err < tol * 10, t_err
    return diag_err, eig_min, float(fro.mean())


def main(batch=16, k=8, cpu=None):
    device, dtype, backend = setup(cpu)
    import torch
    import totsu_tpu_torch as tt
    from totsu_tpu_torch.utils import set_par_by_env

    covs = make_noisy_covs(batch, k)
    a, c, layout, diag_pos, sn = build(k, dtype, device)
    param = set_par_by_env(
        tt.SolverParam(max_iter=400_000, eps_acc=1e-4, check_period=25))
    # the per-lane build on the host side, then one lockstep solve
    bb = torch.stack([lane_b(s, k, sn, dtype, device) for s in covs])
    t0 = time.time()
    res = tt.solve_batch(c.expand(batch, -1), a.expand(batch, -1, -1), bb,
                         layout, param)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_solve = time.time() - t0

    diag_err, eig_min, fro_mean = self_checks(res, covs, k, sn,
                                              param.eps_acc)
    lane0 = tt.SolveResult(
        x=res.x[0], y=res.y[0], status=int(res.status[0]),
        iters=int(res.iters[0]), cri_pri=res.cri_pri[0],
        cri_dual=res.cri_dual[0], cri_gap=res.cri_gap[0],
        cri_unbdd=res.cri_unbdd[0], cri_infeas=res.cri_infeas[0])
    status = report(f"nearestcorr_batch_sdp b={batch} k={k}", lane0,
                    t_solve, extra=(f"diag_err={diag_err:.1e} "
                                    f"eig_min={eig_min:.1e} "
                                    f"mean||X-S||={fro_mean:.3f}"))
    assert status == "CONVERGED"
    return res


if __name__ == "__main__":
    main()
