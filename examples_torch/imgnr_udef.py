"""Image noise reduction as a user-defined matrix-free conic problem
(port of ``examples/imgnr_udef.py``).

After ref examples/imgnr_udef/src/: no problem builder, the solver gets a
custom operator (the showcase for matrix-free problems).

    minimize    z
    subject to  |(L x)_ij| <= t_ij        (elementwise, L = 3x3 Laplacian)
                sum(t) <= ratio * npixels
                0 <= x <= 1
                ||x - xh||_2 <= z         (SOC block)

The Laplacian is a 3x3 valid convolution (``conv2d``), its adjoint the
transposed convolution, and the |kernel| convolutions give the row and
column absolute sums (the closed form of the reference's
laplacian.rs:16-199).

    python examples_torch/imgnr_udef.py [--cpu] [--plot]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from examples_torch import _plot
from examples_torch._common import host, param, report, setup


def make_image(w=48, h=48, noise=0.25, seed=7):
    yy, xx = np.mgrid[0:h, 0:w]
    img = 0.5 + 0.35 * np.sin(xx / 6.0) * np.cos(yy / 5.0)
    rng = np.random.default_rng(seed)
    mask = rng.random((h, w)) < noise
    img_noisy = img.copy()
    img_noisy[mask] = rng.random(mask.sum())  # impulse noise
    return img, np.clip(img_noisy, 0.0, 1.0)


def build_operator(w, h, device, dtype):
    """The conic operator over variables u = (x [wh], z [1], t [tsz]), a
    ``CustomOp`` whose params are the 3x3 stencil."""
    import torch
    import torch.nn.functional as F
    from totsu_tpu_torch.solver.operator import CustomOp

    wh = w * h
    tsz = (w - 2) * (h - 2)
    m = 2 * tsz + 1 + 2 * wh + 1 + wh
    n = wh + 1 + tsz

    # 3x3 Laplacian stencil (ref laplacian.rs:36-38)
    c0, c1, c2 = 1.0 - 4.0 / 16.0, -2.0 / 16.0, -1.0 / 16.0
    kern = torch.tensor([[c2, c1, c2], [c1, c0, c1], [c2, c1, c2]],
                        dtype=dtype, device=device)

    def lap(k, x):  # (wh,) -> (tsz,)
        return F.conv2d(x.reshape(1, 1, h, w), k[None, None]).reshape(tsz)

    def lap_t(k, v):  # (tsz,) -> (wh,)
        return F.conv_transpose2d(v.reshape(1, 1, h - 2, w - 2),
                                  k[None, None]).reshape(wh)

    def matvec(k, u):
        x, z, t = u[:wh], u[wh:wh + 1], u[wh + 1:]
        lx = lap(k, x)
        return torch.cat([
            lx - t,            # y_lp: Lx <= t
            -lx - t,           # y_ln: -Lx <= t
            t.sum()[None],     # y_l1: sum(t) <= target
            -x,                # y_xp: x >= 0
            x,                 # y_xn: x <= 1
            -z,                # y_sz: SOC radius
            -x,                # y_sx: SOC vector
        ])

    def rmatvec(k, v):
        v_lp, v_ln = v[:tsz], v[tsz:2 * tsz]
        v_l1 = v[2 * tsz]
        v_xp = v[2 * tsz + 1:2 * tsz + 1 + wh]
        v_xn = v[2 * tsz + 1 + wh:2 * tsz + 1 + 2 * wh]
        v_sz = v[2 * tsz + 1 + 2 * wh:2 * tsz + 2 + 2 * wh]
        v_sx = v[2 * tsz + 2 + 2 * wh:]
        y_x = lap_t(k, v_lp - v_ln) - v_xp + v_xn - v_sx
        return torch.cat([y_x, -v_sz, -v_lp - v_ln + v_l1])

    ones_t = torch.ones(tsz, dtype=dtype, device=device)
    ones_x = torch.ones(wh, dtype=dtype, device=device)

    def col_abssum(k):
        tau_x = 2.0 * lap_t(k.abs(), ones_t) + 3.0  # lp+ln, xp, xn, sx
        return torch.cat([tau_x, torch.ones(1, dtype=dtype, device=device),
                          torch.full((tsz,), 3.0, dtype=dtype,
                                     device=device)])  # lp, ln, l1

    def row_abssum(k):
        lap_rows = lap(k.abs(), ones_x)
        return torch.cat([
            lap_rows + 1.0, lap_rows + 1.0,
            torch.full((1,), float(tsz), dtype=dtype, device=device),
            ones_x, ones_x, torch.ones(1, dtype=dtype, device=device),
            ones_x])

    return CustomOp(params=kern, m=m, n=n, matvec_fn=matvec,
                    rmatvec_fn=rmatvec, col_abssum_fn=col_abssum,
                    row_abssum_fn=row_abssum), wh, tsz


def main(w=48, h=48, ratio=0.01, cpu=None):
    device, dtype, backend = setup(cpu)
    import torch
    import totsu_tpu_torch as tt

    clean, noisy = make_image(w, h)
    op, wh, tsz = build_operator(w, h, device, dtype)

    def vec(x):
        return torch.as_tensor(np.asarray(x, np.float64).reshape(-1),
                               dtype=dtype, device=device)

    c = torch.zeros(op.shape[1], dtype=dtype, device=device)
    c[wh] = 1.0
    b = torch.cat([vec(np.zeros(2 * tsz)), vec([wh * ratio]),
                   vec(np.zeros(wh)), vec(np.ones(wh)), vec([0.0]),
                   -vec(noisy)])
    layout = tt.ConeLayout([tt.rpos(2 * tsz + 1 + 2 * wh), tt.soc(1 + wh)])

    t0 = time.time()
    res = tt.solve_jit(c, op, b, layout,
                       param(dtype, max_iter=200_000, eps_acc=1.0 / 256.0))
    sol = host(res.x)
    t_solve = time.time() - t0

    x_img = np.clip(sol[:wh].reshape(h, w), 0.0, 1.0)
    err_noisy = float(np.abs(clean - noisy).mean())
    err_denoised = float(np.abs(clean - x_img).mean())
    report("imgnr_udef", res, t_solve,
           f"backend={backend} {w}x{h} mean|err| noisy={err_noisy:.4f} "
           f"-> denoised={err_denoised:.4f}")
    assert err_denoised < err_noisy  # denoising actually helped

    if _plot.enabled():
        # clean / noisy / denoised triptych (the reference writes out.png)
        plt = _plot.pyplot()
        fig, axes = plt.subplots(1, 3, figsize=(9, 3))
        for ax, img, title in zip(axes, [clean, noisy, x_img],
                                  ["clean", "noisy", "denoised"]):
            ax.imshow(img, cmap="gray", vmin=0, vmax=1)
            ax.set_title(title)
            ax.axis("off")
        _plot.save(fig, "imgnr_udef.png")
    return err_denoised


if __name__ == "__main__":
    main()
