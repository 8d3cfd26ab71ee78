"""Family ``dense_lp``: upstream Totsu's random dense LP
(``experimental/benchmark_lp/src/main.rs``), made on the device from a
seed.

For size n (the configuration's ``n``):

    G  (2n, n) standard normal,  x0 (n,) standard normal,
    h = G x0 + U(0, 1) + 0.1,
    the box rows +-I with right-hand side 10,
    c  (n,) standard normal,

all float32. x0 lies strictly inside every row, and the box bounds the
objective, so every instance has an optimum. The solver's conic form is
A = [G; I; -I], b = [h; 10; 10] over R+^(4n), built by the port's LP
builder.

Each batch of lanes comes from its own ``torch.Generator``, so batch i
is the same whatever was drawn before it, and the check after the window
can make it again. A second generator, where given, draws an order of
each lane's rows and columns: a permuted LP is the same problem.

The residuals and the control are the plain reference's
(``reference/kkt.py``, ``reference/control.py``).
"""

import torch

from h100bench.reference import control as _control
from h100bench.reference import kkt as _kkt

BOX = 10.0


def dims(config):
    """(rows, columns) of the program's A."""
    n = int(config["n"])
    return 4 * n, n


def make(config, lanes: int, gen_seed: int, device, perm_seed=None):
    """(G (lanes, 2n, n), h (lanes, 2n), c (lanes, n)), float32, drawn on
    ``device`` from one generator seeded with ``gen_seed``; with
    ``perm_seed``, each lane's rows and columns in an order drawn from a
    generator seeded with it."""
    n = int(config["n"])
    gen = torch.Generator(device=device)
    gen.manual_seed(gen_seed)
    m = 2 * n
    g = torch.randn(lanes, m, n, generator=gen, device=device)
    x0 = torch.randn(lanes, n, 1, generator=gen, device=device)
    slack = torch.rand(lanes, m, generator=gen, device=device) + 0.1
    h = torch.bmm(g, x0).squeeze(-1) + slack
    c = torch.randn(lanes, n, generator=gen, device=device)
    if perm_seed is None:
        return g, h, c
    gen.manual_seed(perm_seed)
    rows = torch.argsort(torch.rand(lanes, m, generator=gen, device=device),
                         dim=1)
    cols = torch.argsort(torch.rand(lanes, n, generator=gen, device=device),
                         dim=1)
    g = torch.gather(g, 1, rows.unsqueeze(-1).expand(lanes, m, n))
    g = torch.gather(g, 2, cols.unsqueeze(1).expand(lanes, m, n))
    return g, torch.gather(h, 1, rows), torch.gather(c, 1, cols)


def conic(config, data):
    """The program's batched (c (B, n), A (B, 4n, n), b (B, 4n)):
    A = [G; I; -I], b = [h; box; box]."""
    g, h, c = data
    lanes, _, n = g.shape
    eye = torch.eye(n, dtype=g.dtype, device=g.device).expand(lanes, n, n)
    a = torch.cat([g, eye, -eye], dim=1).contiguous()
    box = torch.full((lanes, 2 * n), BOX, dtype=h.dtype, device=h.device)
    return c, a, torch.cat([h, box], dim=1).contiguous()


def problem(c, a, b):
    """One lane as the program takes it, through its LP builder:
    (c, A, b, cone)."""
    from totsu_tpu_torch.problems.lp import lp
    p = lp(c, a, b)
    return p.c, p.a, p.b, p.cone


def residuals(config, data, x, y):
    """The reference's residuals of answers (x, y), each (B,)."""
    g, h, c = data
    return _kkt.residuals(g, h, c, BOX, x, y)


def control(config, data):
    """(x, y) of the control on the same instances."""
    g, h, c = data
    return _control.solve_lp_bf16(g, h, c, BOX)
