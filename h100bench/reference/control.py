"""The control: the reference put in the program's place one precision
down. The configuration states float32, so the control holds the
instance and its answer in bfloat16: the interior-point method solves
the instance rounded to bfloat16 (its arithmetic in float64, as no
factorization runs in bfloat16), and its x and y are rounded to
bfloat16. A sound comparison has to judge this answer wrong."""

import torch

from h100bench.reference import lp_ipm


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def solve_lp_bf16(g, h, c, box: float):
    """(x, y) of the control for batched G, h, c."""
    x, y, _, _, _ = lp_ipm.solve_lp(_bf16(g), _bf16(h), _bf16(c), box)
    return _bf16(x), _bf16(y)
