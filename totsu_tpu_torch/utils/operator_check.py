"""Consistency oracle for user-defined operators (port of
``totsu_tpu.utils.operator_check``).

The public analogue of the reference's utils2 brute-force oracles
(examples/utils2/src/operator_ref.rs:5-70): adjoint consistency of
``rmatvec`` against ``matvec``, and the absolute row and column sums that
feed the diagonal preconditioner. A wrong ``col_abssum`` silently slows
convergence, so a matrix-free operator should be checked once when it is
built.
"""

import numpy as np
import torch

from totsu_tpu_torch.solver.operator import LinOp


def check_operator(op: LinOp, n_probes: int = 3, rtol: float = 1e-4,
                   seed: int = 0) -> None:
    """Raise AssertionError if the operator's methods are inconsistent.

    * the adjoint identity <A u, v> == <u, A^T v> on random probes (made
      with numpy from ``seed``, on the operator's device, in its dtype);
    * ``col_abssum`` / ``row_abssum`` against the materialized operator
      (``to_dense``, O(m n): for build-time checks at moderate sizes).
    """
    m, n = op.shape
    dtype = op.dtype or torch.get_default_dtype()
    rng = np.random.default_rng(seed)

    def probe(k):
        return torch.as_tensor(rng.normal(size=k), dtype=dtype,
                               device=op.device)

    for _ in range(n_probes):
        u = probe(n)
        v = probe(m)
        lhs = float(torch.dot(op.matvec(u), v))
        rhs = float(torch.dot(u, op.rmatvec(v)))
        scale = max(abs(lhs), abs(rhs), 1.0)
        assert abs(lhs - rhs) <= rtol * scale, (
            f"adjoint inconsistency: <Au,v>={lhs} != <u,A'v>={rhs}")

    dense = op.to_dense().double().cpu().numpy()
    np.testing.assert_allclose(op.col_abssum().double().cpu().numpy(),
                               np.abs(dense).sum(axis=0), rtol=rtol,
                               err_msg="col_abssum mismatch")
    np.testing.assert_allclose(op.row_abssum().double().cpu().numpy(),
                               np.abs(dense).sum(axis=1), rtol=rtol,
                               err_msg="row_abssum mismatch")
