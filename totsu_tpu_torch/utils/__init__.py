"""Utilities: env-var configuration, the operator oracle, contour
extraction."""

from totsu_tpu_torch.utils.env import set_par_by_env
from totsu_tpu_torch.utils.operator_check import check_operator
from totsu_tpu_torch.utils.contour import (
    contour_segments, contour_series, chain_segments)

__all__ = ["set_par_by_env", "check_operator",
           "contour_segments", "contour_series", "chain_segments"]
