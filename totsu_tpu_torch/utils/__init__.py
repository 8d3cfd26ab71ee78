"""Utilities: env-var configuration (``utils/env.py``)."""

from totsu_tpu_torch.utils.env import set_par_by_env

__all__ = ["set_par_by_env"]
