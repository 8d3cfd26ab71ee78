"""Serving runtime: prepared-solver caching and microbatched solves
(port of ``totsu_tpu.runtime``)."""

from totsu_tpu_torch.runtime.batcher import BatchRunner

__all__ = ["BatchRunner"]
