"""Named ranges of the program on the profiler's clock.

``span(name)`` is a ``torch.profiler.record_function`` range while a torch
profiler records, and one shared no-op context otherwise: tracing is on
exactly when a caller records with ``torch.profiler``, and off it costs a
C call and a Python call. The ranges are the profiler's host events, so
they share one clock with the device's kernels in the same trace; each
nests in the range open around it on the same thread, and the enclosing
``totsu.solve`` is the request.

The ranges:

* ``totsu.solve``: one ``solve_jit`` call (a chunked ``solve`` opens one
  per chunk);
* ``totsu.direct.cache``: the direct engine's cached solve of
  I + A^T A (:func:`~totsu_tpu_torch.solver.direct.spd_cache`), not
  opened when a checkpoint carries the cache;
* ``totsu.loop.iterate``: one run of ``check_period`` updates of the
  direct engine's Halpern loop;
* ``totsu.loop.check``: the rest of that loop's pass (the check, its host
  read, the restart bookkeeping).
"""

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a torch profiler records,
    else the shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
