"""Microbatched solve runtime for serving workloads (port of
``totsu_tpu.runtime.batcher``).

Deployments solve many small and medium conic programs (pricing,
allocation, MPC ticks). Solved one by one, each is bound by its launches
and host reads; :class:`BatchRunner` is the serving pattern around the
solver:

* requests are **bucketed by signature** (m, n, cone layout, params);
* each bucket is solved through power-of-two batch tiers: full
  256-chunks, the largest tier fitting the remainder, then ONE padded tier
  for what is left (19 -> 16 + a 4-tier carrying 3), so padding is
  confined to the final small chunk and a batch of at most 256 takes at
  most two prepared solvers;
* prepared solvers live in an LRU cache (``max_cached``), one per
  (signature, tier, warm, device): the layout with its 'auto' PSD methods
  resolved and the parameters. Where the JAX package
  caches a compiled executable, the port has nothing to compile; the
  cache keeps the same bound and the same count
  (:attr:`BatchRunner.compiled_signatures`), and holds nothing from an
  earlier request;
* a bucket's requests are solved **in lockstep** on the device
  (:func:`solve_batch_jit`: with ``kernel='mega'``, or ``'auto'`` on the
  card, every lane of a tier in one launch of the batched megakernel)
  and the results scattered back in order; each prepared solver records
  the routes its solves took (:attr:`BatchRunner.routes`);
* :meth:`submit` is the asynchronous front: requests enqueue from any
  thread, a background collector drains the queue every ``flush_ms`` (or
  when ``max_pending`` accumulate) and resolves per-request futures.
"""

import bisect
import collections
import dataclasses
import queue
import threading
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from totsu_tpu_torch.solver.batched import solve_batch_jit
from totsu_tpu_torch.solver.cone import ConeLayout, resolve_auto_methods
from totsu_tpu_torch.solver.conic import SolveResult
from totsu_tpu_torch.solver.operator import target_device
from totsu_tpu_torch.solver.params import SolverParam

#: power-of-two batch tiers
_TIERS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


@dataclasses.dataclass(frozen=True)
class _Signature:
    m: int
    n: int
    cone: ConeLayout
    param: SolverParam


def _tier_chunks(count: int) -> List[Tuple[int, int]]:
    """Decompose ``count`` into at most two tiers per 256-block: full
    256-chunks, then the largest tier <= remainder, then ONE padded tier
    covering what is left. Returns (tier, n_used) pairs with
    sum(n_used) == count (19 -> (16, 16) + (4, 3))."""
    out = []
    rem = count
    while rem >= _TIERS[-1]:
        out.append((_TIERS[-1], _TIERS[-1]))
        rem -= _TIERS[-1]
    if rem > 0:
        t = _TIERS[bisect.bisect_right(_TIERS, rem) - 1]
        out.append((t, t))
        rem -= t
        if rem > 0:
            t2 = _TIERS[bisect.bisect_left(_TIERS, rem)]
            out.append((t2, rem))
    return out


@dataclasses.dataclass(frozen=True)
class _Prepared:
    """A batched solver for one (signature, tier, warm, device): the
    layout with its 'auto' PSD methods resolved on one lane's shapes and
    the parameters. Calling it solves one tier-sized batch; ``routes``
    collects what ran its solves ('mega': the batched megakernel, 'loop':
    the lockstep host loop; ``solve_batch_jit``'s ``diag["route"]``)."""
    cone: ConeLayout
    param: SolverParam
    warm: bool
    routes: set = dataclasses.field(default_factory=set, compare=False)

    def __call__(self, cb, ab, bb, wx=None, wy=None) -> SolveResult:
        ws = (wx, wy) if self.warm else None
        out = solve_batch_jit(cb, ab, bb, self.cone, self.param,
                              warm_start=ws)
        self.routes.add(out.diag["route"])
        return out


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _lane(out: SolveResult, j: int) -> SolveResult:
    """Lane ``j`` of a batch result, with ``status`` and ``iters`` as
    Python ints like a single solve's."""
    return dataclasses.replace(
        out, x=out.x[j], y=out.y[j], status=int(out.status[j]),
        iters=int(out.iters[j]), cri_pri=out.cri_pri[j],
        cri_dual=out.cri_dual[j], cri_gap=out.cri_gap[j],
        cri_unbdd=out.cri_unbdd[j], cri_infeas=out.cri_infeas[j],
        state=None)


class BatchRunner:
    """Prepared-solver cache + lockstep microbatcher.

    >>> runner = BatchRunner(device="cpu")
    >>> results = runner.map([(c1, a1, b1, cone), (c2, a2, b2, cone), ...])

    Thread-safe; prepared solvers are shared across calls (LRU-capped at
    ``max_cached`` (signature, tier, warm) entries). Problem data goes to
    ``device``, else to the device of the problems' tensors, else to the
    CUDA card. For asynchronous serving use :meth:`submit`, which returns
    a ``concurrent.futures.Future``.
    """

    def __init__(self, param: SolverParam = SolverParam(max_iter=100_000),
                 max_cached: int = 64, *, device=None):
        self._param = param
        self._max_cached = max_cached
        self._device = None if device is None else torch.device(device)
        self._compiled = collections.OrderedDict()  # key -> _Prepared, LRU
        self._lock = threading.Lock()
        self._queue = None
        self._collector = None

    def _executable(self, sig: _Signature, tier: int, warm: bool,
                    device: torch.device) -> _Prepared:
        key = (sig, tier, warm, device)
        with self._lock:
            fn = self._compiled.get(key)
            if fn is not None:
                self._compiled.move_to_end(key)  # LRU touch
                return fn
        fn = _Prepared(resolve_auto_methods(sig.cone, sig.param), sig.param,
                       warm)
        with self._lock:
            self._compiled[key] = fn
            self._compiled.move_to_end(key)
            while len(self._compiled) > self._max_cached:
                self._compiled.popitem(last=False)  # evict least recent
        return fn

    def _target(self, parsed) -> torch.device:
        if self._device is not None:
            return self._device
        for c, a, b, _ in parsed:
            for x in (a, c, b):
                if isinstance(x, torch.Tensor):
                    return x.device
        return target_device(None)

    def map(self, problems: Sequence,
            warm_starts: Optional[Sequence] = None) -> List[SolveResult]:
        """Solve a sequence of (c, a, b, cone) tuples (or ConicProblems).
        Dense operators only (a lockstep batch needs one structure).
        Returns per-problem SolveResults in input order, each with
        ``status`` and ``iters`` as Python ints and x, y on the batch's
        device.

        ``warm_starts``: optional per-problem ``(x0, y0)`` seeds (or None
        entries), e.g. the previous tick's solutions in a receding-horizon
        loop. Absent and padded entries take zero seeds, as in the JAX
        package; warm solvers are cached apart from cold ones."""
        parsed = []
        for p in problems:
            if hasattr(p, "cone"):
                c, a, b, cone = p.c, p.a, p.b, p.cone
            else:
                c, a, b, cone = p
            a = a.a if hasattr(a, "a") else a
            parsed.append((c, a, b, cone))
        if warm_starts is not None and len(warm_starts) != len(parsed):
            raise ValueError("warm_starts must pair up with problems")
        device = self._target(parsed)

        def stack(xs, dtype=None):
            if all(isinstance(x, torch.Tensor) and x.device == device
                   for x in xs):
                out = torch.stack(list(xs))
            else:
                out = torch.from_numpy(np.stack([_host(x) for x in xs])).to(
                    device)
            return out if dtype is None else out.to(dtype)

        buckets: Dict[_Signature, List[int]] = {}
        for i, (c, a, b, cone) in enumerate(parsed):
            sig = _Signature(m=int(b.shape[0]), n=int(c.shape[0]), cone=cone,
                             param=self._param)
            buckets.setdefault(sig, []).append(i)

        warm = warm_starts is not None
        results: List[SolveResult] = [None] * len(parsed)
        for sig, idxs in buckets.items():
            start = 0
            for tier, used in _tier_chunks(len(idxs)):
                chunk = idxs[start:start + used]
                start += used
                fn = self._executable(sig, tier, warm, device)
                # pad slots (tier > used, final chunk only) replicate the
                # chunk's first problem: cheap and convergent
                rows = chunk + [chunk[0]] * (tier - used)
                cb = stack([parsed[i][0] for i in rows])
                ab = stack([parsed[i][1] for i in rows])
                bb = stack([parsed[i][2] for i in rows])
                args = [cb, ab, bb]
                if warm:
                    # seeds in the batch's dtype: a seed from another run
                    # must not change the solve's dtype
                    def seed(i, part, size):
                        ws = warm_starts[i] if i is not None else None
                        if ws is None or ws[part] is None:
                            return np.zeros(size)
                        return _host(ws[part])

                    lanes = chunk + [None] * (tier - used)
                    for part, size, ref in ((0, sig.n, cb), (1, sig.m, bb)):
                        args.append(stack([seed(i, part, size)
                                           for i in lanes], ref.dtype))
                out = fn(*args)
                for j, i in enumerate(chunk):
                    results[i] = _lane(out, j)
        return results

    # ---------------------------------------------------------------- async

    def submit(self, problem, flush_ms: float = 5.0,
               max_pending: int = 256) -> Future:
        """Enqueue one (c, a, b, cone) problem (or ConicProblem); returns a
        Future resolving to its :class:`SolveResult`.

        A lazy daemon collector drains everything pending every
        ``flush_ms`` milliseconds (or as soon as ``max_pending``
        accumulate) and runs one :meth:`map` per drain, so bursts coalesce
        into large lockstep batches while a lone request still completes
        within one flush interval. ``flush_ms`` and ``max_pending``
        configure the collector once, on the first :meth:`submit` of this
        runner; later values are ignored."""
        fut = Future()
        with self._lock:
            if self._queue is None:
                self._queue = queue.SimpleQueue()
                self._collector = threading.Thread(
                    target=self._collect, args=(flush_ms / 1e3, max_pending),
                    daemon=True, name="totsu-batch-collector")
                self._collector.start()
        self._queue.put((problem, fut))
        return fut

    def _collect(self, flush_s: float, max_pending: int):
        while True:
            item = self._queue.get()  # block for the first request
            pending = [item]
            # coalesce: keep draining until one flush interval passes with
            # the queue empty, or the batch is large enough to dispatch
            while len(pending) < max_pending:
                try:
                    pending.append(self._queue.get(timeout=flush_s))
                except queue.Empty:
                    break
            # claim each future; drop the ones cancelled while queued (a
            # cancelled future raises on set_result, which would poison
            # the whole drain)
            live = [(p, f) for p, f in pending
                    if f.set_running_or_notify_cancel()]
            if not live:
                continue
            try:
                res = self.map([p for p, _ in live])
                for (_, fut), r in zip(live, res):
                    fut.set_result(r)
            except Exception as exc:  # noqa: BLE001 - propagate per-future
                for _, fut in live:
                    if not fut.done():
                        fut.set_exception(exc)

    @property
    def routes(self) -> Dict[tuple, Tuple[str, ...]]:
        """Each cached prepared solver's routes so far, by (m, n, tier,
        warm, device): ('mega',) where the batched megakernel ran its
        tiers, ('loop',) where the lockstep host loop did."""
        with self._lock:
            return {(sig.m, sig.n, tier, warm, device): tuple(sorted(
                fn.routes)) for (sig, tier, warm, device), fn
                in self._compiled.items()}

    @property
    def compiled_signatures(self) -> int:
        """The prepared solvers in the cache: one per (signature, tier,
        warm) in use, at most ``max_cached``."""
        return len(self._compiled)
