"""What every traffic loop shares. A mix file (``traffic/<mix>.json``)
names its loop by ``kind``: ``loops/<kind>.py``, whose ``Loop`` is a
:class:`Driver`. The configuration names its problem family
(``problems/<family>.py``): the instances, the program's form of them,
and the reference's residuals and control.

A closed loop starts a call only while it expects the call to end inside
the window (by the length of the call before it); the window closes when
the last call returns. An open loop's window holds the requests due in
the first ``seconds``, and closes when the last of them is answered.

Every call into the program is a span of the harness's own
(``Run.spans``, and a ``record_function`` in a traced run). Each answer
to be checked is kept as a :class:`Record`.
"""

import dataclasses
import importlib.util
import time
from pathlib import Path
from typing import Any, List

import torch

from h100bench import instances

# the stream numbers of instance keys: what the window solves, and what
# the warm-up solves (never the same instances)
STREAM_WINDOW, STREAM_WARM = 1, 2
#: how long past the window's close an open loop waits for its answers
LATE_S = 60.0

_LOADED = {}


def load(bdir: Path, folder: str, name: str):
    """The module ``<folder>/<name>.py`` of the benchmark's folder; where
    there is none, ``<folder>/<stem>.py``, the stem being ``name`` up to
    its first dot (one reader serves ``device_idle_pct.large`` and
    ``device_idle_pct.fleet``)."""
    path = Path(bdir) / folder / f"{name}.py"
    if not path.exists():
        path = Path(bdir) / folder / f"{name.split('.')[0]}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {folder}/{name}.py in {bdir}")
    path = path.resolve()
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            f"h100bench_{folder}_{path.stem.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


@dataclasses.dataclass
class Record:
    """One answer to check: lane ``lane`` of the batch of ``lanes`` made
    from ``keys`` (its pool key and its order key), the program's x and y
    (None where it gave none), its status and iterations."""
    keys: tuple
    lanes: int
    lane: int
    x: Any
    y: Any
    status: int
    iters: int


@dataclasses.dataclass
class Run:
    """What one run measured."""
    seed: int
    seconds: float
    config: dict
    mix: dict
    family: Any
    device: Any
    tracer: Any
    setup_s: float = 0.0
    #: the part of ``setup_s`` that the traffic's own set-up took
    driver_setup_s: float = 0.0
    t0: float = 0.0
    t_close: float = 0.0
    attempted: int = 0
    failed: int = 0
    solved: int = 0
    #: (name, start, end) of every call into the program
    spans: List[tuple] = dataclasses.field(default_factory=list)
    #: iterations of every answer in the window
    iters: List[int] = dataclasses.field(default_factory=list)
    #: iterations of the answers of calls inside the traced stretch
    traced_iters: List[int] = dataclasses.field(default_factory=list)
    #: request latencies in seconds (single and open loops)
    latencies: List[float] = dataclasses.field(default_factory=list)
    records: List[Record] = dataclasses.field(default_factory=list)
    #: an open loop's lateness: seconds each submit ran behind its due
    late: List[float] = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t_close - self.t0


class Driver:
    """A traffic loop: ``setup(run)`` warms up the cell's shapes,
    ``window(run)`` measures, ``release(run)`` drops the program's state
    before the check."""

    def __init__(self, mix, config, family, seed, device, tt):
        self.mix = mix
        self.config = config
        self.family = family
        self.seed = int(seed)
        self.device = device
        self.tt = tt
        self.pool_seed = int(config["instance_seed"])
        self.param = self.solver_param()

    def solver_param(self, **over):
        fields = {**self.config["solver"], **self.mix.get("solver", {}),
                  **over}
        return self.tt.SolverParam(**fields)

    def make(self, stream: int, index: int, lanes: int, pool_index=None):
        """Batch ``index`` of ``stream``: the configuration's instances of
        batch ``pool_index`` (``index`` by default) with rows and columns in
        an order drawn from the run's seed; ``(keys, data)``."""
        keys = (instances.key(self.pool_seed, stream,
                              index if pool_index is None else pool_index),
                instances.key(self.seed, stream, index))
        return keys, self._made(keys, lanes)

    def _made(self, keys, lanes):
        return self.family.make(self.config, lanes, keys[0], self.device,
                                keys[1])

    def conic(self, data):
        """The program's batched (c, A, b) of an instance batch."""
        return self.family.conic(self.config, data)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self, run):
        """Drop the program's state before the check."""

    def keep_going(self, end: float, last: float) -> bool:
        """Whether a closed loop starts another call: before ``end``, and
        after the first call only if one as long as the ``last`` would
        end by then."""
        now = time.perf_counter()
        return now < end and (last == 0.0 or now + last <= end)

    def inputs(self, recs):
        """The instance batch of ``recs``, made again from their keys."""
        by_key = {}
        for r in recs:
            by_key.setdefault((r.keys, r.lanes), set()).add(r.lane)
        parts, place, at = [], {}, 0
        for (k, lanes), idx in by_key.items():
            idx = sorted(idx)
            sel = torch.tensor(idx, device=self.device)
            parts.append(instances.take(self._made(k, lanes), sel))
            for p, j in enumerate(idx):
                place[(k, lanes, j)] = at + p
            at += len(idx)
        order = torch.tensor([place[(r.keys, r.lanes, r.lane)]
                              for r in recs], device=self.device)
        return instances.take(instances.cat(parts), order)
