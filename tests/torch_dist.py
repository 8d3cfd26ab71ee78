"""Run the scenarios of a torch-only worker module on N spawned ranks.

Not a test module: the distribution tests of the port
(``test_torch_parallel_mesh.py``, ``test_torch_admm_mesh.py``,
``test_torch_multihost.py``) use it. Each rank is a fresh interpreter
started with ``torch.multiprocessing`` (start method ``spawn``) that joins
a gloo process group at ``tcp://127.0.0.1:<free port>`` (or, with
``join=None``, lets the scenario join itself), runs every scenario of the
list in turn and sends back each one's return value or traceback. A
test module spawns each world once, from a module-scoped fixture, and
keeps one test function per scenario.

Why the hard limits: a rank that raises, or never reaches a collective,
leaves the others waiting in it. Without a limit a hung gloo collective
would hold its test worker until the suite's own time limit (1,470 s)
cut the whole run. So the process group times out every collective
after :data:`PG_TIMEOUT` (gloo raises in the waiting rank), and the
parent kills the ranks after ``timeout`` seconds (:data:`WORLD_TIMEOUT`
by default) and fails the world. Both leave room for the suite's load:
a world of 4 ranks that takes 40 s on an idle machine took past 120 s
beside five busy test workers, and a batch-sharded solve's last gather
waits for the rank whose lanes run longest. A port lost between the
probe and the bind (another process took it) is retried on a fresh one,
as ``test_multihost.py`` does.

Every rank runs one thread in each pool (torch's and the BLAS numpy
loads): the suite's workers share the machine (``torch_threads.py``).
"""

import datetime
import importlib
import queue as queue_mod
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

#: the process group's timeout in each rank: a collective that waits
#: longer raises
PG_TIMEOUT = datetime.timedelta(seconds=150)
#: seconds a world may run before its ranks are killed
WORLD_TIMEOUT = 300.0


class WorldError(AssertionError):
    """A rank failed, or the world ran past its time limit."""


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_main(rank, world, port, module, scenarios, join, out):
    from threadpoolctl import threadpool_limits
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        try:
            if join == "gloo":
                dist.init_process_group(
                    "gloo", init_method=f"tcp://127.0.0.1:{port}",
                    rank=rank, world_size=world, timeout=PG_TIMEOUT)
            mod = importlib.import_module(module)
            for name in scenarios:
                t0 = time.monotonic()
                try:
                    value, ok = getattr(mod, name)(rank, world, port), True
                except Exception:
                    value, ok = traceback.format_exc(), False
                out.put((rank, name, ok, value, time.monotonic() - t0))
        except Exception:
            out.put((rank, None, False, traceback.format_exc(), 0.0))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()


def _port_lost(text: str) -> bool:
    text = text.lower()
    return "address already in use" in text or "eaddrinuse" in text


class World:
    """The results of one world's scenarios: ``result(name)`` is the list
    of every rank's return value, or raises :class:`WorldError` with the
    failing ranks' tracebacks; ``seconds`` the world's wall time and
    ``scenario_seconds`` each scenario's on its slowest rank."""

    def __init__(self, results, failure, seconds, scenario_seconds):
        self.results = results
        self.failure = failure
        self.seconds = seconds
        self.scenario_seconds = scenario_seconds

    def result(self, name):
        if self.failure:
            raise WorldError(self.failure)
        ranks = self.results.get(name, {})
        bad = {r: v for r, (ok, v) in ranks.items() if not ok}
        if bad:
            raise WorldError(f"scenario {name} failed on ranks "
                             f"{sorted(bad)}:\n"
                             + "\n".join(bad.values())[-6000:])
        return [ranks[r][1] for r in sorted(ranks)]


def _spawn(module, nprocs, scenarios, join, timeout, port):
    ctx = tmp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nprocs, port, module, scenarios, join, out),
                         daemon=True)
             for r in range(nprocs)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    results = {name: {} for name in scenarios}
    secs = {name: 0.0 for name in scenarios}
    failure = None
    want = nprocs * len(scenarios)
    got = 0
    deadline = t0 + timeout
    try:
        while got < want:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = (f"the world of {nprocs} ranks ran past its "
                           f"{timeout} s limit ({got} of {want} scenario "
                           "results in); its ranks were killed")
                break
            try:
                rank, name, ok, value, took = out.get(
                    timeout=min(left, 1.0))
            except queue_mod.Empty:
                if not any(p.is_alive() for p in procs):
                    failure = (f"every rank exited with {got} of {want} "
                               "scenario results in (exit codes "
                               f"{[p.exitcode for p in procs]})")
                    break
                continue
            if name is None:
                failure = f"rank {rank} failed to start:\n{value}"
                break
            results[name][rank] = (ok, value)
            secs[name] = max(secs[name], took)
            got += 1
    finally:
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return World(results, failure, time.monotonic() - t0, secs)


def run_world(module: str, nprocs: int, scenarios, join="gloo",
              timeout: float = WORLD_TIMEOUT, attempts: int = 3) -> World:
    """Run ``scenarios`` (names of functions ``f(rank, world, port)`` of
    ``module``) on ``nprocs`` ranks; ``join`` "gloo" joins the ranks
    first, None leaves it to the scenarios (which then get the port)."""
    for attempt in range(attempts):
        world = _spawn(module, nprocs, list(scenarios), join, timeout,
                       free_port())
        lost = world.failure and _port_lost(world.failure) or any(
            not ok and _port_lost(v)
            for ranks in world.results.values()
            for ok, v in ranks.values())
        if not lost:
            break
    return world
