"""The benchmark's harness: one cell, one run.

``run_cell`` reads ``BENCHMARK.json`` and finds, by the names there, the
cell's configuration (``configs/<config>.json``), whose ``family`` names
its problem family (``problems/<family>.py``: instances, the program's
form of them, the reference's residuals and control), its traffic mix
(``traffic/<traffic>.json``, whose ``kind`` names its loop,
``loops/<kind>.py``) and the readers of its metrics
(``metrics/<metric>.py``, or the reader of the name's stem). It sets the
cell up, measures one window, checks what the window produced against
the plain reference (:mod:`h100bench.check`), and returns the
contract's result line. Adding a cell, a mix, a loop, a family or a
metric adds files and manifest entries; nothing here names one.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from h100bench import check, drivers, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "totsu_tpu")
PROGRAM = "totsu_tpu_torch"


class BenchError(RuntimeError):
    """A run that cannot print a result (no card, a missing file, a
    foreign import)."""


def load_manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def bench_dir(root: Path, manifest: dict) -> Path:
    """The harness's folder: the first of the manifest's ``paths``."""
    return root / manifest["paths"][0]


def find_cell(manifest: dict, name: str) -> dict:
    """The manifest's entry of workload ``name``."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    return cells[name]


def config_path(root: Path, manifest: dict, name: str) -> Path:
    """The file of configuration ``name``: the manifest's, or
    ``configs/<name>.json`` for one the manifest does not list (the
    readings of ``control.py``)."""
    for c in manifest["configs"]:
        if c["name"] == name:
            return root / c["file"]
    return bench_dir(root, manifest) / "configs" / f"{name}.json"


def metrics_for(manifest: dict, cell_name: str, traced: bool):
    """The metric entries a run of ``cell_name`` reports: its end-to-end
    metrics untraced, its per-layer metrics traced."""
    group = manifest["per_layer"] if traced else manifest["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def load_reader(bdir: Path, metric: str):
    """``metrics/<metric>.py``'s ``read(run)``, or that of the name's
    stem."""
    try:
        return drivers.load(bdir, "metrics", metric).read
    except FileNotFoundError as err:
        raise BenchError(str(err)) from None


def foreign_modules():
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``totsu_tpu_torch`` is not ``totsu_tpu``)."""
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def import_program(root: Path):
    """Import the port from the checkout at ``root``, and only from
    there."""
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import totsu_tpu_torch
    where = Path(totsu_tpu_torch.__file__).resolve()
    if root.resolve() not in where.parents:
        raise BenchError(f"{PROGRAM} was imported from {where}, not from the "
                         f"checkout at {root}")
    return totsu_tpu_torch


def device_info(chips: int) -> dict:
    if not torch.cuda.is_available():
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             traced: bool, t_start: float, require_cuda: bool = True,
             keep_run: bool = False, program_root=None, mix_over=None,
             cell=None):
    """One run of one cell: returns ``(line, run)``, the result line (a
    dict) and, with ``keep_run``, the run's record with its ``driver``
    (else None). The port
    is imported from ``program_root`` (the checkout at ``root`` by
    default); ``require_cuda=False`` runs on the CPU, on the port's
    plain paths, with no device metric. ``mix_over`` replaces parameters
    of the mix; ``cell`` gives a cell's entry (name, config, traffic,
    chips) that the manifest need not list."""
    root = Path(root)
    manifest = load_manifest(root)
    bdir = bench_dir(root, manifest)
    cell = cell or find_cell(manifest, workload)
    workload = cell["name"]
    chips = int(cell["chips"])
    if require_cuda:
        if not torch.cuda.is_available():
            raise BenchError("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < chips:
            raise BenchError(f"{workload} needs {chips} cards, "
                             f"{torch.cuda.device_count()} visible")
    config = json.loads(config_path(root, manifest, cell["config"])
                        .read_text())
    mix = json.loads((bdir / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    mix.update(mix_over or {})
    entries = metrics_for(manifest, workload, traced)
    readers = {m["name"]: load_reader(bdir, m["name"]) for m in entries}
    tt = import_program(Path(program_root or root))
    device = torch.device("cuda", 0) if require_cuda \
        else torch.device("cpu")
    family = drivers.load(bdir, "problems", config["family"])
    loop = drivers.load(bdir, "loops", mix["kind"])
    driver = loop.Loop(mix, config, family, seed, device, tt)
    run = drivers.Run(seed=seed, seconds=seconds, config=config, mix=mix,
                      family=family, device=device,
                      tracer=trace.Tracer(traced and device.type == "cuda",
                                          float(mix.get("trace_s", 0.0))))
    t_setup = time.perf_counter()
    driver.setup(run)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run.setup_s = time.perf_counter() - t_start
    run.driver_setup_s = time.perf_counter() - t_setup
    driver.window(run)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    run.tracer.finish()
    metrics = {}
    for m in entries:
        value = readers[m["name"]](run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    driver.release(run)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    verdict = check.judge(run, driver, config)
    bad = foreign_modules()
    if bad:
        raise BenchError("modules the benchmark may not load are loaded: "
                         + ", ".join(bad))
    dev = device_info(chips)
    dev["memory_peak_bytes"] = int(peak)
    line = {"correct": verdict["correct"], "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": dev}
    if traced and run.tracer.summary is not None:
        s = run.tracer.summary
        dev["busy_s"] = s["busy_s"]
        dev["window_s"] = s["window_s"]
        line["breakdown"] = {"device_ops": s["device_ops"],
                             "idle_gaps": s["idle_gaps"]}
    line["compared"] = verdict["compared"]
    note = (f"setup_s {run.setup_s:.3f} (instances and warm-up "
            f"{run.driver_setup_s:.3f}) window_s {run.window_s:.3f} "
            f"calls {len(run.spans)} answers {verdict['answers']} "
            f"check_s {verdict['seconds']:.3f}")
    if run.late:
        note += f" generator_late_p95_ms {np.percentile(run.late, 95) * 1e3:.3f}"
    if run.tracer.summary is not None:
        s = run.tracer.summary
        note += (f" trace_events {s['events']} trace_stop_s "
                 f"{run.tracer.stop_s:.3f} trace_read_s {s['read_s']:.3f}")
    print("h100bench: " + note, file=sys.stderr)
    if not keep_run:
        return line, None
    run.driver = driver
    return line, run


def compared_lines(compared: dict):
    """The compared numbers, one line each, beside their limits."""
    return [f"{k} {v['value']!r} limit {v['limit']!r}"
            for k, v in compared.items()]
