"""Shared fixtures of the harness's tests. Whether a card is there is
decided inside the ``cuda`` fixture, never while a module is imported."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: the tiny cells: (name, mix, end-to-end metric, per-layer metrics), each
#: at n = 8 on the CPU. ``lp8r.single`` is the twin of ``lp6000.single``
#: and reports that cell's metrics; the others drive the batch and open
#: loops and the single loop on fresh instances, which the n = 100 cells
#: used (out of the manifest until the megakernel meets its tolerance).
TINY = [
    ("lp8.fleet256", "fleet256", "solves_per_s",
     ["iters_per_solve.fleet", "mega_roofline.fleet",
      "device_idle_pct.fleet"]),
    ("lp8.single", "single_fresh", "latency_p95_ms.single",
     ["mega_roofline.single", "host_ms_per_solve.single"]),
    ("lp8.serve", "serve", "latency_p95_ms.serve",
     ["latency_p50_ms.serve", "device_idle_pct.serve"]),
]
TWINS = {"lp8r.single": "lp6000.single"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "h100: needs an NVIDIA card; skipped without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda", 0)


def _metric(name, e2e=None):
    entry = {"name": name, "unit": "u", "better": "lower",
             "source": "host_clock", "workloads": []}
    if e2e is None:
        entry["bound"] = 0.05
    else:
        entry.update(layer="test", moves=e2e)
    return entry


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark (its manifest and folder) with n = 8 cells
    (``TINY`` and ``TWINS``), small batches (each lane checked, so that
    one altered answer shows) and a slow rate, to run on the CPU through
    the port's plain paths."""
    root = tmp_path / "bench"
    shutil.copytree(REPO / "h100bench", root / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "h100bench/configs/benchmark_lp_n100.json")
                     .read_text())
    cfg.update(name="lp8", n=8, rows=32, check_chunk=64)
    (root / "h100bench/configs/lp8.json").write_text(json.dumps(cfg))
    manifest["configs"].append({"name": "lp8", "source": "test",
                                "file": "h100bench/configs/lp8.json",
                                "reduced": [], "why": "test"})
    cells = {w["name"]: w for w in manifest["workloads"]}
    for twin, of in TWINS.items():
        manifest["workloads"].append(dict(cells[of], name=twin,
                                          config="lp8"))
        for group in ("end_to_end", "per_layer"):
            for m in manifest[group]:
                if of in m.get("workloads", []):
                    m["workloads"].append(twin)
    for name, mix, e2e, layers in TINY:
        manifest["workloads"].append({"name": name, "config": "lp8",
                                      "traffic": mix, "chips": 1,
                                      "why": "test"})
        for group, entry in ([("end_to_end", _metric(e2e))]
                             + [("per_layer", _metric(p, e2e))
                                for p in layers]):
            entry["workloads"].append(name)
            manifest[group].append(entry)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    for mix, changes in (("fleet256", {"lanes": 8, "check_per_batch": 8}),
                         ("serve", {"rate": 20})):
        path = root / "h100bench/traffic" / f"{mix}.json"
        data = json.loads(path.read_text())
        data.update(changes)
        path.write_text(json.dumps(data))
    return root
