"""The check that decides ``correct``: the reference against an
independent solver, the control (the reference one precision down) and
the faults each cell can have, which must all come out not correct; and
what the benchmark imports."""

import ast
import dataclasses
import subprocess
import sys
import time

import pytest
import torch

from h100bench import check, drivers, harness, instances
from h100bench.reference import lp_ipm

from conftest import REPO

SEED = 2**31 + 777
LP = drivers.load(REPO / "h100bench", "problems", "dense_lp")
BOX = LP.BOX


def _lp(n, lanes, gen_seed):
    return LP.make({"n": n}, lanes, gen_seed, torch.device("cpu"))


def test_reference_matches_highs():
    linprog = pytest.importorskip("scipy.optimize").linprog
    g, h, c = _lp(20, 4, instances.key(SEED, 1, 0))
    x, z, obj, _, ok = lp_ipm.solve_lp(g, h, c, BOX)
    assert bool(ok.all())
    for j in range(4):
        res = linprog(c[j].double().numpy(), A_ub=g[j].double().numpy(),
                      b_ub=h[j].double().numpy(),
                      bounds=[(-BOX, BOX)] * 20,
                      method="highs")
        assert res.status == 0
        assert abs(float(obj[j]) - res.fun) <= 1e-7 * (1 + abs(res.fun))
    res = LP.residuals({}, (g, h, c), x, z)
    assert float(check.worst(res).max()) < 1e-8


def test_dual_cone_is_judged():
    """A free y can meet the dual equation and close the gap at any
    feasible x: here the point that maximizes c^T x. Only y's distance
    from its cone tells it from an optimum."""
    g, h, c = _lp(20, 2, instances.key(SEED, 3, 0))
    x, _, _, _, ok = lp_ipm.solve_lp(g, h, -c, BOX)
    assert bool(ok.all())
    g64, h64, c64, x64 = (t.double() for t in (g, h, c, x))
    eye = torch.eye(20, dtype=torch.float64).expand(2, 20, 20)
    a = torch.cat([g64, eye, -eye], dim=1)
    b = torch.cat([h64, torch.full((2, 40), BOX, dtype=torch.float64)], 1)
    # min-norm y with A^T y = -c and b^T y = -c^T x
    lhs = torch.cat([a.transpose(1, 2), b.unsqueeze(1)], dim=1)
    rhs = torch.cat([-c64, -(c64 * x64).sum(-1, keepdim=True)], dim=1)
    y = torch.linalg.pinv(lhs).matmul(rhs.unsqueeze(-1)).squeeze(-1)
    res = LP.residuals({}, (g, h, c), x, y)
    for name in ("pri", "dual", "gap"):
        assert float(res[name].max()) < 1e-6, name
    assert float(res["ycone"].min()) > 1e-2
    assert float(check.worst(res).min()) > 1e-2


@pytest.mark.parametrize("config", ["benchmark_lp_n100",
                                    "benchmark_lp_n6000"])
def test_control_fails(config):
    """The reference in bfloat16 (instance and answer), put in the
    program's place for 32 answers at n = 100, reads above the
    configuration's ``kkt`` limit (the largest over the answers, as a run
    reads it) on every seed tried. The limit is the tolerance the
    configuration states."""
    import json
    cfg = json.loads((REPO / f"h100bench/configs/{config}.json")
                     .read_text())
    limit = cfg["limits"]["kkt"]
    assert limit == cfg["solver"]["eps_acc"]
    for s in range(3):
        data = _lp(100, 32, instances.key(SEED + s, 1, 0))
        x, y = LP.control(cfg, data)
        assert float(check.worst(LP.residuals(cfg, data, x, y)).max()) \
            > limit


def _fault(res, fault: str):
    x, y = res.x.clone(), res.y.clone()
    if fault == "unchanged":        # the cold start, returned as it came
        x.zero_()
        y.zero_()
    elif fault == "half":           # the second half of the lanes unsolved
        half = x.shape[0] // 2
        x[half:] = x[:x.shape[0] - half]
        y[half:] = y[:y.shape[0] - half]
    elif fault == "altered":        # one answer changed where it is made
        x.view(-1)[0] += 1.0
    return dataclasses.replace(res, x=x, y=y)


FAULTS = [("lp8.fleet256", f) for f in ("unchanged", "half", "altered")] \
    + [(cell, f) for cell in ("lp8.single", "lp8r.single", "lp8.serve")
       for f in ("unchanged", "altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    """The run with the timed path broken underneath, the look for a card
    skipped: ``correct`` comes out false."""
    import totsu_tpu_torch
    from totsu_tpu_torch.parallel import batch
    from totsu_tpu_torch.runtime import batcher
    if cell.endswith("fleet256"):
        real = batch.solve_batch
        monkeypatch.setattr(batch, "solve_batch",
                            lambda *a, **k: _fault(real(*a, **k), fault))
    elif cell.endswith("serve"):
        real = batcher.solve_batch_jit
        monkeypatch.setattr(batcher, "solve_batch_jit",
                            lambda *a, **k: _fault(real(*a, **k), fault))
    else:
        real = totsu_tpu_torch.solve
        monkeypatch.setattr(totsu_tpu_torch, "solve",
                            lambda *a, **k: _fault(real(*a, **k), fault))
    line, _ = harness.run_cell(tiny_root, cell, SEED, 1.5, False,
                               time.perf_counter(), require_cuda=False,
                               program_root=REPO)
    assert line["correct"] is False


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_or_reference_package_anywhere():
    for path in (REPO / "h100bench").rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path
        assert "bench" not in _imports(path), path
    for path in (REPO / "h100bench/reference").rglob("*.py"):
        assert "totsu_tpu_torch" not in _imports(path), path


def test_loaded_modules():
    """What a run loads, and what the reference loads, by whole top-level
    names in a fresh process."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import h100bench.reference.lp_ipm, h100bench.reference.kkt, "
        "h100bench.reference.control\n"
        "ref = sorted({k.split('.')[0] for k in sys.modules})\n"
        "from pathlib import Path\n"
        "from h100bench import harness\n"
        f"root = Path({str(REPO)!r})\n"
        "m = harness.load_manifest(root)\n"
        "for g in ('end_to_end', 'per_layer'):\n"
        "    for e in m[g]:\n"
        "        harness.load_reader(harness.bench_dir(root, m), e['name'])\n"
        "harness.import_program(root)\n"
        "import h100bench.drivers as d, h100bench.check, h100bench.trace\n"
        "import json as j\n"
        "bd = harness.bench_dir(root, m)\n"
        "for w in m['workloads']:\n"
        "    c = j.loads(harness.config_path(root, m, w['config']).read_text())\n"
        "    d.load(bd, 'problems', c['family'])\n"
        "    t = j.loads((bd / 'traffic' / (w['traffic'] + '.json')).read_text())\n"
        "    d.load(bd, 'loops', t['kind'])\n"
        "print(json.dumps([ref, harness.foreign_modules()]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    import json
    ref, foreign = json.loads(out.stdout.strip().splitlines()[-1])
    assert "totsu_tpu_torch" not in ref
    assert foreign == []
