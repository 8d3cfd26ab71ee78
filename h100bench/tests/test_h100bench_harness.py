"""The harness on the CPU: the manifest, finding pieces by name, the
result line, the instances, and tiny cells run end to end through the
port's plain paths."""

import json
import math
import subprocess
import sys
import time

import pytest
import torch

from h100bench import drivers, harness, instances

from conftest import REPO, TINY, TWINS

CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}
SEED = 2**31 + 12345
LP = drivers.load(REPO / "h100bench", "problems", "dense_lp")

# A problem family that is no LP: min c^T x s.t. ||x|| <= r, as
# A = [0; -I], b = [r; 0] over one second-order cone of n + 1.
BALL = '''
import torch


def dims(config):
    n = int(config["n"])
    return n + 1, n


def make(config, lanes, gen_seed, device, perm_seed=None):
    gen = torch.Generator(device=device)
    gen.manual_seed(gen_seed)
    c = torch.randn(lanes, int(config["n"]), generator=gen, device=device)
    r = torch.rand(lanes, generator=gen, device=device) + 0.5
    return c, r


def conic(config, data):
    c, r = data
    lanes, n = c.shape
    eye = torch.eye(n, device=c.device).expand(lanes, n, n)
    a = torch.cat([torch.zeros(lanes, 1, n, device=c.device), -eye], 1)
    b = torch.cat([r[:, None], torch.zeros(lanes, n, device=c.device)], 1)
    return c, a.contiguous(), b


def problem(c, a, b):
    from totsu_tpu_torch.solver import cone
    return c, a, b, cone.ConeLayout([cone.soc(a.shape[0])])


def residuals(config, data, x, y):
    c, r, x, y = (t.double() for t in (*data, x, y))
    one_c = 1 + c.norm(dim=-1)
    cx, ry = (c * x).sum(-1), r * y[:, 0]
    return {"pri": (x.norm(dim=-1) - r).clamp(min=0) / (1 + r),
            "dual": (c - y[:, 1:]).norm(dim=-1) / one_c,
            "ycone": (y[:, 1:].norm(dim=-1) - y[:, 0]).clamp(min=0) / one_c,
            "gap": (cx + ry).abs() / (1 + cx.abs() + ry.abs())}


def control(config, data):
    c, r = data
    x = -r[:, None] * c / c.norm(dim=-1, keepdim=True)
    y = torch.cat([c.norm(dim=-1, keepdim=True), c], 1)
    return x.bfloat16().float(), y.bfloat16().float()
'''

# A loop kind of its own: each call solves the two lanes of a batch one
# after the other through solve().
PAIRS = '''
import time

from h100bench import drivers


class Loop(drivers.Driver):

    def setup(self, run):
        _, data = self.make(drivers.STREAM_WARM, 0, 1)
        c, a, b = self.conic(data)
        self.tt.solve_jit(*self.family.problem(c[0], a[0], b[0]),
                          self.solver_param(max_iter=20))

    def window(self, run):
        run.t0 = time.perf_counter()
        for index in range(int(self.mix["calls"])):
            k, data = self.make(drivers.STREAM_WINDOW, index, 2)
            c, a, b = self.conic(data)
            for j in range(2):
                t1 = time.perf_counter()
                res = self.tt.solve_jit(*self.family.problem(c[j], a[j], b[j]),
                                        self.param)
                run.spans.append(("solve", t1, time.perf_counter()))
                run.attempted += 1
                ok = int(res.status == 1)
                run.solved += ok
                run.failed += 1 - ok
                run.iters.append(int(res.iters))
                run.records.append(drivers.Record(k, 2, j, res.x, res.y,
                                                  int(res.status),
                                                  int(res.iters)))
        run.t_close = time.perf_counter()
'''


def _run(root, cell, seconds=1.5, traced=False):
    return harness.run_cell(root, cell, SEED, seconds, traced,
                            time.perf_counter(), require_cuda=False,
                            keep_run=True, program_root=REPO)


def test_manifest_pieces_exist():
    m = harness.load_manifest(REPO)
    bdir = harness.bench_dir(REPO, m)
    names = [c["name"] for c in m["configs"]]
    assert len(set(names)) == len(names)
    for c in m["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["limits"]["unsolved"] == 0
        assert cfg["limits"]["kkt"] == cfg["solver"]["eps_acc"]
        family = drivers.load(bdir, "problems", cfg["family"])
        for fn in ("dims", "make", "conic", "problem", "residuals",
                   "control"):
            assert callable(getattr(family, fn)), fn
    for w in m["workloads"]:
        mix = json.loads((bdir / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert drivers.load(bdir, "loops", mix["kind"]).Loop
        assert w["chips"] == 1
        for traced in (False, True):
            entries = harness.metrics_for(m, w["name"], traced)
            assert entries, (w["name"], traced)
            for e in entries:
                assert callable(harness.load_reader(bdir, e["name"]))
        assert "setup_s" in [e["name"] for e in
                             harness.metrics_for(m, w["name"], False)]


def _add(root, config, family=None, loop=None, mix=None, metric=None):
    """Files and manifest entries of a new cell ``<config>.<mix>``."""
    bdir = root / "h100bench"
    name, cfg = config
    (bdir / f"configs/{name}.json").write_text(json.dumps(cfg))
    for folder, piece in (("problems", family), ("loops", loop),
                          ("metrics", metric)):
        if piece:
            (bdir / folder / f"{piece[0]}.py").write_text(piece[1])
    (bdir / f"traffic/{mix[0]}.json").write_text(json.dumps(mix[1]))
    cell = f"{name}.{mix[0]}"
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": name, "source": "test", "reduced": [],
                         "file": f"h100bench/configs/{name}.json",
                         "why": "t"})
    m["workloads"].append({"name": cell, "config": name, "traffic": mix[0],
                           "chips": 1, "why": "t"})
    if metric:
        m["end_to_end"].append({"name": metric[0], "unit": "u",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return cell


def _files(root):
    return {p: p.read_bytes() for p in (root / "h100bench").rglob("*")
            if p.is_file()}


def test_new_pieces_found_by_name(tiny_root):
    """A configuration, a mix and a metric added as files, with entries in
    the manifest, run with no edit to any file already there."""
    before = _files(tiny_root)
    cfg = json.loads((tiny_root / "h100bench/configs/lp8.json").read_text())
    cfg.update(name="lp6", n=6, rows=24)
    cell = _add(tiny_root, ("lp6", cfg),
                mix=("fleet3", {"kind": "batch", "lanes": 3,
                                "check_per_batch": 2, "pool_batches": 2,
                                "warm_iters": 20, "trace_s": 1,
                                "solver": {"kernel": "auto"}}),
                metric=("lanes_done",
                        "def read(run):\n    return float(run.solved)\n"))
    line, run = _run(tiny_root, cell)
    assert line["correct"]
    assert line["metrics"]["lanes_done"]["value"] == run.solved > 0
    assert set(line["metrics"]) == {"lanes_done", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data


@pytest.mark.parametrize("spoil", [False, True])
def test_new_family_and_loop_found_by_name(tiny_root, monkeypatch, spoil):
    """A problem family that is no LP, with its own reference, and a loop
    kind of its own, added as files: the cell runs and its check holds
    the answers to the family's residuals (an answer spoilt where it is
    made comes out not correct)."""
    before = _files(tiny_root)
    cfg = {"name": "ball5", "family": "ball", "n": 5, "instance_seed": 3,
           "solver": {"profile": "fast", "eps_acc": 1e-3,
                      "max_iter": 20000},
           "check_chunk": 8, "limits": {"unsolved": 0, "kkt": 1e-3}}
    cell = _add(tiny_root, ("ball5", cfg), family=("ball", BALL),
                loop=("pairs", PAIRS),
                mix=("pairs2", {"kind": "pairs", "calls": 2}))
    if spoil:
        import totsu_tpu_torch

        real = totsu_tpu_torch.solve_jit

        def spoilt(*a, **k):
            res = real(*a, **k)
            res.x.mul_(0.9)
            return res
        monkeypatch.setattr(totsu_tpu_torch, "solve_jit", spoilt)
    line, run = _run(tiny_root, cell)
    assert line["attempted"] == 4 and len(run.records) == 4
    assert line["correct"] is (not spoil), line["compared"]
    for p, data in before.items():
        assert p.read_bytes() == data


def test_reader_of_the_stem(tiny_root):
    """``device_idle_pct.fleet`` and ``device_idle_pct.serve`` are read by
    ``metrics/device_idle_pct.py``; a file of the whole name wins."""
    bdir = tiny_root / "h100bench"
    a = harness.load_reader(bdir, "device_idle_pct.fleet")
    assert a is harness.load_reader(bdir, "device_idle_pct.serve")
    (bdir / "metrics/device_idle_pct.fleet.py").write_text(
        "def read(run):\n    return 1.0\n")
    assert harness.load_reader(bdir, "device_idle_pct.fleet")(None) == 1.0
    with pytest.raises(harness.BenchError):
        harness.load_reader(bdir, "no_such_metric.fleet")


@pytest.mark.parametrize("cell", [t[0] for t in TINY] + list(TWINS))
def test_tiny_cell_end_to_end(tiny_root, cell):
    line, run = _run(tiny_root, cell)
    assert list(line)[-1] == "compared"
    assert set(line) - {"compared", "breakdown"} == CONTRACT_KEYS
    assert line["correct"], line["compared"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    m = harness.load_manifest(tiny_root)
    want = {e["name"] for e in harness.metrics_for(m, cell, False)}
    assert set(line["metrics"]) == want
    for v in line["metrics"].values():
        assert math.isfinite(v["value"]) and v["value"] > 0
    assert len(run.records) >= 1
    json.dumps(line)


def test_traced_run_on_cpu_reports_no_device_metric(tiny_root):
    """Without a card no device metric is made up: the trace-sourced
    metrics are left out, the counters and host clocks stay."""
    line, _ = _run(tiny_root, "lp8.fleet256", traced=True)
    assert line["correct"]
    assert set(line["metrics"]) == {"iters_per_solve.fleet"}
    assert "breakdown" not in line


def test_instances_repeat_per_seed():
    cpu = torch.device("cpu")
    k = instances.key(SEED, 1, 3)
    assert k == instances.key(SEED, 1, 3)
    assert 0 <= k < 2**63
    assert k != instances.key(SEED, 1, 4) != instances.key(SEED + 1, 1, 3)
    cfg = {"n": 8}
    a = LP.make(cfg, 3, k, cpu)
    b = LP.make(cfg, 3, k, cpu)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = LP.make(cfg, 3, instances.key(SEED, 1, 4), cpu)
    assert not torch.equal(a[0], c[0])
    # another order of the same rows and columns
    p = LP.make(cfg, 3, k, cpu, perm_seed=5)
    q = LP.make(cfg, 3, k, cpu, perm_seed=6)
    assert torch.equal(p[0], LP.make(cfg, 3, k, cpu, 5)[0])
    assert not torch.equal(p[0], q[0])
    for j in range(3):
        assert torch.equal(p[0][j].flatten().sort()[0],
                           a[0][j].flatten().sort()[0])
        assert torch.equal(p[2][j].sort()[0], a[2][j].sort()[0])
    g, h, cc = a
    assert g.shape == (3, 16, 8) and h.shape == (3, 16) and cc.shape == (3, 8)
    assert g.dtype == torch.float32
    c2, amat, bvec = LP.conic(cfg, a)
    assert torch.equal(c2, cc)
    assert amat.shape == (3, 32, 8) and bvec.shape == (3, 32)
    assert torch.equal(amat[:, 16:24], torch.eye(8).expand(3, 8, 8))
    assert bool((bvec[:, 16:] == LP.BOX).all())
    sel = torch.tensor([2, 0])
    both = instances.cat([instances.take(a, sel), instances.take(b, sel)])
    assert torch.equal(both[0][1], a[0][0]) and torch.equal(both[0][2],
                                                            a[0][2])


def test_run_py_exits_without_a_card(tmp_path):
    """``run.py`` prints no result and exits non-zero where no card is
    visible (this sandbox has none)."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run(
        [sys.executable, str(REPO / "h100bench/run.py"), "--workload",
         "lp6000.single", "--seed", str(SEED), "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


@pytest.mark.h100
def test_run_py_on_the_card(cuda, tmp_path):
    out = subprocess.run(
        [sys.executable, str(REPO / "h100bench/run.py"), "--workload",
         "lp6000.single", "--seed", str(SEED), "--seconds", "2", "--trace",
         "0"], capture_output=True, text=True, cwd=REPO, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
