"""Readings that set the limits of the check (``check.py``), on the
card, at a cell's own size:

    python3 h100bench/control.py --workload <cell> --seconds <s> \
        --seeds <a,b,...> [--control-seeds <x,y,z>] [--out <file.json>]

For each of ``--seeds`` it runs the cell (a window of ``--seconds``)
and reads the program's numbers over every answer the window kept: each
residual of the family's reference, ``kkt`` (their largest) and
``unsolved``. For each of ``--control-seeds`` it puts the control (the
family's ``control``: the reference one precision down) in the
program's place on the same instances and reads the same numbers.

``--config <name> --traffic <mix>`` in place of ``--workload`` runs a
cell that the manifest does not list, and ``--mix-over <json>`` replaces
parameters of the mix (another route of the program, as a witness on
the same instances). The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def readings(recs, driver, solve=None):
    """The numbers over ``recs``: the program's answers, or with
    ``solve`` the answers ``solve(data)`` gives on the same inputs."""
    import torch
    worst = {"kkt": 0.0}
    unsolved = sum(1 for r in recs if r.x is None or r.status != 1)
    answered = [r for r in recs if r.x is not None] if solve is None \
        else list(recs)
    config = driver.config
    chunk = int(config["check_chunk"])
    for i in range(0, len(answered), chunk):
        part = answered[i:i + chunk]
        data = driver.inputs(part)
        if solve is None:
            x = torch.stack([r.x for r in part]).to(data[0].device)
            y = torch.stack([r.y for r in part]).to(data[0].device)
        else:
            x, y = solve(data)
        res = driver.family.residuals(config, data, x, y)
        res["kkt"] = torch.stack(list(res.values())).amax(0)
        for name, v in res.items():
            worst[name] = max(worst.get(name, 0.0), float(v.max()))
    worst["unsolved"] = unsolved if solve is None else 0
    worst["answers"] = len(answered)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="")
    ap.add_argument("--config", default="")
    ap.add_argument("--traffic", default="")
    ap.add_argument("--mix-over", default="{}")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from h100bench import harness
    cell = None
    if not args.workload:
        cell = {"name": f"{args.config}.{args.traffic}",
                "config": args.config, "traffic": args.traffic, "chips": 1}
    name = args.workload or cell["name"]
    mix_over = json.loads(args.mix_over)
    out = {"workload": name, "mix_over": mix_over, "program": {},
           "control": {}}
    ctl_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in [int(s) for s in args.seeds.split(",")]:
        line, run = harness.run_cell(ROOT, name, seed, args.seconds, False,
                                     T_START, keep_run=True, cell=cell,
                                     mix_over=mix_over)
        driver = run.driver
        reading = readings(run.records, driver)
        reading["correct"] = line["correct"]
        reading["iters_max"] = max(run.iters) if run.iters else 0
        out["program"][seed] = reading
        print("program", seed, json.dumps(reading), flush=True)
        if seed in ctl_seeds:
            ctl = readings(run.records, driver,
                           lambda data: driver.family.control(driver.config,
                                                              data))
            out["control"][seed] = ctl
            print("control", seed, json.dumps(ctl), flush=True)
        del run, driver
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
