"""Time kernel J (the Jacobi PSD projection, ``csrc/psd_jacobi.cu``) at
phase 23's shapes of ``chip_smoke.py``.

    python3 jacobi_timing.py [--root DIR] [--shapes K,COUNT ...] [--sweep]

Imports ``chip_smoke`` and ``totsu_tpu_torch`` from ``DIR`` (default:
this script's directory), so that two trees, for example a commit and its
parent unpacked with ``git archive``, can be timed on one card one after
the other (parent, change, change, parent). Runs that tree's
``chip_smoke.psd_jacobi_phase`` at ``PHASE23_SHAPES`` (or ``--shapes``),
in f32 and f64, without the layout switches: per shape the kernel's error
against its plain version, a bitwise repeat, its time by CUDA events
behind a sleeping stream, the plain version's, ``torch.linalg.eigh`` +
clamp + rebuild (profiler device and wall), 'ns' and the bound, with the
plan where the tree prints one. ``--sweep`` (a tree with clusters) times,
at each shape, every cluster size that fits, with A whole in each CTA
and split over the cluster, and a few thread counts, forced through
``psd_jacobi.PLAN_OVERRIDES``, each held against the plain version.
Prints one JSON line with the card's name and power limit. Needs a CUDA
device.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def sweep(cs, pj, dev, shapes):
    """Every fitting layout and a few thread counts at each shape."""
    import numpy as np
    import torch
    rows = []
    rng = np.random.default_rng(23)
    layouts = [(c, sp, t) for c in pj.CLUSTERS
               for sp in (False, True)[:1 + (c > 1)]
               for t in (None, 128, 256, 512)]
    for k, cnt in shapes:
        for dt in (torch.float32, torch.float64):
            tag = str(dt)[6:]
            v = torch.tensor(rng.normal(size=(cnt, k * (k + 1) // 2)),
                             dtype=dt, device=dev)
            scale = float(torch.linalg.vector_norm(v, dim=1).max())
            plain = pj.proj_psd_jacobi_plain(v)
            pj.PLAN_OVERRIDES.clear()
            base = pj.device_plan(k, cnt, dt, dev)
            for c, sp, t in layouts:
                pj.PLAN_OVERRIDES.clear()
                pj.PLAN_OVERRIDES.update(cluster=c, split=sp)
                if t is not None:
                    pj.PLAN_OVERRIDES["threads"] = t
                try:
                    pl = pj.device_plan(k, cnt, dt, dev)
                except ValueError:
                    continue  # does not fit
                if any(r["plan"] == pl.describe() and r["dtype"] == tag
                       for r in rows):
                    continue  # the plan's own thread count again
                row = dict(k=k, count=cnt, dtype=tag, cluster=c, split=sp,
                           threads=pl.threads, picked=pl == base,
                           plan=pl.describe())
                try:
                    out = pj.proj_psd_jacobi_cuda(v)
                except RuntimeError as e:  # cannot be scheduled
                    rows.append(dict(row, error=str(e)))
                    continue
                again = pj.proj_psd_jacobi_cuda(v)
                row.update(
                    ms=cs.stream_ms(lambda: pj.proj_psd_jacobi_cuda(v),
                                    5 if k >= 128 else 20),
                    rel=float((out - plain).abs().max()) / scale,
                    bitwise=bool(torch.equal(out, again)))
                rows.append(row)
                print(json.dumps(row), file=sys.stderr, flush=True)
    pj.PLAN_OVERRIDES.clear()
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="K,COUNT pairs (default: PHASE23_SHAPES)")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("jacobi_timing.py: no CUDA device")
    import chip_smoke as cs
    from totsu_tpu_torch.ops.kernels import _build
    from totsu_tpu_torch.ops.kernels import psd_jacobi as pj
    if not cs.__file__.startswith(root):
        sys.exit(f"jacobi_timing.py: imported {cs.__file__}, not {root}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    _build.build(["psd_jacobi"])
    cs.print_ptxas("psd_jacobi", _build.library_path("psd_jacobi"))
    shapes = (cs.PHASE23_SHAPES if args.shapes is None else
              [tuple(int(x) for x in s.split(",")) for s in args.shapes])
    result = {"root": root, "card": card, "torch": torch.__version__}
    if args.sweep:
        result["sweep"] = sweep(cs, pj, dev, shapes)
    else:
        kw = ({"switches": False} if "switches" in inspect.signature(
            cs.psd_jacobi_phase).parameters else {})
        rows = cs.psd_jacobi_phase(dev, shapes, **kw)
        result["rows"] = [
            dict(k=k, count=c, dtype=str(d)[6:], ms=r["ms"],
                 plain_ms=r["plain_ms"], lib_ms=r["lib_ms"],
                 lib_wall=r["lib_wall"], ns_ms=r["ns_ms"],
                 bound_ms=r["bound"][0], rel=r["rel"], plan=r.get("plan"))
            for (k, c, d), r in rows.items()]
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
