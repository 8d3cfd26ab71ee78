"""Run one cell of the benchmark once:

    python3 h100bench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout. Prints the compared numbers beside their
limits as the last lines of standard error, and the result line as the
last line of standard output; exits non-zero, printing no result, where
no card is visible or the run cannot be made.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches():
    """Every cache of a build or a compiler at a fixed path inside the
    checkout (the port builds its kernels into ``build/`` by itself)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    from h100bench import harness
    try:
        line, _ = harness.run_cell(ROOT, args.workload, args.seed,
                                   args.seconds, bool(args.trace), T_START)
    except harness.BenchError as err:
        print(f"h100bench: {err}", file=sys.stderr)
        return 2
    for text in harness.compared_lines(line["compared"]):
        print(text, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
