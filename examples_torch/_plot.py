"""Optional matplotlib plotting for the examples (port of
``examples/_plot.py``): ``--plot`` (or ``TOTSU_PLOT=1``) saves PNGs next
to the script. matplotlib is imported only then, and its absence raises:
a machine without it (the card's host) runs the examples without
``--plot``."""

import os
import sys


def enabled() -> bool:
    return "--plot" in sys.argv or os.environ.get("TOTSU_PLOT") == "1"


def pyplot():
    """matplotlib's pyplot on the Agg backend; raises when matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError as exc:
        raise RuntimeError("--plot needs matplotlib, which is not "
                           "installed; run without --plot") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def save(fig, name: str):
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), name)
    fig.savefig(out, dpi=110, bbox_inches="tight")
    print(f"  plot saved: {out}")
