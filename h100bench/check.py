"""The check that decides ``correct``: every answer the window kept
(``Run.records``) against the plain reference, on the same inputs made
again from their keys.

Compared, each against the limit in the configuration's ``limits``:

* ``unsolved``: answers due that are not CONVERGED or never came. Every
  instance has an optimum, so the limit is 0;
* ``kkt``: the largest residual of the family's reference
  (``problems/<family>.py``'s ``residuals``: for the dense LP the primal
  violation, the dual residual, y's distance from its cone and the gap,
  in float64) over all answers. The configuration states the tolerance
  its answers are held to (``eps_acc``), and that is the limit.

It runs after the window, in chunks of ``check_chunk`` answers, once
the program's state is freed.
"""

import time

import torch


def worst(residuals: dict):
    """(B,): the largest of an answer's residuals."""
    return torch.stack(list(residuals.values())).amax(0)


def judge(run, driver, config: dict) -> dict:
    """``{"correct": bool, "compared": {name: {"value", "limit"}}}`` for
    the run's records."""
    t = time.perf_counter()
    limits = config["limits"]
    recs = run.records
    answered = [r for r in recs if r.x is not None]
    unsolved = sum(1 for r in recs if r.x is None or r.status != 1)
    chunk = int(config["check_chunk"])
    worst_kkt = 0.0
    for i in range(0, len(answered), chunk):
        part = answered[i:i + chunk]
        data = driver.inputs(part)
        x = torch.stack([r.x for r in part]).to(data[0].device)
        y = torch.stack([r.y for r in part]).to(data[0].device)
        res = driver.family.residuals(config, data, x, y)
        worst_kkt = max(worst_kkt, float(worst(res).max()))
        del data, x, y, res
    compared = {"unsolved": {"value": unsolved, "limit": limits["unsolved"]},
                "kkt": {"value": worst_kkt, "limit": limits["kkt"]}}
    correct = (len(recs) >= 1 and unsolved <= limits["unsolved"]
               and worst_kkt <= limits["kkt"])
    return {"correct": bool(correct), "compared": compared,
            "answers": len(recs), "seconds": time.perf_counter() - t}
