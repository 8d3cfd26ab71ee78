"""The program's own ranges in a traced run, and what the device did under
each.

The port opens ``totsu.*`` profiler ranges (``totsu_tpu_torch/utils/
trace.py``: ``totsu.solve``, ``totsu.direct.cache``, ``totsu.loop.iterate``,
``totsu.loop.check``) while a torch profiler records. They are host events
on the profiler's clock, so :func:`summarize` can put the device's work
and idle down to them, from the same kineto events that
``trace.summarize`` reads:

* ``spans``: the program's ranges, ``(name, start_ns, end_ns)`` in order
  of start;
* ``span_kernels``: device seconds and launches by the innermost program
  range open on the host when each kernel was launched (the kernel's
  ``correlation_id()`` matched to its runtime launch event's; Memcpy and
  Memset apart, as in ``trace.launches``), ``outside`` where none was
  open, ``unlinked`` where the trace holds no launch event for it;
* ``span_idle``: the device's idle gaps (those of ``trace.summarize``, the
  first opening at the first host event other than an ATen op), by
  the innermost program range open at each gap's middle: ``totsu.solve``
  for its self time, ``outside`` where none is open;
* ``loop_stretch``: ``(idle_s, stretch_s)`` summed over the traced solves,
  each stretch running from the first to the last kernel launched under
  ``totsu.loop.iterate`` or ``totsu.loop.check`` inside one
  ``totsu.solve``; None where there is none.

The ranges nest on the one host thread that calls the program. A trace of
a program without ranges gives only ``outside`` (and ``unlinked``) and no
stretch, and the readers of these keys read nothing.

:func:`install` makes ``trace.summarize`` add these keys to a traced run's
summary, every key it had computed as before, and print the idle seconds
by range on standard error. The readers of these keys call it when they
are loaded, which the harness does before the run.
"""

import sys
import traceback

import numpy as np
import torch

from h100bench import trace

PREFIX = "totsu."
SOLVE = "totsu.solve"
LOOP = ("totsu.loop.iterate", "totsu.loop.check")
OUTSIDE = "outside"
UNLINKED = "unlinked"
#: the host's calls into the CUDA runtime and driver (``cudaLaunchKernel``,
#: ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...), whose correlation ids
#: are their kernels'; the ids of ATen ops are of another sequence
LAUNCH_PREFIX = "cu"


def _read(events):
    """One pass over the events: the device's rows (start, end, name,
    correlation id; the profiler's mirrors of host ranges left out, as in
    ``trace._rows``), the program's ranges, each correlation id's launch
    time on the host, and the earliest start on the host of an event
    other than an ATen op. ATen ops, half the events, are passed over on
    their name: each call into an event costs about a microsecond."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, spans, launch = [], [], {}
    host_lo = None
    for ev in events:
        name = ev.name()
        if name.startswith("aten::"):
            continue
        dur = ev.duration_ns()
        if dur <= 0:
            continue
        start = ev.start_ns()
        if ev.device_type() == cuda:
            if not ev.is_user_annotation():
                dev.append((start, start + dur, name, ev.correlation_id()))
            continue
        if host_lo is None or start < host_lo:
            host_lo = start
        if name.startswith(LAUNCH_PREFIX):
            corr = ev.correlation_id()
            if corr and (corr not in launch or start < launch[corr]):
                launch[corr] = start
        elif name.startswith(PREFIX) and ev.is_user_annotation():
            spans.append((start, start + dur, name))
    dev.sort()
    spans.sort(key=lambda s: (s[0], -s[1]))
    return dev, spans, launch, host_lo


def _innermost(spans, times):
    """Index into ``spans`` of the innermost range open at each of
    ``times`` (-1 where none is): the latest to start at or before it,
    or the nearest of its enclosing ranges that is still open."""
    times = np.asarray(times, dtype=np.int64)
    if not spans:
        return np.full(times.shape, -1, dtype=np.int64)
    starts = np.array([s[0] for s in spans], dtype=np.int64)
    ends = np.array([s[1] for s in spans], dtype=np.int64)
    parent = np.full(len(spans), -1, dtype=np.int64)
    stack = []
    for i, (s, e, _) in enumerate(spans):
        while stack and ends[stack[-1]] <= s:
            stack.pop()
        if stack:
            parent[i] = stack[-1]
        stack.append(i)
    idx = np.searchsorted(starts, times, side="right") - 1
    while True:
        closed = (idx >= 0) & (ends[np.maximum(idx, 0)] < times)
        if not closed.any():
            return idx
        idx = np.where(closed, parent[np.maximum(idx, 0)], idx)


def _merged(dev):
    """The union of the device rows' intervals, as (starts, ends)."""
    out = []
    for s, e, *_ in dev:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    arr = np.array(out, dtype=np.int64).reshape(-1, 2)
    return arr[:, 0], arr[:, 1]


def _busy_in(b_start, b_end, lo: int, hi: int) -> int:
    """Nanoseconds of the union inside [lo, hi]."""
    return int(np.clip(np.minimum(b_end, hi) - np.maximum(b_start, lo),
                       0, None).sum())


def _name(spans, i) -> str:
    return spans[i][2] if i >= 0 else OUTSIDE


def _by_label(labels, lab, weights):
    """Seconds and counts by label, for the labels that occur."""
    secs = np.bincount(lab, weights=weights, minlength=len(labels)) * 1e-9
    counts = np.bincount(lab, minlength=len(labels))
    return {labels[j]: (float(secs[j]), int(counts[j]))
            for j in range(len(labels)) if counts[j]}


def summarize(events) -> dict:
    dev, spans, launch, host_lo = _read(events)
    out = {"spans": [(n, s, e) for s, e, n in spans], "span_kernels": {},
           "span_idle": {}, "loop_stretch": None}
    if not dev:
        return out
    # label 0 is outside every range, 1 a kernel with no launch event
    labels = [OUTSIDE, UNLINKED] + sorted({n for _, _, n in spans})
    span_label = np.array([labels.index(n) for _, _, n in spans] or [0],
                          dtype=np.int64)

    def label_at(times):
        i = _innermost(spans, times)
        return np.where(i >= 0, span_label[np.maximum(i, 0)], 0)

    kern = [d for d in dev if not d[2].startswith(("Memcpy", "Memset"))]
    k_start = np.array([d[0] for d in kern], dtype=np.int64)
    k_end = np.array([d[1] for d in kern], dtype=np.int64)
    at = np.array([launch.get(d[3], -1) for d in kern], dtype=np.int64)
    lab = np.where(at < 0, 1, label_at(at))
    out["span_kernels"] = _by_label(labels, lab, k_end - k_start)

    b_start, b_end = _merged(dev)
    lo = dev[0][0] if host_lo is None else min(dev[0][0], host_lo)
    gap_lo = np.concatenate([[lo], b_end[:-1]])
    gap_hi = b_start
    keep = gap_hi > gap_lo
    gap_lo, gap_hi = gap_lo[keep], gap_hi[keep]
    out["span_idle"] = {k: v[0] for k, v in _by_label(
        labels, label_at((gap_lo + gap_hi) // 2), gap_hi - gap_lo).items()}

    in_loop = np.isin(lab, [labels.index(n) for n in LOOP if n in labels])
    idle_ns = stretch_ns = 0
    for s, e, name in spans:
        if name != SOLVE:
            continue
        mine = in_loop & (at >= s) & (at <= e)
        if not mine.any():
            continue
        a, b = int(k_start[mine].min()), int(k_end[mine].max())
        stretch_ns += b - a
        idle_ns += (b - a) - _busy_in(b_start, b_end, a, b)
    if stretch_ns > 0:
        out["loop_stretch"] = (idle_ns * 1e-9, stretch_ns * 1e-9)
    return out


def note(extra: dict) -> str:
    """The idle and device seconds by range, one line."""
    idle = " ".join(f"{k} {v:.3f}" for k, v in sorted(
        extra["span_idle"].items(), key=lambda kv: -kv[1]))
    busy = " ".join(f"{k} {v[0]:.3f}" for k, v in sorted(
        extra["span_kernels"].items(), key=lambda kv: -kv[1][0]))
    return f"idle_s by span: {idle or '-'}; device_s by span: {busy or '-'}"


def install():
    """Make ``trace.summarize`` add :func:`summarize`'s keys (once)."""
    if hasattr(trace.summarize, "plain"):
        return
    plain = trace.summarize

    def with_spans(events, window_s):
        out = plain(events, window_s)
        try:
            extra = summarize(events)
        except Exception:  # the run's line must come: its readers read None
            traceback.print_exc()
            return out
        out.update(extra)
        print("h100bench: " + note(extra), file=sys.stderr)
        return out

    with_spans.plain = plain
    trace.summarize = with_spans


def under(run, name: str):
    """(device seconds, launches) of the kernels launched under range
    ``name`` in the traced stretch, or None where it has none (a run
    without a trace, a program without the range)."""
    s = run.tracer.summary
    return None if s is None else s.get("span_kernels", {}).get(name)
