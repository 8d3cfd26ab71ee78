"""A traced run's profiler: ``torch.profiler`` over the first ``trace_s``
seconds of the window (at least one call), read in memory.

From the profiler's events it keeps, for the metric readers and the
result line:

* ``busy_s``: the union of the intervals in which anything ran on the
  device; ``window_s``: the traced stretch by the host's clock;
* ``kernels``: device seconds and launches by kernel name;
* ``device_ops``: the ten names with the most device time;
* ``idle_gaps``: the device's idle time, summed by what the host was
  doing at the middle of each gap (the innermost host event open there),
  the ten largest.
"""

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch

#: how far back, in host events, to look for one open at a gap
_LOOKBACK = 256


class Tracer:
    def __init__(self, enabled: bool, seconds: float):
        self.enabled = enabled
        self.seconds = seconds
        self.prof = None
        self.active = False
        self.t_start = None
        self.stop_time = None
        self.summary = None
        self.stop_s = 0.0

    def start(self):
        if not self.enabled:
            return
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.active = True
        self.t_start = time.perf_counter()

    def span(self, name: str):
        if self.active:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def tick(self, now: float) -> bool:
        """After a call that ended at ``now``: whether that call was
        traced; stops the profiler once the stretch is over."""
        if not self.active:
            return False
        if now - self.t_start >= self.seconds:
            self._stop()
        return True

    def _stop(self):
        torch.cuda.synchronize()
        self.stop_time = time.perf_counter()
        self.prof.stop()
        self.active = False
        self.stop_s = time.perf_counter() - self.stop_time

    def finish(self):
        if self.prof is None:
            return
        if self.active:
            self._stop()
        t = time.perf_counter()
        events = self.prof.profiler.kineto_results.events()
        self.summary = summarize(events, self.stop_time - self.t_start)
        self.summary["read_s"] = time.perf_counter() - t
        self.summary["events"] = len(events)
        self.prof = None


def _rows(events):
    """(device, host) lists of (start_ns, end_ns, name) from the kineto
    events: the device's operations (the harness's own spans, which the
    profiler mirrors onto the device's timeline, left out) and the
    host's."""
    device_type = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for ev in events:
        start, dur = ev.start_ns(), ev.duration_ns()
        if dur <= 0:
            continue
        row = (start, start + dur, ev.name())
        if ev.device_type() == device_type:
            if not ev.is_user_annotation():
                dev.append(row)
        else:
            host.append(row)
    return dev, host


def summarize(events, window_s: float) -> dict:
    dev, host = _rows(events)
    kernels = defaultdict(lambda: [0.0, 0])
    for s, e, name in dev:
        k = kernels[name]
        k[0] += (e - s) * 1e-9
        k[1] += 1
    busy = 0.0
    gaps = defaultdict(float)
    if dev:
        dev.sort()
        host.sort()
        h_start = np.array([h[0] for h in host], dtype=np.float64)
        h_end = np.array([h[1] for h in host], dtype=np.float64)
        lo = min([dev[0][0]] + ([host[0][0]] if host else []))
        cur_s, cur_e = dev[0][0], dev[0][1]
        spans = []
        for s, e, _ in dev[1:]:
            if s > cur_e:
                spans.append((cur_s, cur_e))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        spans.append((cur_s, cur_e))
        busy = sum(e - s for s, e in spans) * 1e-9
        edges = [(lo, spans[0][0])] + [(spans[i][1], spans[i + 1][0])
                                       for i in range(len(spans) - 1)]
        for a, b in edges:
            if b <= a:
                continue
            gaps[_host_at(host, h_start, h_end, 0.5 * (a + b))] += \
                (b - a) * 1e-9
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {
        "busy_s": busy,
        "window_s": window_s,
        "kernels": {k: (v[0], v[1]) for k, v in kernels.items()},
        "device_ops": [[k, v[0]] for k, v in top[:10]],
        "idle_gaps": [[k, v] for k, v in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
    }


def _host_at(host, h_start, h_end, t: float) -> str:
    """The innermost host event open at ``t`` (the latest start among
    those that cover it), or 'no host op' (the host between operations:
    Python, or a gap the profiler does not see)."""
    i = int(np.searchsorted(h_start, t, side="right")) - 1
    stop = max(-1, i - _LOOKBACK)
    while i > stop:
        if h_end[i] >= t:
            return host[i][2]
        i -= 1
    return "no host op"


def device_seconds(run, pattern: str = "") -> float:
    """Device seconds of the traced stretch's kernels whose name holds
    ``pattern`` (all of them for '')."""
    s = run.tracer.summary
    return sum(v[0] for k, v in s["kernels"].items() if pattern in k)


def launches(run, pattern: str = "") -> int:
    s = run.tracer.summary
    return sum(v[1] for k, v in s["kernels"].items()
               if pattern in k and not k.startswith("Memcpy")
               and not k.startswith("Memset"))
