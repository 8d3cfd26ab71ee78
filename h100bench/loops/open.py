"""``kind: open``: Poisson arrivals at ``rate`` a second into one
``BatchRunner.submit``, a distinct instance each, each request timed
from when it was due. The arrivals are the same in every run (drawn
from the configuration's ``instance_seed``); every request's answer is
kept for the check."""

import time

import numpy as np

from h100bench import drivers

#: every batch tier the collector can form, warmed up before the window
TIERS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


class Loop(drivers.Driver):

    def setup(self, run):
        rate = float(self.mix["rate"])
        rng = np.random.default_rng([self.pool_seed, 11])
        gaps = rng.exponential(1.0 / rate, size=int(rate * run.seconds * 2
                                                    + 100))
        due = np.cumsum(gaps)
        self.due = due[due < run.seconds]
        count = len(self.due)
        self.pool_keys, data = self.make(drivers.STREAM_WINDOW, 0, count)
        self.c, self.a, self.b = self.conic(data)
        del data
        self.cone = self.family.problem(self.c[0], self.a[0], self.b[0])[3]
        warm = self.tt.BatchRunner(
            self.solver_param(max_iter=int(self.mix["warm_iters"])))
        _, wdata = self.make(drivers.STREAM_WARM, 0, 1)
        wc, wa, wb = self.conic(wdata)
        for tier in TIERS:
            warm.map([(wc[0], wa[0], wb[0], self.cone)] * tier)
        self.sync()
        self.runner = self.tt.BatchRunner(self.param)

    def window(self, run):
        count = len(self.due)
        done_at = [None] * count
        results = [None] * count
        futures = []

        def finisher(i):
            def cb(fut):
                done_at[i] = time.perf_counter()
                if fut.exception() is None:
                    results[i] = fut.result()
            return cb

        run.tracer.start()
        run.t0 = time.perf_counter()
        for i in range(count):
            due = run.t0 + float(self.due[i])
            now = time.perf_counter()
            if now < due:
                time.sleep(due - now)
            run.late.append(max(0.0, time.perf_counter() - due))
            fut = self.runner.submit((self.c[i], self.a[i], self.b[i],
                                      self.cone))
            fut.add_done_callback(finisher(i))
            futures.append(fut)
            run.tracer.tick(time.perf_counter())
        deadline = time.perf_counter() + drivers.LATE_S
        for fut in futures:
            try:
                fut.result(timeout=max(0.0, deadline - time.perf_counter()))
            except Exception:  # noqa: BLE001 - a failed request is counted
                pass
        run.t_close = max([t for t in done_at if t is not None],
                          default=time.perf_counter())
        traced_end = run.tracer.stop_time
        for i in range(count):
            due = run.t0 + float(self.due[i])
            run.attempted += 1
            r = results[i]
            if r is None or done_at[i] is None:
                run.failed += 1
                run.records.append(drivers.Record(self.pool_keys, count, i,
                                                  None, None, 0, 0))
                continue
            run.latencies.append(done_at[i] - due)
            run.spans.append(("submit", due, done_at[i]))
            run.iters.append(r.iters)
            if traced_end is not None and done_at[i] <= traced_end:
                run.traced_iters.append(r.iters)
            if r.status == 1:
                run.solved += 1
            else:
                run.failed += 1
            run.records.append(drivers.Record(self.pool_keys, count, i, r.x,
                                              r.y, r.status, r.iters))

    def release(self, run):
        self.runner = None
        self.a = self.b = self.c = None
