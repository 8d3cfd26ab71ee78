"""``kind: single``: one closed-loop client calling
``totsu_tpu_torch.solve``, on the next of ``pool`` instances each call
(``"instances": "fresh"``) or on one instance solved cold again and
again (``"repeat"``). Every answer is kept for the check."""

import time

from h100bench import drivers


class Loop(drivers.Driver):

    def setup(self, run):
        self.fresh = self.mix["instances"] == "fresh"
        self.pool = int(self.mix.get("pool", 1))
        warm = self.solver_param(max_iter=int(self.mix["warm_iters"]))
        stream = drivers.STREAM_WARM if self.fresh else drivers.STREAM_WINDOW
        k, data = self.make(stream, 0, 1)
        prob = self._problem(data)
        self.tt.solve_jit(*prob, warm)
        self.sync()
        if not self.fresh:
            self.key, self.prob = k, prob

    def _problem(self, data):
        c, a, b = self.conic(data)
        return self.family.problem(c[0], a[0], b[0])

    def window(self, run):
        tt = self.tt
        run.tracer.start()
        run.t0 = time.perf_counter()
        end = run.t0 + run.seconds
        last = 0.0
        index = 0
        while self.keep_going(end, last):
            if self.fresh:
                k, data = self.make(drivers.STREAM_WINDOW, index, 1,
                                    index % self.pool)
                prob = self._problem(data)
                del data
                self.sync()
            else:
                k, prob = self.key, self.prob
            t1 = time.perf_counter()
            with run.tracer.span("h100bench.solve"):
                try:
                    res = tt.solve(*prob, self.param)
                    x, y, status, iters = res.x, res.y, res.status, res.iters
                except tt.SolverError as err:
                    x = y = None
                    status, iters = int(err.status), 0
                if x is not None:
                    x.view(-1)[:1].tolist()   # the answer on the host
            t2 = time.perf_counter()
            last = t2 - t1
            run.spans.append(("solve", t1, t2))
            run.latencies.append(t2 - t1)
            traced = run.tracer.tick(t2)
            run.attempted += 1
            if status == 1:
                run.solved += 1
            else:
                run.failed += 1
            run.iters.append(iters)
            if traced:
                run.traced_iters.append(iters)
            run.records.append(drivers.Record(k, 1, 0, x, y, status, iters))
            index += 1
        run.t_close = time.perf_counter()

    def release(self, run):
        self.prob = None
