"""``kind: batch``: a closed loop of batches, each ``lanes`` distinct
instances through ``totsu_tpu_torch.parallel.batch.solve_batch``,
cycling over ``pool_batches`` batches of the configuration's instances;
``check_per_batch`` random lanes and the slowest of each batch are kept
for the check."""

import time

import numpy as np

from h100bench import drivers


class Loop(drivers.Driver):

    def setup(self, run):
        self.lanes = int(self.mix["lanes"])
        self.sample = int(self.mix["check_per_batch"])
        self.pool = int(self.mix["pool_batches"])
        _, data = self.make(drivers.STREAM_WARM, 0, self.lanes)
        c, a, b = self.conic(data)
        self.cone = self.family.problem(c[0], a[0], b[0])[3]
        warm = self.solver_param(max_iter=int(self.mix["warm_iters"]))
        out = self.tt.parallel.batch.solve_batch(c, a, b, self.cone, warm)
        out.status.tolist()
        self.rng = np.random.default_rng([self.seed, 7])

    def window(self, run):
        solve_batch = self.tt.parallel.batch.solve_batch
        run.tracer.start()
        run.t0 = time.perf_counter()
        end = run.t0 + run.seconds
        last = 0.0
        index = 0
        while self.keep_going(end, last):
            k, data = self.make(drivers.STREAM_WINDOW, index, self.lanes,
                                index % self.pool)
            c, a, b = self.conic(data)
            del data
            t1 = time.perf_counter()
            with run.tracer.span("h100bench.solve_batch"):
                out = solve_batch(c, a, b, self.cone, self.param)
                status = out.status.tolist()
                iters = out.iters.tolist()
            t2 = time.perf_counter()
            last = t2 - t1
            run.spans.append(("solve_batch", t1, t2))
            traced = run.tracer.tick(t2)
            run.attempted += self.lanes
            ok = sum(1 for s in status if s == 1)
            run.solved += ok
            run.failed += self.lanes - ok
            run.iters.extend(iters)
            if traced:
                run.traced_iters.extend(iters)
            pick = set(self.rng.choice(self.lanes, self.sample,
                                       replace=False).tolist())
            pick.add(int(np.argmax(iters)))
            for j in sorted(pick):
                run.records.append(drivers.Record(
                    k, self.lanes, j, out.x[j].clone(), out.y[j].clone(),
                    status[j], iters[j]))
            index += 1
        run.t_close = time.perf_counter()
