"""Closed-loop batch solves: one client; each solve starts from a fresh
perturbation of the true scene drawn from the run's seed (stream (seed, 1,
i) for the i-th solve) and runs ``lm_iters`` LM iterations; the next solve
is sent when the last one's result is on the host. A solve is timed from
its call to its synchronised result, and fails where its final cost is
not finite or not below the traffic's gate.

The check (a sample of the window's solves, drawn from the seed):

- ``step_cost_gap``: the widest |c_program - c_reference| after each of
  the first ``check.steps`` LM steps, over the start's cost, the reference
  in float64 from the same start (the program's dtype, widened);
- ``final_cost``: the reference's float64 cost of the program's final
  state, which the later steps, unchecked by the first number, set.
"""

import math
import time
from types import SimpleNamespace

import torch

from benchmark.harness import loops, scenes, stats
from benchmark.reference import lm_ba

UNIT = "solves"
QUANTITIES = ("iter_ms", "solve_ms_p95")
NUMBERS = ("step_cost_gap", "final_cost")


class Loop:
    def __init__(self, adapter, ctx, truth, traffic, config, seed, dtype,
                 scene):
        self.adapter, self.ctx, self.truth = adapter, ctx, truth
        self.traffic, self.config, self.seed, self.dtype = (traffic, config,
                                                            seed, dtype)
        self.iters = int(traffic["lm_iters"])
        self.gate = float(traffic["gate"]["final_cost"])

    def start(self, i):
        """The i-th solve's start (i = -1: the warm-up's), in the
        program's dtype."""
        tr = self.truth
        R, t, X = scenes.perturbed_start(
            tr.R, tr.t, tr.X, tr.fixed, self.traffic["perturb"],
            scenes.stream_seed(self.seed, 1, i))
        return R.to(self.dtype), t.to(self.dtype), X.to(self.dtype)

    def one(self, i):
        R0, t0, X0 = self.start(i)
        loops._sync()
        t_call = time.perf_counter()
        out = self.adapter.solve(self.ctx, R0, t0, X0, self.iters)
        cost = float(out.cost)
        loops._sync()
        return out, time.perf_counter() - t_call, cost

    def warm_up(self):
        self.one(-1)

    def run(self, seconds=None, count=None):
        sample = loops.Reservoir(int(self.traffic["check"]["count"]),
                                 scenes.stream_seed(self.seed, 2))
        times, costs, iters = [], [], [0]

        def one(i):
            out, dt, cost = self.one(i)
            times.append(dt)
            costs.append(cost if math.isfinite(cost) else math.inf)
            iters[0] += out.it
            sample.offer((i, out))
        window_s, n = loops.run_until(one, seconds, count)
        failed = sum(not c < self.gate for c in costs)
        return loops.Window(window_s, times, iters[0], n, failed,
                            sample.items, max(costs))

    @staticmethod
    def metrics(win):
        return {"iter_ms": stats.per_unit_ms(win.window_s, win.units),
                "solve_ms_p95": 1e3 * stats.percentile(win.times_s, 95)}


def _widen(*ts):
    return tuple(t.detach().to(torch.float64) for t in ts)


def outputs(loop, samples):
    """The sampled solves' outputs: (i, R, t, X, costs as floats)."""
    return [(i, *_widen(out.R, out.t, out.X), [float(c) for c in out.costs])
            for i, out in samples]


def numbers(loop, scene, fixed, outputs, device, log):
    steps = int(loop.traffic["check"]["steps"])
    P = lm_ba.problem(scene.cam, scene.lm, scene.uv, scene.w, scene.n_cams,
                      scene.n_points, fixed, torch.float64, device)
    gaps, finals = [], []
    for i, R, t, X, prog in outputs:
        R0, t0, X0 = _widen(*loop.start(i))
        ref = lm_ba.solve(R0, t0, X0, P, steps,
                          lambda_init=float(loop.config["lambda_init"]))
        n = min(steps, len(prog) - 1, len(ref.costs) - 1)
        g = [abs(prog[s] - ref.costs[s]) / abs(ref.costs[0])
             for s in range(1, n + 1)]
        final = float(lm_ba.cost(R, t, X, P))
        log(f"solve {i}: costs program {[f'{c:.9e}' for c in prog[:n + 1]]}"
            f" reference {[f'{c:.9e}' for c in ref.costs[:n + 1]]}; gaps "
            f"{[f'{x:.3e}' for x in g]}; final {prog[-1]:.6e} (reference "
            f"{final:.6e}) after {len(prog) - 1}")
        gaps += g
        finals.append(final if math.isfinite(final) else math.inf)
    return {"step_cost_gap": max(gaps) if gaps else math.inf,
            "final_cost": max(finals)}


def _wrapped(adapter, **calls):
    ns = SimpleNamespace(**{k: getattr(adapter, k) for k in dir(adapter)
                            if not k.startswith("__")})
    for k, fn in calls.items():
        setattr(ns, k, fn)
    return ns


def _frozen_after(adapter, k):
    """The state stops changing after LM step k; the solve still reports
    every iteration."""
    real = adapter.solve

    def solve(ctx, R0, t0, X0, iters):
        out = real(ctx, R0, t0, X0, min(iters, k))
        pad = [out.costs[-1]] * (iters + 1 - len(out.costs))
        return out._replace(it=iters, costs=out.costs + pad)
    return _wrapped(adapter, solve=solve)


def frozen_at_check(adapter, traffic):
    """The state stops changing after the last step the step costs compare
    (check.steps): every compared step is sound."""
    return _frozen_after(adapter, int(traffic["check"]["steps"]))


def frozen_after_check(adapter, traffic):
    """The state stops changing after the first step the step costs do not
    compare (check.steps + 1)."""
    return _frozen_after(adapter, int(traffic["check"]["steps"]) + 1)


FAULTS = {"frozen_at_check": frozen_at_check,
          "frozen_after_check": frozen_after_check}
