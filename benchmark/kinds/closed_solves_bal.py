"""Closed-loop batch solves of BAL problems, whose cameras carry their own
focal length and radial distortion: ``closed_solves`` with the intrinsics
as a third block of the state. One client; each solve starts from a fresh
perturbation of the true scene drawn from the run's seed (poses and points
from stream (seed, 1, i) as ``closed_solves`` draws them, the intrinsics
from stream (seed, 3, i): f (1 + N(0, f²)), k1 + N(0, k1²), k2 + N(0, k2²)
at the traffic's ``perturb_intrinsics``, the fixed cameras unmoved) and
runs ``lm_iters`` LM iterations; the next solve is sent when the last
one's result is on the host. A solve is timed from its call to its
synchronised result, and fails where its final cost is not finite or not
below the traffic's gate. The true intrinsics come from the scene family's
``intrinsics`` by the configuration's scene.

The check (a sample of the window's solves, drawn from the seed), against
``reference/lm_bal.py`` in float64 from the same start:

- ``step_cost_gap``: the widest |c_program - c_reference| after each of
  the first ``check.steps`` LM steps, over the start's cost;
- ``final_cost``: the reference's float64 cost of the program's final
  state.
"""

import math
import time

import torch

from benchmark.harness import loops, scenes
from benchmark.kinds import closed_solves
from benchmark.reference import lm_bal

UNIT = "solves"
QUANTITIES = ("iter_ms", "solve_ms_p95")
NUMBERS = ("step_cost_gap", "final_cost")


def true_intrinsics(config, device):
    """(C, 3) float64 [f, k1, k2] of the configuration's scene."""
    spec = dict(config["scene"])
    fam = scenes.load("scenes", spec.pop("kind"))
    return torch.as_tensor(fam.intrinsics(**spec), dtype=torch.float64,
                           device=device)


class Loop(closed_solves.Loop):
    def __init__(self, adapter, ctx, truth, traffic, config, seed, dtype,
                 scene):
        super().__init__(adapter, ctx, truth, traffic, config, seed, dtype,
                         scene)
        self.K = true_intrinsics(config, truth.R.device)

    def start(self, i):
        """The i-th solve's start (i = -1: the warm-up's), (R, t, K, X) in
        the program's dtype."""
        tr = self.truth
        R, t, X = scenes.perturbed_start(
            tr.R, tr.t, tr.X, tr.fixed, self.traffic["perturb"],
            scenes.stream_seed(self.seed, 1, i))
        lv = self.traffic["perturb_intrinsics"]
        gen = torch.Generator(device=tr.R.device).manual_seed(
            scenes.stream_seed(self.seed, 3, i))
        noise = torch.randn(self.K.shape, generator=gen, dtype=self.K.dtype,
                            device=self.K.device)
        noise = noise * torch.tensor([lv["f"], lv["k1"], lv["k2"]],
                                     dtype=self.K.dtype,
                                     device=self.K.device)
        noise = noise * (~tr.fixed)[:, None]
        K = torch.stack([self.K[:, 0] * (1.0 + noise[:, 0]),
                         self.K[:, 1] + noise[:, 1],
                         self.K[:, 2] + noise[:, 2]], dim=1)
        return tuple(x.to(self.dtype) for x in (R, t, K, X))

    def one(self, i):
        R0, t0, K0, X0 = self.start(i)
        loops._sync()
        t_call = time.perf_counter()
        out = self.adapter.solve(self.ctx, R0, t0, K0, X0, self.iters)
        cost = float(out.cost)
        loops._sync()
        return out, time.perf_counter() - t_call, cost


def _widen(*ts):
    return tuple(t.detach().to(torch.float64) for t in ts)


def outputs(loop, samples):
    """The sampled solves' outputs: (i, R, t, K, X, costs as floats)."""
    return [(i, *_widen(out.R, out.t, out.K, out.X),
             [float(c) for c in out.costs]) for i, out in samples]


def numbers(loop, scene, fixed, outputs, device, log):
    steps = int(loop.traffic["check"]["steps"])
    P = lm_bal.problem(scene.cam, scene.lm, scene.uv, scene.w, scene.n_cams,
                       scene.n_points, fixed, torch.float64, device)
    gaps, finals = [], []
    for i, R, t, K, X, prog in outputs:
        start = _widen(*loop.start(i))
        ref = lm_bal.solve(*start, P, steps,
                           lambda_init=float(loop.config["lambda_init"]))
        n = min(steps, len(prog) - 1, len(ref.costs) - 1)
        g = [abs(prog[s] - ref.costs[s]) / abs(ref.costs[0])
             for s in range(1, n + 1)]
        final = float(lm_bal.cost(R, t, K, X, P))
        log(f"solve {i}: costs program {[f'{c:.9e}' for c in prog[:n + 1]]}"
            f" reference {[f'{c:.9e}' for c in ref.costs[:n + 1]]}; gaps "
            f"{[f'{x:.3e}' for x in g]}; final {prog[-1]:.6e} (reference "
            f"{final:.6e}) after {len(prog) - 1}")
        gaps += g
        finals.append(final if math.isfinite(final) else math.inf)
    return {"step_cost_gap": max(gaps) if gaps else math.inf,
            "final_cost": max(finals)}


def _frozen_after(adapter, k):
    """The state stops changing after LM step k; the solve still reports
    every iteration."""
    real = adapter.solve

    def solve(ctx, R0, t0, K0, X0, iters):
        out = real(ctx, R0, t0, K0, X0, min(iters, k))
        pad = [out.costs[-1]] * (iters + 1 - len(out.costs))
        return out._replace(it=iters, costs=out.costs + pad)
    return closed_solves._wrapped(adapter, solve=solve)


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
