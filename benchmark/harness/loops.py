"""What the traffic generators share. Each kind of traffic is a module of
its own, ``kinds/<kind>.py``, found by the ``kind`` a traffic file names;
it offers:

- ``Loop(adapter, ctx, truth, traffic, config, seed, dtype, scene)``: the
  load the traffic file describes, driven through a solver adapter, with
  ``warm_up()``, ``run(seconds=...)`` or ``run(count=...)`` (a
  ``Window``) and ``metrics(window)``, a value for each end-to-end
  quantity it measures, by the name before the first dot of a metric;
- ``UNIT``, what ``Window.attempted`` counts, and ``NUMBERS``, the names
  of the numbers that decide ``correct``;
- ``outputs(loop, samples)``: the program's outputs that the check reads,
  taken before the program's state is freed, and ``numbers(loop, scene,
  fixed, outputs, device, log)``: the numbers that decide ``correct``;
- ``FAULTS``: {name: wrap(adapter, traffic)}, the faults that calibration
  reads and the tests plant, each an adapter with the timed path broken.

``kinds/closed_solves.py`` is the one kind so far.
"""

import time
from typing import NamedTuple

import numpy as np
import torch


class Truth(NamedTuple):
    """The true scene on the device, float64, and the gauge."""
    R: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor
    fixed: torch.Tensor


def truth(scene, fixed, device):
    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)
    return Truth(f64(scene.R), f64(scene.t), f64(scene.points),
                 torch.as_tensor(fixed, device=device))


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Reservoir:
    """A uniform sample of k of the items offered, drawn from a seed."""

    def __init__(self, k, seed):
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.items = []
        self.seen = 0

    def offer(self, item):
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


class Window(NamedTuple):
    window_s: float
    times_s: list        # each request's latency
    units: int           # the work it completed (LM iterations of solves)
    attempted: int
    failed: int
    samples: list        # what the check compares
    worst: float         # the program's own worst final cost


def run_until(one, seconds=None, count=None):
    """Call one(i) for i = 0, 1, ... until `seconds` have passed (checked
    before each call) or `count` calls are done: (window seconds, calls)."""
    i = 0
    t0 = time.perf_counter()
    while (count is None and time.perf_counter() - t0 < seconds) or (
            count is not None and i < count):
        one(i)
        i += 1
    return time.perf_counter() - t0, i
