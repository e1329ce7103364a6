"""Scoped wall-clock timing with device synchronization — the ns_timer role
(reference: artwork timer usage around each solver call, e.g.
st17-ceres/src/include/solver.hpp:253-288), port of
``slam_tricks_tpu/utils/timer.py``. CUDA runs asynchronously: a lap, a
``timed`` block and ``time_fn`` first wait for the CUDA device of every
tensor they are given (``torch.cuda.synchronize(device)``) and only then
read the clock, so timings are real. Tensors on the CPU need no wait.

``annotate`` is the package's one span: the solvers open it at their layer
boundaries (``slam:*`` names, PERF.md §3), and it costs one check of the
profiler's state where no profiler runs.
"""

import os
import time
from contextlib import contextmanager, nullcontext

import torch

_NO_SPAN = nullcontext()


def synchronize(tree):
    """Wait for the CUDA device of every tensor in the nest `tree` (tensors,
    NamedTuples, tuples, lists, dicts). Returns `tree`."""
    # imported here: the solvers import this module for `annotate`
    from slam_tricks_tpu_torch.solvers.common import leaves
    for device in {x.device for x in leaves(tree) if x.is_cuda}:
        torch.cuda.synchronize(device)
    return tree


class Timer:
    """t = Timer(); ...; t.lap("stage", sync=out); print(t.report())"""

    def __init__(self):
        self._t0 = time.perf_counter()
        self.laps = []

    def re_start(self):
        self._t0 = time.perf_counter()

    def lap(self, tag, sync=None):
        """Seconds since the last lap (or the start), after waiting for the
        CUDA devices of the tensors in `sync`."""
        if sync is not None:
            synchronize(sync)
        now = time.perf_counter()
        self.laps.append((tag, now - self._t0))
        self._t0 = now
        return self.laps[-1][1]

    def report(self):
        return " | ".join(f"{tag}: {dt * 1e3:.3f} ms" for tag, dt in self.laps)


@contextmanager
def timed(tag="block", out=None, log=None):
    """with timed("solve", out=result): ... — waits for `out`'s CUDA devices
    at exit."""
    t0 = time.perf_counter()
    yield
    if out is not None:
        synchronize(out)
    dt = time.perf_counter() - t0
    msg = f"{tag}: {dt * 1e3:.3f} ms"
    if log is not None:
        log.process(msg)
    else:
        print(msg)


@contextmanager
def profile_trace(log_dir, *, host_profiler=False):
    """torch.profiler trace of the body (SURVEY §5 tracing/profiling): CPU
    activity, and CUDA activity where a CUDA device is present; a Chrome
    trace file (``trace.json``, open in Perfetto or chrome://tracing) is
    written into `log_dir` at exit. With host_profiler, Python call stacks
    are recorded too. Yields the profiler. Usage:

        with profile_trace("/tmp/trace"):
            with annotate("solve"):
                out = solve(...)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, with_stack=host_profiler) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name):
    """Named region for profiler timelines (TraceAnnotation role): a
    ``record_function`` range, a host event on the profiler's timeline
    beside the device's kernels, while a profiler runs; a shared no-op
    context otherwise, since entering and leaving a ``record_function``
    costs ~8 us with no profiler to record it, and this ~1 us."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


def time_fn(fn, *args, warmup=1, reps=5):
    """Warm up, then time `fn(*args)`; each call waits for the CUDA devices
    of its result. Returns (best_seconds, result)."""
    result = None
    for _ in range(max(warmup, 1)):
        result = synchronize(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        result = synchronize(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, result
