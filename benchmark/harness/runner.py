"""One run of one cell: set-up, warm-up, the measured (or traced) window,
the check against the reference, and the result line.

``run_cell`` takes the device as an argument: ``run.py`` refuses to call it
without a CUDA card, and the CPU tests call it on the CPU at toy sizes.
"""

import gc
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from benchmark.harness import checks, loops, manifest, scenes, trace
from benchmark.solvers import common

FORBIDDEN = ("jax", "jaxlib", "flax", "slam_tricks_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot) is, whole,
    one of FORBIDDEN."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".")[0] in FORBIDDEN)


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


class TraceRun:
    """What a per-layer reader reads: the trace, the calls its spans
    recorded, and the units of work (LM iterations) the traced
    window completed."""

    def __init__(self, view, spans, win):
        self.view = view
        self._spans = spans
        self.units = win.units

    def calls(self, key):
        return self._spans.calls.get(key, [])


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def prepare(cell, seed, device, control=False, adapter=None, ctx=None,
            fault=None, marks=None):
    """(scene, fixed, adapter, ctx, loop) of one run: the scene, the
    program's inputs and layout (or the control's, or the `ctx` given, with
    its `adapter`), the traffic's loop drawn from `seed`; `fault` names one
    of the traffic kind's FAULTS planted in the adapter. `marks`, where
    given, gets (phase, clock) as each phase ends."""
    def mark(phase):
        if marks is not None:
            marks.append((phase, time.perf_counter()))
    cfg, tr = cell.config, cell.traffic
    dtype = getattr(torch, cfg["dtype"])
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(cfg.get("tf32", False))
    scene = scenes.make_scene(cfg["scene"])
    fixed = scenes.fixed_mask(scene.n_cams, cfg["gauge"])
    mark("scene")
    truth = loops.truth(scene, fixed, device)
    mark("device")
    if ctx is None:
        inputs = common.program_inputs(*scenes.padded(scene), scene.n_cams,
                                       scene.n_points, fixed, dtype, device)
        adapter = cell.adapter(control)
        ctx = adapter.setup(inputs, cfg, scene, fixed)
        if fault is not None:
            adapter = cell.kind.FAULTS[fault](adapter, tr)
    mark("layout")
    loop = cell.kind.Loop(adapter, ctx, truth, tr, cfg, seed, dtype, scene)
    return scene, fixed, adapter, ctx, loop


def numbers_of(cell, loop, scene, fixed, outputs, device, log):
    """The numbers that decide ``correct``, the reference in float32
    matmuls without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return cell.kind.numbers(loop, scene, fixed, outputs, device, log)


def run_cell(workload, seed, seconds, trace_on, device, t_start,
             control=False, limits=None, cell=None, log=_log):
    """The result dict of one run (what run.py prints as its last line).
    `cell` (a ``manifest.Cell``) stands in for the manifest's, `limits`
    for the cell's limits file."""
    cell = cell or manifest.Cell(workload)
    tr = cell.traffic
    unit = cell.kind.UNIT
    marks = [("start", t_start), ("imports", time.perf_counter())]
    scene, fixed, adapter, ctx, loop = prepare(cell, seed, device, control,
                                               marks=marks)
    loop.warm_up()
    loops._sync()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    phases = ", ".join(f"{b[0]} {b[1] - a[1]:.3f}"
                       for a, b in zip(marks, marks[1:]))
    log(f"[{workload}] set-up {setup_s:.3f} s ({phases}): C={scene.n_cams} "
        f"L={scene.n_points} observations={int((scene.w > 0).sum())}")

    metrics, breakdown, dev_extra = {}, None, {}
    if trace_on:
        readers = cell.readers()
        recorders = {}
        for r in readers.values():
            if hasattr(r, "record"):
                recorders.setdefault(r.LAYER, []).append((r.__name__,
                                                          r.record))
        spans = trace.Spans(adapter.SPANS, recorders)
        count = int(tr["trace"]["count"])
        from torch.profiler import ProfilerActivity, profile
        with spans, profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                win = loop.run(count=count)
                loops._sync()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            del prof
            view = trace.TraceView(path)
        log(f"[{workload}] traced {win.attempted} {unit}: "
            f"window {view.window_s:.4f} s, device busy {view.busy_s:.4f} s, "
            f"{len(view.device)} device ops ({view.unmatched} without a "
            f"host launch), {len(view.launches)} launch calls")
        run = TraceRun(view, spans, win)
        for p in cell.per_layer:
            value = readers[p["name"]].read(run)
            if value is not None:
                metrics[p["name"]] = {"value": value, "unit": p["unit"]}
        breakdown = view.breakdown()
        dev_extra = {"busy_s": view.busy_s, "window_s": view.window_s}
    else:
        win = loop.run(seconds=seconds)
        values = {**loop.metrics(win), "setup_s": setup_s}
        for e in cell.e2e:
            metrics[e["name"]] = {"value": values[manifest.stem(e["name"])],
                                  "unit": e["unit"]}
        log(f"[{workload}] window {win.window_s:.3f} s: {win.attempted} "
            f"{unit}, {win.units} units, {win.failed} failed, worst "
            f"{win.worst:.6e}; "
            + ", ".join(f"{k} {v['value']:.6g}" for k, v in metrics.items()))
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"forbidden modules loaded: {found}")

    # the program's outputs, then its state freed, then the reference
    outputs = cell.kind.outputs(loop, win.samples)
    loop.ctx = ctx = None
    win = win._replace(samples=None)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = numbers_of(cell, loop, scene, fixed, outputs, device, log)
    correct, table = checks.judge(
        numbers, limits if limits is not None else checks.limits_for(cell),
        win.failed)
    log(f"[{workload}] reference check {time.perf_counter() - t_check:.3f} s")

    result = {"correct": bool(correct), "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": 1, "memory_peak_bytes": int(peak),
                         "power_limit_w": (power_limit_w()
                                           if device.type == "cuda" else None),
                         **dev_extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control:
        result["control"] = "reference, float32 with TF32"
    result["checks"] = table
    for name, entry in table.items():
        v, lim = entry["value"], entry["limit"]
        log(f"check {name} {v!r} limit {lim!r}")
    return result
