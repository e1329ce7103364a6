"""Spans around the program's layers, and what a profiler trace says of
them.

``Spans`` wraps names in the program's solver modules (as a solver
adapter's ``SPANS`` lists them) in ``torch.profiler.record_function``
ranges named ``layer:<layer>``, and hands each call's arguments to the
layer readers' ``record`` hooks, which keep what their work arithmetic
needs (shapes, a weight tensor) without reading the device. A name that
is gone from its module raises: a traced run never reports a layer it did
not see.

``TraceView`` reads the profiler's Chrome trace: each kernel (and copy or
fill) on the device, the host launch call that queued it (by correlation
id), the spans whose host interval holds that launch, the device's busy
intervals inside the traced window, and the idle gaps between them named
by what the host was doing.
"""

import bisect
import gzip
import importlib
import json
import re
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = re.compile(r"Launch(Kernel|CooperativeKernel)|GraphLaunch")
WINDOW = "bench:window"


class Spans:
    """Context manager: targets {layer: [(module name, attribute)]},
    recorders {layer: [(key, record(args, kwargs))]}; `calls[key]` gets
    each call's record."""

    def __init__(self, targets, recorders):
        self.targets = targets
        self.recorders = recorders
        self.calls = defaultdict(list)
        self._saved = []

    def _wrap(self, layer, fn):
        import torch
        recs = [(self.calls[key], rec)
                for key, rec in self.recorders.get(layer, ())]
        name = f"layer:{layer}"

        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                for calls, rec in recs:
                    calls.append(rec(args, kwargs))
                return fn(*args, **kwargs)
        return wrapped

    def __enter__(self):
        try:
            for layer, names in self.targets.items():
                for mod_name, attr in names:
                    mod = importlib.import_module(mod_name)
                    if not hasattr(mod, attr):
                        raise RuntimeError(
                            f"span target {mod_name}.{attr} of layer "
                            f"{layer!r} is gone from the program")
                    fn = getattr(mod, attr)
                    self._saved.append((mod, attr, fn))
                    setattr(mod, attr, self._wrap(layer, fn))
        except Exception:
            self.__exit__()
            raise
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()


def _load(path):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Intervals:
    """Host intervals of one span name, sorted, for point lookups."""

    def __init__(self, events):
        ev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
        self.starts = [a for a, _ in ev]
        self.ends = [b for _, b in ev]

    def holds(self, ts):
        return self.around(ts) is not None

    def around(self, ts):
        """The length of the interval that holds ts, or None."""
        i = bisect.bisect_right(self.starts, ts) - 1
        if i >= 0 and ts <= self.ends[i]:
            return self.ends[i] - self.starts[i]
        return None


class TraceView:
    """What one traced window shows. Times in seconds."""

    def __init__(self, path):
        events = [e for e in _load(path) if e.get("ph") == "X"]
        windows = [e for e in events if e.get("name") == WINDOW
                   and e.get("cat") == "user_annotation"]
        if len(windows) != 1:
            raise RuntimeError(f"trace holds {len(windows)} '{WINDOW}' spans")
        w = windows[0]
        self.w0, self.w1 = w["ts"], w["ts"] + w["dur"]
        self.window_s = w["dur"] * 1e-6
        self.main_tid = w.get("tid")
        inside = [e for e in events if e["ts"] + e.get("dur", 0) >= self.w0
                  and e["ts"] <= self.w1]
        self.device = [e for e in inside if e.get("cat") in DEVICE_CATS]
        host = [e for e in inside
                if e.get("cat") in ("cuda_runtime", "cuda_driver")]
        self.launches = [e for e in host if LAUNCH.search(e["name"])]
        launch_ts = {}
        for e in host:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"]
        self.unmatched = 0
        self.launch_of = []
        for e in self.device:
            ts = launch_ts.get(e.get("args", {}).get("correlation"))
            self.unmatched += ts is None
            self.launch_of.append(ts)
        spans = defaultdict(list)
        self.host_ops = []
        for e in inside:
            if e.get("cat") == "user_annotation":
                spans[e["name"]].append(e)
                if e["name"] != WINDOW:
                    self.host_ops.append(e)
            elif e.get("cat") == "cpu_op" and e.get("tid") == self.main_tid:
                self.host_ops.append(e)
        self.spans = {k: _Intervals(v) for k, v in spans.items()}
        self.span_calls = {k: len(v) for k, v in spans.items()}
        self.host_ops.sort(key=lambda e: e["ts"])
        self._op_starts = [e["ts"] for e in self.host_ops]
        busy = _merge([(max(e["ts"], self.w0),
                        min(e["ts"] + e["dur"], self.w1)) for e in self.device])
        self.busy = [(a, b) for a, b in busy if b > a]
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-6

    def layer_device_s(self, layer):
        """Device seconds of the work launched inside the spans of `layer`,
        or None where the window holds no such span."""
        iv = self.spans.get(f"layer:{layer}")
        if iv is None:
            return None
        return 1e-6 * sum(e["dur"]
                          for e, ts in zip(self.device, self.launch_of)
                          if ts is not None and iv.holds(ts))

    def _host_at(self, ts):
        """The innermost layer span and host op running at `ts`."""
        held = [(d, name) for name, iv in self.spans.items()
                if name != WINDOW and (d := iv.around(ts)) is not None]
        layer = min(held)[1] if held else "no layer"
        i = bisect.bisect_right(self._op_starts, ts) - 1
        op = "python"
        for e in reversed(self.host_ops[max(0, i - 200):i + 1]):
            if e.get("cat") == "cpu_op" and e["ts"] + e["dur"] >= ts:
                op = e["name"]
                break
        return f"{layer} / {op}"

    def breakdown(self, top=10):
        by_kernel = defaultdict(float)
        for e in self.device:
            by_kernel[e["name"][:120]] += e["dur"] * 1e-6
        gaps = [(self.w0, self.busy[0][0])] if self.busy else []
        gaps += [(b, a2) for (_, b), (a2, _) in zip(self.busy, self.busy[1:])]
        gaps += [(self.busy[-1][1], self.w1)] if self.busy else []
        by_host = defaultdict(float)
        for a, b in gaps:
            if b > a:
                by_host[self._host_at(0.5 * (a + b))] += (b - a) * 1e-6
        return {
            "device_ops": sorted(([k, v] for k, v in by_kernel.items()),
                                 key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in by_host.items()),
                                key=lambda kv: -kv[1])[:top]}
