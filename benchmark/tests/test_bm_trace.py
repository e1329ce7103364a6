"""The trace reader on a synthetic profiler trace, and the spans on a toy
module."""

import json
import types

import pytest

from benchmark.harness import trace


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


@pytest.fixture
def view(tmp_path):
    ev = [
        _x(trace.WINDOW, "user_annotation", 0, 100),
        _x(trace.WINDOW, "gpu_user_annotation", 0, 100, tid=7),
        _x("layer:assemble", "user_annotation", 10, 20),
        _x("aten::mul", "cpu_op", 12, 5),
        _x("cudaLaunchKernel", "cuda_runtime", 13, 1, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 40, 1, correlation=2),
        _x("layer:rcs", "user_annotation", 50, 30),
        _x("aten::add", "cpu_op", 55, 20),
        _x("cudaGraphLaunch", "cuda_runtime", 60, 1, correlation=3),
        _x("k1", "kernel", 20, 10, tid=7, correlation=1),
        _x("k2", "kernel", 45, 5, tid=7, correlation=2),
        _x("k3", "kernel", 70, 20, tid=7, correlation=3),
        _x("late", "kernel", 150, 20, tid=7, correlation=9),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.TraceView(path)


def test_window_busy_and_launches(view):
    assert view.window_s == pytest.approx(100e-6)
    assert view.busy_s == pytest.approx(35e-6)        # k1 + k2 + k3
    assert len(view.launches) == 3


def test_device_time_goes_to_the_span_that_launched_it(view):
    assert view.layer_device_s("assemble") == pytest.approx(10e-6)
    assert view.layer_device_s("rcs") == pytest.approx(20e-6)
    assert view.layer_device_s("backsub") is None


def test_idle_gaps_are_named_by_the_host(view):
    gaps = dict(view.breakdown()["idle_gaps"])
    assert gaps["layer:rcs / aten::add"] == pytest.approx(20e-6)   # 50..70
    assert gaps["layer:assemble / python"] == pytest.approx(20e-6)  # 0..20
    # 30..45 and 90..100
    assert gaps["no layer / python"] == pytest.approx(25e-6)
    ops = dict(view.breakdown()["device_ops"])
    assert ops["k3"] == pytest.approx(20e-6)


def test_spans_wrap_and_restore_and_refuse_a_missing_name():
    mod = types.ModuleType("toy_mod")
    mod.f = lambda x, y=1: x + y
    import sys
    sys.modules["toy_mod"] = mod
    try:
        spans = trace.Spans({"toy": [("toy_mod", "f")]},
                            {"toy": [("rec", lambda a, kw: a[0])]})
        with spans:
            assert mod.f(3) == 4 and mod.f(5, y=2) == 7
        assert spans.calls["rec"] == [3, 5]
        assert mod.f(1) == 2 and not hasattr(mod.f, "__wrapped__")
        with pytest.raises(RuntimeError, match="gone"):
            with trace.Spans({"toy": [("toy_mod", "g")]}, {}):
                pass
    finally:
        del sys.modules["toy_mod"]


def test_layer_readers_read_nothing_from_an_empty_trace(tmp_path):
    from benchmark.harness import manifest
    ev = [_x(trace.WINDOW, "user_annotation", 0, 100)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps(ev))
    view = trace.TraceView(path)
    run = types.SimpleNamespace(view=view, units=10, calls=lambda key: [])
    for name in ("assemble_roofline_pct.st20", "rcs_ms_per_iter.ladybug",
                 "spd_solve_roofline_pct", "tridiag_roofline_pct",
                 "launches_per_iter.st20"):
        assert manifest.load_reader(name).read(run) is None, name
