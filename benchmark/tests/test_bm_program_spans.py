"""The readers of the program's own spans (``slam:*``: the LM loop's
iteration, its stop-flag sync, the retract and the back-substitution) on a
synthetic profiler trace, nested as the program nests them, and on a trace
without them."""

import json
import types

import pytest

from benchmark.harness import manifest, trace

NAMES = ("lm_host_ms_per_iter", "sync_wait_ms_per_iter",
         "backsub_retract_ms_per_iter")


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _launch(ts, corr, kernel_ts, kernel_dur):
    return [_x("cudaLaunchKernel", "cuda_runtime", ts, 1, correlation=corr),
            _x(f"k{corr}", "kernel", kernel_ts, kernel_dur, tid=7,
               correlation=corr)]


def _iteration(t0, corr):
    """One LM iteration at host time t0 (100 us): solve (rcs, linear solve,
    back-substitution), retract, the trial's linearization, accept, and
    the stop flag's sync, with a kernel launched in most of them."""
    c = corr
    return [
        _x("slam:lm.iter", "user_annotation", t0, 100),
        _x("slam:lm.solve", "user_annotation", t0 + 2, 40),
        _x("slam:rcs", "user_annotation", t0 + 3, 15),
        *_launch(t0 + 4, c, t0 + 20, 6),
        _x("slam:linear_solve", "user_annotation", t0 + 20, 10),
        *_launch(t0 + 21, c + 1, t0 + 30, 3),
        _x("slam:backsub", "user_annotation", t0 + 31, 10),
        *_launch(t0 + 32, c + 2, t0 + 40, 2),      # back-substitution
        *_launch(t0 + 35, c + 3, t0 + 43, 1),      # back-substitution
        _x("slam:lm.retract", "user_annotation", t0 + 43, 12),
        *_launch(t0 + 45, c + 4, t0 + 50, 4),      # retract
        _x("slam:lm.linearize", "user_annotation", t0 + 56, 15),
        *_launch(t0 + 57, c + 5, t0 + 60, 5),
        _x("slam:lm.accept", "user_annotation", t0 + 72, 10),
        *_launch(t0 + 73, c + 6, t0 + 75, 1),
        _x("slam:sync.stop", "user_annotation", t0 + 84, 15),
        _x("cudaMemcpyAsync", "cuda_runtime", t0 + 85, 13, correlation=c + 7),
        _x("Memcpy DtoH", "gpu_memcpy", t0 + 96, 1, tid=7,
           correlation=c + 7),
    ]


def _run(tmp_path, events, units):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return types.SimpleNamespace(view=trace.TraceView(path), units=units,
                                 calls=lambda key: [])


@pytest.fixture
def run(tmp_path):
    ev = [_x(trace.WINDOW, "user_annotation", 0, 400),
          _x("slam:lm.linearize", "user_annotation", 5, 20),
          *_launch(6, 1, 10, 5)]
    ev += _iteration(100, 10) + _iteration(250, 20)
    # a benchmark span around the same back-substitution changes nothing
    ev.append(_x("layer:rcs", "user_annotation", 103, 15))
    return _run(tmp_path, ev, units=2)


@pytest.mark.parametrize("part", ["st20", "ladybug"])
def test_program_span_readers(run, part):
    read = {n: manifest.load_reader(f"{n}.{part}").read for n in NAMES}
    # 100 us an iteration, 15 of them in the sync
    assert read["lm_host_ms_per_iter"](run) == pytest.approx(0.085)
    assert read["sync_wait_ms_per_iter"](run) == pytest.approx(0.015)
    # back-substitution 2 + 1 us, retract 4 us, an iteration
    assert read["backsub_retract_ms_per_iter"](run) == pytest.approx(0.007)


def test_a_sync_outside_an_iteration_is_not_taken_from_its_host_time(
        tmp_path):
    ev = [_x(trace.WINDOW, "user_annotation", 0, 400),
          *_iteration(100, 10),
          _x("slam:sync.other", "user_annotation", 300, 30)]
    run = _run(tmp_path, ev, units=1)
    assert manifest.load_reader("lm_host_ms_per_iter.st20").read(
        run) == pytest.approx(0.085)
    assert manifest.load_reader("sync_wait_ms_per_iter.st20").read(
        run) == pytest.approx(0.045)


def test_no_program_spans_read_nothing(tmp_path):
    # the benchmark's own spans and kernels, as a program without spans
    ev = [_x(trace.WINDOW, "user_annotation", 0, 100),
          _x("layer:rcs", "user_annotation", 10, 20),
          *_launch(12, 1, 20, 5)]
    run = _run(tmp_path, ev, units=3)
    for n in NAMES:
        assert manifest.load_reader(f"{n}.st20").read(run) is None, n
    # one of the two spans of the back-substitution metric is not enough
    ev += [_x("slam:lm.retract", "user_annotation", 40, 10),
           *_launch(41, 2, 50, 5)]
    run = _run(tmp_path, ev, units=3)
    assert manifest.load_reader(
        "backsub_retract_ms_per_iter.st20").read(run) is None


def test_manifest_lists_the_readers_in_their_cells():
    for cell, part in (("st20-solve", "st20"), ("ladybug-solve", "ladybug")):
        names = {p["name"] for p in manifest.Cell(cell).per_layer}
        assert {f"{n}.{part}" for n in NAMES} <= names
