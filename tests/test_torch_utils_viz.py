"""The port's host utilities (slam_tricks_tpu_torch: config, utils.logging,
utils.io, utils.datasets, utils.timer, utils.checkpoint, viz) against the
JAX package's, on the same inputs:

- config: every default's to_dict equal, from_dict round trips;
- logging: the same records formatted to the same text, with and without
  colour (records collected by a handler of the test's own: loggers are
  global by name, shared by both packages in this process);
- io: a corner file written by either package reads back the same in the
  other; board_model_points and read_odometry_txt equal;
- datasets: the formats of tests/test_datasets.py (TUM, EuRoC, KITTI),
  each reader's output equal (exactly) to the JAX package's;
- viz: hessian_sparsity_image equal arrays from tensors and from numpy;
  plots written from tensors; save_csv byte-identical to the JAX
  package's;
- checkpoint: the port's round trip, its leaf order equal to
  jax.tree_util.tree_leaves' on the same nest (dict keys given out of
  order), the structure, leaf-count and shape errors, and a BAState saved
  by the JAX package loaded into the port's BAState bitwise
  (interop.checkpoint_from_jax);
- timer: lap, report, timed, time_fn's (best, result), profile_trace's
  Chrome trace naming an annotate region.
"""

import collections
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu import config as jconfig
from slam_tricks_tpu.manifolds import se3 as jse3
from slam_tricks_tpu.solvers.schur import BAState as JBAState
from slam_tricks_tpu.utils import checkpoint as jcheckpoint
from slam_tricks_tpu.utils import datasets as jds
from slam_tricks_tpu.utils import io as jio
from slam_tricks_tpu.utils import logging as jlogging
from slam_tricks_tpu.utils import timer as jtimer
from slam_tricks_tpu.viz import plots as jplots
from slam_tricks_tpu_torch import config, interop
from slam_tricks_tpu_torch.manifolds import se3
from slam_tricks_tpu_torch.solvers.schur import BAState
from slam_tricks_tpu_torch.utils import checkpoint, timer
from slam_tricks_tpu_torch.utils import datasets as ds
from slam_tricks_tpu_torch.utils import io
from slam_tricks_tpu_torch.utils import logging as tlogging
from slam_tricks_tpu_torch.viz import plots
from tests import torch_util  # noqa: F401  (the test-process thread cap)

RNG = np.random.default_rng(31)


def _unit_q(n):
    q = RNG.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _equal(a, b):
    """Nested outputs (tuples, lists, dicts, arrays, numbers) exactly
    equal, dtypes included."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---- config ----

@pytest.mark.parametrize("name", ["SolverConfig", "BAConfig", "RansacConfig"])
def test_config_defaults_and_round_trip(name):
    cls, jcls = getattr(config, name), getattr(jconfig, name)
    assert config.to_dict(cls()) == jconfig.to_dict(jcls())
    cfg = cls().replace(max_iters=7) if hasattr(cls(), "max_iters") else \
        cls().replace(n_hyps=7)
    d = config.to_dict(cfg)
    assert config.from_dict(cls, {**d, "unknown": 1}) == cfg
    assert jconfig.to_dict(jconfig.from_dict(jcls, d)) == d
    assert hash(cfg) == hash(cls(**d))


# ---- logging ----

class _Collect(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


def _records(get_logger, name, emit):
    log = get_logger(name)
    h = _Collect()
    log.addHandler(h)
    log.setLevel(logging.DEBUG)
    try:
        emit(log)
    finally:
        log.removeHandler(h)
    return h.records


def _emit(log, log_var):
    log.info("scene: %d cams, %.4f m", 30, 0.1432)
    log.process("iter %3d  cost %.6e", 3, 1.25e-3)
    log.warning("warn %s", "x")
    log.fatal("fatal")
    log_var(log, x=1, cost=0.5)


@pytest.mark.parametrize("color", [False, True])
def test_logging_formats_the_same_records(color):
    jrec = _records(jlogging.get_logger, "test_utils_viz_j",
                    lambda log: _emit(log, jlogging.log_var))
    trec = _records(tlogging.get_logger, "test_utils_viz_t",
                    lambda log: _emit(log, tlogging.log_var))
    assert len(jrec) == len(trec) == 5
    jfmt, tfmt = jlogging._Formatter(color), tlogging._Formatter(color)
    for a, b in zip(jrec, trec):
        assert (a.levelno, a.levelname, a.getMessage()) == (
            b.levelno, b.levelname, b.getMessage())
        b.created, b.msecs, b.name = a.created, a.msecs, a.name
        assert tfmt.format(b) == jfmt.format(a)
    assert tlogging.PROCESS == jlogging.PROCESS == 25
    assert trec[1].levelname == "PROCESS"
    assert trec[4].getMessage() == "x = 1, cost = 0.5"


def test_logging_file_handler_writes_plain_text(tmp_path):
    name = "test_utils_viz_file"
    logging.getLogger(name).handlers.clear()
    log = tlogging.get_logger(name, file=str(tmp_path / "log.txt"),
                              color=True)
    try:
        log.process("step %d", 4)
        for h in log.handlers:
            h.flush()
        text = (tmp_path / "log.txt").read_text()
    finally:
        for h in log.handlers:
            h.close()
        log.handlers.clear()
    assert text.endswith(f"[PROCESS] {name}: step 4\n")
    assert "\033[" not in text


# ---- io ----

def test_corner_files_cross_read(tmp_path):
    rows, cols = 5, 8
    corners = RNG.uniform(0, 640, (rows * cols, 2))
    jio.write_cbcorners(tmp_path / "j.txt", rows, cols, corners)
    io.write_cbcorners(tmp_path / "t.txt", rows, cols, corners)
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()
    for path in ("j.txt", "t.txt"):
        _equal(io.read_cbcorners(tmp_path / path),
               jio.read_cbcorners(tmp_path / path))
    r, c, back = io.read_cbcorners(tmp_path / "j.txt")
    assert (r, c) == (rows, cols)
    np.testing.assert_allclose(back, corners, atol=5e-4)
    _equal(io.board_model_points(rows, cols, 0.028),
           jio.board_model_points(rows, cols, 0.028))
    with open(tmp_path / "bad.txt", "w") as f:
        f.write("2,2\n0,0,1.0,2.0\n")
    for mod in (io, jio):
        with pytest.raises(ValueError, match="missing corners"):
            mod.read_cbcorners(tmp_path / "bad.txt")


def test_read_odometry_txt(tmp_path):
    n = 9
    rows = np.concatenate([np.arange(n)[:, None] * 0.1, RNG.normal(size=(n, 3)),
                           _unit_q(n)], axis=1)
    np.savetxt(tmp_path / "odom.txt", rows)
    _equal(io.read_odometry_txt(tmp_path / "odom.txt"),
           jio.read_odometry_txt(tmp_path / "odom.txt"))


# ---- datasets (the formats of tests/test_datasets.py) ----

@pytest.fixture(scope="module")
def dataset_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("datasets")
    n = 25
    ts = np.cumsum(RNG.uniform(0.03, 0.05, n)) + 1311868164.0
    t, q = RNG.normal(size=(n, 3)), _unit_q(n)
    with open(d / "groundtruth.txt", "w") as f:
        f.write("# ground truth trajectory\n# ts tx ty tz qx qy qz qw\n")
        for i in range(n):
            w, x, y, z = q[i]
            f.write(f"{ts[i]:.6f} {t[i,0]:.9f} {t[i,1]:.9f} {t[i,2]:.9f} "
                    f"{x:.9f} {y:.9f} {z:.9f} {w:.9f}\n")
    with open(d / "rgb.txt", "w") as f:
        f.write("# color images\n")
        for i in range(10):
            f.write(f"{i * 0.1:.6f} rgb/{i:04d}.png\n")
    m = 12
    tsn = (np.arange(m) * 5_000_000 + 1403636579758555392).astype(np.int64)
    with open(d / "imu.csv", "w") as f:
        f.write("#timestamp [ns],w_RS_S_x,w_y,w_z,a_x,a_y,a_z\n")
        for i in range(m):
            row = ",".join(f"{v:.12f}" for v in RNG.normal(size=6))
            f.write(f"{tsn[i]},{row}\n")
    with open(d / "gt.csv", "w") as f:
        f.write("#ts,p_x,p_y,p_z,q_w,q_x,q_y,q_z,...\n")
        for i in range(7):
            vals = np.r_[RNG.normal(size=3), _unit_q(1)[0], RNG.normal(size=9)]
            f.write(f"{i * 5_000_000}," + ",".join(f"{v:.10f}" for v in vals)
                    + "\n")
    with open(d / "sensor.yaml", "w") as f:
        f.write("sensor_type: camera\nT_BS:\n  cols: 4\n  rows: 4\n"
                "  data: [0.0148655429818, -0.999880929698, 0.00414029679422,"
                " -0.0216401454975,\n         0.999557249008, 0.0149672133247,"
                " 0.025715529948, -0.064676986768,\n         -0.0257744366974,"
                " 0.00375618835797, 0.999660727178, 0.00981073058949,\n"
                "         0.0, 0.0, 0.0, 1.0]\nrate_hz: 20\n"
                "resolution: [752, 480]\ncamera_model: pinhole\n"
                "intrinsics: [458.654, 457.296, 367.215, 248.375]\n"
                "distortion_model: radial-tangential\n"
                "distortion_coefficients: [-0.28340811, 0.07395907, "
                "0.00019359, 1.76187114e-05]\n")
    P = RNG.normal(size=(6, 3, 4))
    np.savetxt(d / "poses.txt", P.reshape(6, 12))
    with open(d / "calib.txt", "w") as f:
        for k in ("P0", "P1", "Tr"):
            f.write(f"{k}: " + " ".join(f"{v:.6e}" for v in
                                        RNG.normal(size=12)) + "\n")
        f.write("bad line\n")
    np.savetxt(d / "times.txt", np.arange(6) * 0.1)
    return d, ts


@pytest.mark.parametrize("reader, name", [
    ("read_tum_trajectory", "groundtruth.txt"),
    ("read_tum_image_list", "rgb.txt"),
    ("read_euroc_csv", "imu.csv"),
    ("read_euroc_imu", "imu.csv"),
    ("read_euroc_groundtruth", "gt.csv"),
    ("read_euroc_camera_yaml", "sensor.yaml"),
    ("read_kitti_poses", "poses.txt"),
    ("read_kitti_calib", "calib.txt"),
    ("read_kitti_times", "times.txt"),
])
def test_dataset_readers_match_jax(dataset_files, reader, name):
    d, _ = dataset_files
    out = getattr(ds, reader)(d / name)
    _equal(out, getattr(jds, reader)(d / name))
    if reader == "read_euroc_camera_yaml":
        assert set(out) == {"intrinsics", "distortion", "resolution", "T_BS"}


def test_associate_timestamps_matches_jax(dataset_files):
    _, ts = dataset_files
    ts_b = ts + RNG.uniform(-0.01, 0.01, ts.shape)
    for shift, max_dt in ((0.0, 0.02), (0.015, 0.02), (10.0, 0.02)):
        _equal(ds.associate_timestamps(ts, ts_b + shift, max_dt),
               jds.associate_timestamps(ts, ts_b + shift, max_dt))
    assert ds.associate_timestamps(ts, ts_b + 10.0)[0].size == 0


# ---- viz ----

def test_hessian_sparsity_image_from_tensors():
    cam = RNG.integers(0, 6, 200)
    lm = RNG.integers(0, 40, 200)
    for px in (1, 2):
        got = plots.hessian_sparsity_image(6, 40, torch.as_tensor(cam),
                                           torch.as_tensor(lm),
                                           px_per_entry=px)
        _equal(got, jplots.hessian_sparsity_image(6, 40, cam, lm,
                                                  px_per_entry=px))
    assert got.shape == (2 * (6 * 6 + 40 * 3),) * 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_save_csv_byte_identical(tmp_path, dtype):
    rows = RNG.normal(size=(7, 3))
    t_rows = torch.as_tensor(rows, dtype=dtype)
    plots.save_csv(tmp_path / "t.csv", ["a", "b", "c"], t_rows)
    jplots.save_csv(tmp_path / "j.csv", ["a", "b", "c"], t_rows.numpy())
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def test_plots_from_tensors(tmp_path):
    pytest.importorskip("matplotlib")
    poses = se3.exp(torch.as_tensor(RNG.normal(size=(12, 6)) * 0.3))
    centers = torch.as_tensor(RNG.normal(size=(12, 3)))
    out = plots.plot_trajectories(tmp_path / "traj.png",
                                  {"poses": poses, "centers": centers})
    assert (tmp_path / "traj.png").stat().st_size > 1000 and out == \
        tmp_path / "traj.png"
    plots.plot_ba_scene(tmp_path / "scene.png", poses,
                        torch.as_tensor(RNG.normal(size=(50, 3))))
    assert (tmp_path / "scene.png").stat().st_size > 1000


# ---- checkpoint ----

def _nest(lib):
    arr = jnp.asarray if lib == "jax" else torch.as_tensor
    return {"zeta": arr(np.arange(3.0)), "alpha": [arr(np.ones((2, 2))), None,
                                                   (arr(np.int32(4)), 2.5)],
            "mid": collections.OrderedDict(b=arr(np.zeros(1)),
                                           a=arr(np.full(2, 7.0)))}


def test_checkpoint_leaf_order_is_jax_tree_util():
    jl = jax.tree_util.tree_leaves(_nest("jax"))
    tl = checkpoint.tree_leaves(_nest("torch"))
    assert len(jl) == len(tl) == 6
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_round_trip(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = BAState(poses=se3.exp(torch.randn(4, 6, generator=g,
                                              dtype=torch.float64)),
                    points=torch.randn(5, 3, generator=g),
                    cost=torch.tensor(0.5), lam=torch.tensor(1e-4),
                    nu=torch.tensor(2.0), it=7, done=True)
    path = checkpoint.save_pytree(str(tmp_path / "state.npz"), state)
    back = checkpoint.load_pytree(path, state)
    assert type(back) is BAState and (back.it, back.done) == (7, True)
    for a, b in zip(checkpoint.tree_leaves(state)[:6],
                    checkpoint.tree_leaves(back)[:6]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the leaves go to `like`'s dtype
    like = state._replace(points=state.points.double())
    assert checkpoint.load_pytree(path, like).points.dtype == torch.float64
    nest = _nest("torch")
    checkpoint.save_pytree(tmp_path / "nest.npz", nest)
    back = checkpoint.load_pytree(tmp_path / "nest.npz", nest)
    assert list(back["mid"]) == ["b", "a"] and back["alpha"][1] is None
    assert back["alpha"][2][1] == 2.5


def test_checkpoint_rejects_mismatched_structure(tmp_path):
    tree = {"a": torch.ones(3), "b": torch.zeros(2, 2)}
    path = checkpoint.save_pytree(str(tmp_path / "t.npz"), tree)
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.load_pytree(path, {"x": torch.ones(3),
                                      "y": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_pytree(path, {"a": torch.ones(4),
                                      "b": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.load_pytree(path, [torch.ones(3), torch.zeros(2, 2)])


def test_checkpoint_from_jax_loads_a_jax_ba_state(tmp_path):
    rng = np.random.default_rng(3)
    R = np.asarray(jse3.exp(jnp.asarray(rng.normal(size=6) * 0.3)).R)
    jstate = JBAState(
        poses=jse3.SE3(jnp.asarray(np.stack([R] * 4)),
                       jnp.asarray(rng.normal(size=(4, 3)))),
        points=jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32)),
        cost=jnp.asarray(0.25), lam=jnp.asarray(1e-4), nu=jnp.asarray(2.0),
        it=jnp.asarray(7, jnp.int32), done=jnp.asarray(True))
    path = jcheckpoint.save_pytree(str(tmp_path / "jax_state.npz"), jstate)
    like = BAState(poses=se3.SE3(torch.zeros(4, 3, 3, dtype=torch.float64),
                                 torch.zeros(4, 3, dtype=torch.float64)),
                   points=torch.zeros(5, 3), cost=torch.tensor(0.0,
                                                               dtype=torch.float64),
                   lam=torch.tensor(0.0, dtype=torch.float64),
                   nu=torch.tensor(0.0, dtype=torch.float64), it=0,
                   done=False)
    back = interop.checkpoint_from_jax(path, like, device="cpu")
    assert type(back) is BAState and (back.it, back.done) == (7, True)
    for a, b in zip(jax.tree_util.tree_leaves(jstate)[:6],
                    checkpoint.tree_leaves(back)[:6]):
        a = np.asarray(a)
        assert b.device.type == "cpu" and str(b.dtype)[6:] == str(a.dtype)
        assert np.array_equal(b.numpy(), a)
        assert b.numpy().tobytes() == a.tobytes()
    bad = like._replace(points=torch.zeros(6, 3))
    with pytest.raises(ValueError, match="shape"):
        interop.checkpoint_from_jax(path, bad, device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        interop.checkpoint_from_jax(path, like[:6], device="cpu")


# ---- timer ----

def test_timer_lap_and_report():
    t, jt = timer.Timer(), jtimer.Timer()
    x = torch.ones(64, 64)
    first = t.lap("a", sync=(x @ x, {"k": [x]}))
    second = t.lap("b")
    assert first >= 0 and second >= 0 and [tag for tag, _ in t.laps] == [
        "a", "b"]
    jt.laps = list(t.laps)
    assert t.report() == jt.report()
    t.re_start()
    assert t.lap("c") < first + second + 1.0


def test_timed_prints_and_logs(capsys):
    with timer.timed("solve", out=torch.ones(3)):
        pass
    assert capsys.readouterr().out.startswith("solve: ")

    def emit(log):
        with timer.timed("block", out=[torch.zeros(2)], log=log):
            pass

    (rec,) = _records(tlogging.get_logger, "test_utils_viz_timed", emit)
    assert rec.levelname == "PROCESS" and rec.getMessage().startswith(
        "block: ") and rec.getMessage().endswith(" ms")
    assert capsys.readouterr().out == ""


def test_time_fn_returns_best_and_result():
    calls = []

    def fn(a, b):
        calls.append(1)
        return {"sum": a + b}

    best, out = timer.time_fn(fn, torch.ones(3), torch.ones(3), warmup=2,
                              reps=3)
    assert len(calls) == 5 and 0 <= best < 1.0
    assert torch.equal(out["sum"], torch.full((3,), 2.0))


def test_profile_trace_names_the_annotated_region(tmp_path):
    with timer.profile_trace(str(tmp_path / "trace")):
        with timer.annotate("port_region"):
            torch.ones(128, 128) @ torch.ones(128, 128)
    trace = tmp_path / "trace" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "port_region" for e in events)
