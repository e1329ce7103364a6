"""Public-dataset loaders: EuRoC (ASL), TUM RGB-D, KITTI odometry (port of
``slam_tricks_tpu/utils/datasets.py``, the same code).

The reference repo ships fragments of these datasets as loose fixtures (EuRoC
intrinsics hard-coded at st1-undistort/src/main.cpp:124-129, KITTI frames in
st13-directmethod/img/, TUM-style image pair in st2-epipolar) but has no
loaders — every main() hard-codes its paths. These are the standard formats a
user needs to run the calibration/BA/ICP pipelines on real sequences.

Everything here is host-side numpy IO (no device work); outputs are plain
numpy arrays, to be moved to a device by the caller.
"""

import numpy as np

__all__ = [
    "read_tum_trajectory",
    "read_tum_image_list",
    "associate_timestamps",
    "read_euroc_csv",
    "read_euroc_imu",
    "read_euroc_groundtruth",
    "read_euroc_camera_yaml",
    "read_kitti_poses",
    "read_kitti_calib",
    "read_kitti_times",
]


# ---------------------------------------------------------------- TUM RGB-D

def read_tum_trajectory(path):
    """TUM groundtruth.txt / estimate files: `ts tx ty tz qx qy qz qw` rows,
    `#` comments. Returns (ts (N,), t (N,3), q_wxyz (N,4))."""
    data = np.loadtxt(path, comments="#")
    data = np.atleast_2d(data)
    ts, t, q_xyzw = data[:, 0], data[:, 1:4], data[:, 4:8]
    q_wxyz = np.concatenate([q_xyzw[:, 3:4], q_xyzw[:, :3]], axis=1)
    return ts, t, q_wxyz


def read_tum_image_list(path):
    """TUM rgb.txt / depth.txt: `ts filename` rows, `#` comments. Returns
    (ts (N,), list of paths relative to the sequence root)."""
    ts, names = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            a, b = line.split()[:2]
            ts.append(float(a))
            names.append(b)
    return np.asarray(ts), names


def associate_timestamps(ts_a, ts_b, max_dt=0.02):
    """Greedy nearest-timestamp association (the TUM associate.py role):
    returns (idx_a, idx_b) index arrays of mutually-nearest pairs with
    |dt| <= max_dt, each index used at most once."""
    ts_a = np.asarray(ts_a, np.float64)
    ts_b = np.asarray(ts_b, np.float64)
    pairs = []
    for i, ta in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - ta)))
        dt = abs(float(ts_b[j] - ta))
        if dt <= max_dt:
            pairs.append((dt, i, j))
    pairs.sort()
    used_a, used_b, out = set(), set(), []
    for _, i, j in pairs:
        if i in used_a or j in used_b:
            continue
        used_a.add(i); used_b.add(j)
        out.append((i, j))
    out.sort()
    if not out:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ia, ib = zip(*out)
    return np.asarray(ia), np.asarray(ib)


# ---------------------------------------------------------------- EuRoC ASL

def read_euroc_csv(path):
    """Generic ASL data.csv: first column int64 timestamp [ns], rest floats,
    one `#` header line. Returns (ts_ns (N,) int64, values (N,K) float64)."""
    ts, vals = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(",")
            ts.append(int(parts[0]))
            vals.append([float(v) for v in parts[1:]] if len(parts) > 1 else [])
    return np.asarray(ts, np.int64), np.asarray(vals, np.float64)


def read_euroc_imu(path):
    """imu0/data.csv: ts, gyro xyz [rad/s], accel xyz [m/s^2].
    Returns (ts_ns, gyro (N,3), accel (N,3))."""
    ts, v = read_euroc_csv(path)
    return ts, v[:, 0:3], v[:, 3:6]


def read_euroc_groundtruth(path):
    """state_groundtruth_estimate0/data.csv: ts, p xyz, q wxyz, v, bg, ba.
    Returns (ts_ns, t (N,3), q_wxyz (N,4))."""
    ts, v = read_euroc_csv(path)
    return ts, v[:, 0:3], v[:, 3:7]


def read_euroc_camera_yaml(path):
    """Minimal parser for EuRoC sensor.yaml (no yaml dependency): returns a
    dict with `intrinsics` [fu fv cu cv], `distortion` [k1 k2 p1 p2],
    `resolution` [w h], and `T_BS` (4,4) when present."""
    out = {}
    lines = open(path).read().splitlines()

    def _vec(i):
        """Bracketed list starting on line i, possibly spanning lines."""
        text = lines[i].split("[", 1)[1]
        j = i
        while "]" not in text:
            j += 1
            text += lines[j]
        text = text.split("]", 1)[0]
        return np.asarray([float(v) for v in text.split(",") if v.strip()])

    for i, line in enumerate(lines):
        s = line.strip()
        if s.startswith("intrinsics:"):
            out["intrinsics"] = _vec(i)
        elif s.startswith("distortion_coefficients:"):
            out["distortion"] = _vec(i)
        elif s.startswith("resolution:"):
            out["resolution"] = _vec(i).astype(int)
        elif s.startswith("data:") and any(
                "T_BS" in prev for prev in lines[max(0, i - 4):i]):
            out["T_BS"] = _vec(i).reshape(4, 4)
    return out


# ------------------------------------------------------------------- KITTI

def read_kitti_poses(path):
    """KITTI odometry poses file: each row 12 floats = flattened 3x4 [R|t]
    (cam0-to-world). Returns (R (N,3,3), t (N,3))."""
    data = np.atleast_2d(np.loadtxt(path))
    P = data.reshape(-1, 3, 4)
    return P[:, :, :3].copy(), P[:, :, 3].copy()


def read_kitti_calib(path):
    """KITTI calib.txt: `KEY: 12 floats` rows. Returns {key: (3,4) matrix}."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, rest = line.split(":", 1)
            vals = np.asarray([float(v) for v in rest.split()])
            if vals.size == 12:
                out[key.strip()] = vals.reshape(3, 4)
    return out


def read_kitti_times(path):
    """KITTI times.txt: one float second per frame."""
    return np.atleast_1d(np.loadtxt(path))
