"""Dataset IO: chessboard corner files and simple trajectory formats (port of
``slam_tricks_tpu/utils/io.py``, the same code: numpy in, numpy out).

Corner-file format (reference: st3-calibration/src/src/cbcorner.cpp:33-73,
data at st3-calibration/calib/1.txt): first line "rows,cols", then one line
per corner "row,col,x,y" in pixel coordinates.
"""

import numpy as np


def read_cbcorners(path):
    """Returns (rows, cols, corners (rows*cols, 2)) ordered row-major."""
    with open(path) as f:
        header = f.readline().strip()
        rows, cols = (int(v) for v in header.split(","))
        grid = np.full((rows, cols, 2), np.nan)
        for line in f:
            line = line.strip()
            if not line:
                continue
            r, c, x, y = line.split(",")
            grid[int(r), int(c)] = (float(x), float(y))
    if np.isnan(grid).any():
        raise ValueError(f"missing corners in {path}")
    return rows, cols, grid.reshape(-1, 2)


def write_cbcorners(path, rows, cols, corners):
    corners = np.asarray(corners).reshape(rows, cols, 2)
    with open(path, "w") as f:
        f.write(f"{rows},{cols}\n")
        for r in range(rows):
            for c in range(cols):
                f.write(f"{r},{c},{corners[r, c, 0]:.3f},{corners[r, c, 1]:.3f}\n")


def board_model_points(rows, cols, square):
    """Model-plane coordinates matching the corner-file row-major order."""
    ys, xs = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    return np.stack([xs.ravel(), ys.ravel()], axis=1) * square


def read_odometry_txt(path):
    """Whitespace trajectory rows: timestamp tx ty tz qx qy qz qw (the
    st16-pcl-viewer ReadOdom format, scene.cpp:66-99). Returns
    (timestamps (N,), t (N,3), q_wxyz (N,4))."""
    data = np.loadtxt(path)
    ts = data[:, 0]
    t = data[:, 1:4]
    q_xyzw = data[:, 4:8]
    q_wxyz = np.concatenate([q_xyzw[:, 3:4], q_xyzw[:, :3]], axis=1)
    return ts, t, q_wxyz
