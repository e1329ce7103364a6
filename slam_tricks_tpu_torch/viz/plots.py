"""Visualization and export utilities.

Reference roles replaced:
- Jacobian/Hessian block-sparsity renderer (st20-g2o/src/include/sim_data.h:108-159
  draws the pattern to an image)            -> `hessian_sparsity_image`
- PCL scene/trajectory viewers (st16/st17)  -> matplotlib 3D exports
- artwork CSV dumps (st4 main.cpp:6-29, st6 binding.cpp) -> `save_csv`

All functions are host-side (numpy/matplotlib); never on the compute path.
Port of ``slam_tricks_tpu/viz/plots.py``: they take tensors on any device
(copied to the host by ``_np``) and ``SE3`` poses of tensors. matplotlib is
imported only inside the plotting functions; ``hessian_sparsity_image`` and
``save_csv`` need numpy alone.
"""

import numpy as np
import torch


def _np(x):
    """A numpy copy of a tensor on any device; other arrays as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def hessian_sparsity_image(n_cams, n_points, cam_idx, lm_idx, cam_block=6,
                           lm_block=3, px_per_entry=1):
    """Render the BA normal-equation block-sparsity pattern as a binary image
    (the st20 DataManager::Hessian() visualization, sim_data.h:108-135).

    Returns a (D,D) uint8 array, D = 6C+3L (scaled by px_per_entry)."""
    cam_idx = _np(cam_idx)
    lm_idx = _np(lm_idx)
    D = n_cams * cam_block + n_points * lm_block
    img = np.zeros((D, D), np.uint8)

    def fill(r0, c0, h, w):
        img[r0:r0 + h, c0:c0 + w] = 255

    for c in range(n_cams):
        fill(c * cam_block, c * cam_block, cam_block, cam_block)
    for l in range(n_points):
        o = n_cams * cam_block + l * lm_block
        fill(o, o, lm_block, lm_block)
    for c, l in zip(cam_idx, lm_idx):
        r0 = c * cam_block
        c0 = n_cams * cam_block + l * lm_block
        fill(r0, c0, cam_block, lm_block)
        fill(c0, r0, lm_block, cam_block)
    if px_per_entry != 1:
        img = np.kron(img, np.ones((px_per_entry, px_per_entry), np.uint8))
    return img


def plot_trajectories(path, named_trajs, title="trajectories"):
    """Save a 3D plot of camera-center trajectories. named_trajs: dict
    name -> SE3-stacked poses (T_cw) or (N,3) centers."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(111, projection="3d")
    for name, tr in named_trajs.items():
        if hasattr(tr, "R"):
            R = _np(tr.R)
            t = _np(tr.t)
            centers = -np.einsum("nij,ni->nj", R, t)
        else:
            centers = _np(tr)
        ax.plot(centers[:, 0], centers[:, 1], centers[:, 2], label=name)
    ax.legend()
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_ba_scene(path, poses, points, title="BA scene"):
    """Save a 3D scatter of landmarks + camera centers (the st16/st17 scene
    viewer role)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(111, projection="3d")
    p = _np(points)
    ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=2, alpha=0.4, label="landmarks")
    R = _np(poses.R)
    t = _np(poses.t)
    centers = -np.einsum("nij,ni->nj", R, t)
    ax.plot(centers[:, 0], centers[:, 1], centers[:, 2], "r.-", label="cameras")
    ax.legend()
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def save_csv(path, header, rows):
    """Minimal CSV writer (artwork ns_csv role)."""
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for row in _np(rows):
            f.write(",".join(f"{v}" for v in row) + "\n")
    return path
