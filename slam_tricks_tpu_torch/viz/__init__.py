"""Visualization / export (reference L7 role, matplotlib-backed); port of
``slam_tricks_tpu/viz``."""

from slam_tricks_tpu_torch.viz.plots import (  # noqa: F401
    hessian_sparsity_image,
    plot_ba_scene,
    plot_trajectories,
    save_csv,
)
