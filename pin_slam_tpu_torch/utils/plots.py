"""Host-side plotting: trajectories, timing breakdown, SDF slices, loops.
The port's own copy of `pin_slam_tpu/utils/plots.py`.

matplotlib is imported inside each function, with the Agg backend, so that
importing this module (and `run.py`) loads no plotting library.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

TIMING_LABELS = ["preprocess", "odometry", "loop+pgo", "map prep", "map opt"]


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_trajectories(
    path: str,
    est_poses: np.ndarray,
    gt_poses: Optional[np.ndarray] = None,
    extra: Optional[Dict[str, np.ndarray]] = None,
    plot_3d: bool = False,
):
    """2D (or 3D) trajectory plot (reference: eval_traj_utils.py:241-314)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(8, 8))
    if plot_3d:
        ax = fig.add_subplot(projection="3d")
    else:
        ax = fig.add_subplot()

    def draw(poses, label, style):
        xyz = poses[:, :3, 3]
        if plot_3d:
            ax.plot(xyz[:, 0], xyz[:, 1], xyz[:, 2], style, label=label)
        else:
            ax.plot(xyz[:, 0], xyz[:, 1], style, label=label)

    if gt_poses is not None:
        draw(gt_poses, "ground truth", "k--")
    draw(est_poses, "estimate", "b-")
    for name, poses in (extra or {}).items():
        draw(poses, name, "-")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    if not plot_3d:
        ax.set_aspect("equal")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_timing_detail(path: str, time_table: np.ndarray,
                       realtime_ms: float = 100.0):
    """Stacked per-frame timing area plot with the real-time budget line
    (reference: utils/tools.py:859-973)."""
    plt = _pyplot()
    t = np.asarray(time_table) * 1e3  # -> ms
    frames = np.arange(t.shape[0])
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.stackplot(frames, t.T, labels=TIMING_LABELS[: t.shape[1]], alpha=0.8)
    ax.axhline(realtime_ms, color="r", linestyle="--",
               label=f"real-time ({realtime_ms:.0f} ms)")
    ax.set_xlabel("frame")
    ax.set_ylabel("time [ms]")
    ax.legend(loc="upper left", fontsize=8)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_sdf_slice(path: str, xs: np.ndarray, ys: np.ndarray,
                   sdf: np.ndarray, clim: float = 1.0):
    """SDF slice heat map (reference: utils/mesher.py:211-279)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 8))
    im = ax.pcolormesh(xs, ys, sdf.T, cmap="seismic",
                       vmin=-clim, vmax=clim)
    fig.colorbar(im, ax=ax, label="sdf [m]")
    ax.set_aspect("equal")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_loops(path: str, poses: np.ndarray, loop_edges):
    """Trajectory with loop edges (reference: utils/pgo.py:340+)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 8))
    xyz = poses[:, :3, 3]
    ax.plot(xyz[:, 0], xyz[:, 1], "b-", lw=1)
    for e in loop_edges:
        i, j = int(e[0]), int(e[1])
        ax.plot([xyz[i, 0], xyz[j, 0]], [xyz[i, 1], xyz[j, 1]], "g-", lw=1.5)
    ax.set_aspect("equal")
    ax.grid(True, alpha=0.3)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
