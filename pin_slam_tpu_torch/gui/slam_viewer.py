"""Spawned-process SLAM viewer. The port's own copy of
`pin_slam_tpu/gui/slam_viewer.py`.

The reference spawns an Open3D window process fed by mp.Queues
(reference: pin_slam.py:200-217, gui/slam_gui.py:50-133). This
environment has no display, so the viewer process renders each received
VisPacket to PNG with matplotlib-Agg and mirrors the latest state to
``<run_path>/gui/latest.npz`` — the same process/queue/latest-wins
architecture, with files as the screen.

Interactive control: the viewer watches ``<run_path>/gui/control.yaml``
(written by the user at any time) and forwards its contents to the main
process as a ControlPacket — the headless equivalent of the reference's
keyboard/UI callbacks (gui/slam_gui.py:1103-1337). Supported keys match
ControlPacket fields, e.g. ``flag_pause: true`` or ``mesh_freq_frame: 20``.

This module imports neither torch nor jax: the viewer process never
touches the card. Without matplotlib the viewer says so once and writes
``latest.npz`` alone (no PNG renders). Unlike the JAX package's viewer,
which drops the last frame when the finish packet is already queued
behind it, this one draws that frame before it exits.
"""

from __future__ import annotations

import os
import queue
import time

import numpy as np

from pin_slam_tpu_torch.gui.gui_utils import ControlPacket, ParamsGUI


def _render_packet(pkt, out_png: str, params: ParamsGUI):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1, 2, figsize=(11, 5))
    # left: top-down trajectory + loop edges
    for traj, style, label in ((pkt.gt_poses, "k--", "gt"),
                               (pkt.odom_poses, "b-", "odom"),
                               (pkt.slam_poses, "r-", "slam")):
        if traj is not None and len(traj) > 1:
            t = np.asarray(traj)[:, :3, 3]
            ax[0].plot(t[:, 0], t[:, 1], style, lw=1, label=label)
    if pkt.loop_edges and pkt.slam_poses is not None:
        t = np.asarray(pkt.slam_poses)[:, :3, 3]
        for i, j in pkt.loop_edges:
            if max(i, j) < len(t):
                ax[0].plot(t[[i, j], 0], t[[i, j], 1], "g-", lw=0.8)
    ax[0].set_aspect("equal")
    if ax[0].get_legend_handles_labels()[1]:
        ax[0].legend(loc="best", fontsize=7)
    title = f"frame {pkt.frame_id}"
    if pkt.travel_dist is not None:
        title += f"  dist {pkt.travel_dist:.1f} m"
    if pkt.cur_fps:
        title += f"  {pkt.cur_fps:.1f} fps"
    ax[0].set_title(title, fontsize=9)

    # right: current scan (and neural points underneath, if sent)
    npd = pkt.neural_points_data
    if npd is not None and npd.get("position") is not None:
        p = npd["position"][::7]
        col = npd.get("color_pca_geo")
        ax[1].scatter(p[:, 0], p[:, 1], s=0.3,
                      c=None if col is None else col[::7], alpha=0.5)
    if pkt.current_pointcloud_xyz is not None:
        s = pkt.current_pointcloud_xyz[::3]
        ax[1].scatter(s[:, 0], s[:, 1], s=0.5, c="k", alpha=0.6)
    ax[1].set_aspect("equal")
    info = []
    if npd is not None:
        if npd.get("count") is not None:
            info.append(f"{npd['count']} pts")
        if npd.get("map_memory_mb") is not None:
            info.append(f"{npd['map_memory_mb']:.0f} MB")
    if pkt.mesh_verts is not None:
        info.append(f"mesh {len(pkt.mesh_verts)}v")
    ax[1].set_title(" ".join(info), fontsize=9)
    fig.tight_layout()
    fig.savefig(out_png, dpi=80)
    plt.close(fig)


def _save_latest(pkt, out_npz: str):
    d = {"frame_id": np.int64(pkt.frame_id or 0)}
    for k in ("current_pointcloud_xyz", "mesh_verts", "mesh_faces",
              "odom_poses", "gt_poses", "slam_poses", "sdf_slice_xyz",
              "sdf_slice_rgb"):
        v = getattr(pkt, k)
        if v is not None:
            d[k] = v
    npd = pkt.neural_points_data
    if npd is not None and npd.get("position") is not None:
        d["neural_points"] = npd["position"]
    tmp = out_npz + ".tmp.npz"
    np.savez_compressed(tmp, **d)
    os.replace(tmp, out_npz)


def _read_control_file(path: str, last_mtime: float):
    """Poll control.yaml; returns (ControlPacket or None, new_mtime)."""
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return None, last_mtime
    if mtime <= last_mtime:
        return None, last_mtime
    import yaml
    try:
        with open(path) as f:
            d = yaml.safe_load(f) or {}
    except Exception:
        return None, mtime
    cp = ControlPacket()
    for k, v in d.items():
        if hasattr(ControlPacket, k):
            setattr(cp, k, v)
    return cp, mtime


def _drain(q):
    """Drain the queue latest-wins (`get_latest_queue`'s rule), keeping the
    finish packet apart: returns (the newest frame packet or None, whether
    the finish packet came). The frame sent just before the finish is thus
    still drawn and mirrored, however late the viewer drains."""
    pkt, finish = None, False
    while True:
        try:
            msg = q.get_nowait()
        except queue.Empty:
            if q.empty():
                break
            continue
        if msg.finish:
            finish = True
        else:
            pkt = msg
    return pkt, finish


def _has_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def viewer_main(params: ParamsGUI):
    """Viewer process entry (reference: gui/slam_gui.py:50 run loop).
    Consumes VisPackets latest-wins, renders, forwards control-file
    changes, exits on a packet with finish=True.

    Backend selection: with ``params.backend`` 'auto' (default) the
    interactive Open3D window (gui/o3d_gui.py; reference
    gui/slam_gui.py:50-1337) is used when open3d + a display are present;
    otherwise — and always in this repo's headless CI — the PNG renderer
    below. 'o3d' forces the window, 'png' forces the headless path. The
    queue protocol with the main process is identical either way."""
    backend = getattr(params, "backend", "auto")
    if backend in ("auto", "o3d"):
        from pin_slam_tpu_torch.gui import o3d_gui
        if backend == "o3d" or o3d_gui.available():
            try:
                return o3d_gui.run_viewer(params)
            except Exception as e:
                print(f"[viewer] open3d backend failed ({e}); "
                      "falling back to PNG rendering")
    gui_dir = os.path.join(params.run_path, "gui")
    os.makedirs(gui_dir, exist_ok=True)
    ctrl_path = os.path.join(gui_dir, "control.yaml")
    ctrl_mtime = 0.0
    n_rendered = 0
    render_on = _has_matplotlib()
    if not render_on:
        print("[viewer] matplotlib is not installed: no PNG renders, "
              "gui/latest.npz only")
    while True:
        pkt, finish = _drain(params.q_main2vis)
        if pkt is None and not finish:
            time.sleep(0.02)
        elif pkt is not None:
            _save_latest(pkt, os.path.join(gui_dir, "latest.npz"))
            try:
                if render_on and \
                        n_rendered % max(params.render_every, 1) == 0:
                    _render_packet(
                        pkt,
                        os.path.join(gui_dir, f"view_{pkt.frame_id:06d}.png"),
                        params)
            except Exception as e:  # keep the viewer alive on render errors
                print(f"[viewer] render failed: {e}")
            n_rendered += 1
        if finish:
            break
        if params.q_vis2main is not None:
            cp, ctrl_mtime = _read_control_file(ctrl_path, ctrl_mtime)
            if cp is not None:
                params.q_vis2main.put(cp)


def start_viewer(run_path: str, render_every: int = 1,
                 backend: str = "auto"):
    """Spawn the viewer process (reference: pin_slam.py:200-217).
    Returns (process, q_main2vis, q_vis2main). Uses the spawn context so
    the child never inherits torch's CUDA state. `backend`: 'auto'|'o3d'|'png'
    (see viewer_main)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    q_main2vis = ctx.Queue()
    q_vis2main = ctx.Queue()
    params = ParamsGUI(q_main2vis=q_main2vis, q_vis2main=q_vis2main,
                       run_path=run_path, render_every=render_every)
    params.backend = backend
    proc = ctx.Process(target=viewer_main, args=(params,), daemon=True)
    proc.start()
    return proc, q_main2vis, q_vis2main


def stop_viewer(proc, q_main2vis, timeout_s: float = 10.0):
    """Send the finish packet and join (reference: pin_slam.py:546-563)."""
    from pin_slam_tpu_torch.gui.gui_utils import VisPacket
    q_main2vis.put(VisPacket(finish=True))
    proc.join(timeout=timeout_s)
    if proc.is_alive():
        proc.terminate()
        proc.join(timeout=2.0)
