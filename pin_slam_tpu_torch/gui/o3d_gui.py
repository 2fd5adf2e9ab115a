"""Optional Open3D interactive rendering backend for the viewer process.
The port's own copy of `pin_slam_tpu/gui/o3d_gui.py`.

The reference renders neural points / current scan / mesh / SDF slices in a
live Open3D GUI window with widget callbacks (reference:
gui/slam_gui.py:50-1337). This module is the same capability behind this
repo's VisPacket/ControlPacket queue contract (gui/gui_utils.py): the
spawned viewer process (slam_viewer.viewer_main) selects this backend when
``open3d`` is importable and a display is present, and falls back to the
tested headless PNG renderer otherwise — the main process's queue protocol
is identical either way.

Widget surface (mirrors the reference's panel, gui/slam_gui.py:134-420):
  * checkboxes: pause, neural point map, current scan, mesh, SDF slice,
    global/local view — each toggles a ControlPacket flag pushed to the
    main process (reference on_* callbacks :1103-1299);
  * sliders: mesh res [m] / mesh freq [frames] / SDF slice height [m];
  * a stats label (frame, fps, #neural points, map MB — reference
    :1099-1118).

This module must stay importable without open3d installed (the import
happens inside ``available()``/``run_viewer``); it imports neither torch
nor jax.
"""

from __future__ import annotations

import time

import numpy as np

from pin_slam_tpu_torch.gui.gui_utils import (ControlPacket, ParamsGUI,
                                              get_latest_queue)


def available() -> bool:
    """True when the Open3D GUI backend can actually run here."""
    try:
        import open3d  # noqa: F401
    except ImportError:
        return False
    import os
    if os.name == "posix" and not (os.environ.get("DISPLAY")
                                   or os.environ.get("WAYLAND_DISPLAY")):
        return False  # headless: use the PNG backend
    return True


class _O3DViewer:
    """Open3D gui.Application window consuming VisPackets."""

    POINT_SIZE = 2
    NP_NAME = "neural_points"
    SCAN_NAME = "scan"
    MESH_NAME = "mesh"
    SDF_NAME = "sdf_slice"
    TRAJ_NAME = "traj"
    LOOP_NAME = "loops"

    def __init__(self, params: ParamsGUI):
        import open3d as o3d
        import open3d.visualization.gui as gui
        import open3d.visualization.rendering as rendering

        self.o3d, self.gui, self.rendering = o3d, gui, rendering
        self.params = params
        self.cp = ControlPacket()
        self.last_pkt = None

        app = gui.Application.instance
        app.initialize()
        self.window = app.create_window("PIN-SLAM (PyTorch)", 1600, 900)
        self.widget3d = gui.SceneWidget()
        self.widget3d.scene = rendering.Open3DScene(self.window.renderer)
        self.widget3d.scene.set_background([0.08, 0.08, 0.1, 1.0])
        self.scene = self.widget3d.scene   # shared with _set_* methods
        self.window.add_child(self.widget3d)

        em = self.window.theme.font_size
        self.panel = gui.Vert(0.4 * em, gui.Margins(em, em, em, em))
        self._build_panel(em)
        self.window.add_child(self.panel)
        self.window.set_on_layout(self._on_layout)
        self.window.set_on_tick_event(self._on_tick)
        self.window.set_on_close(lambda: True)

        self.mat_pts = rendering.MaterialRecord()
        self.mat_pts.shader = "defaultUnlit"
        self.mat_pts.point_size = float(self.POINT_SIZE)
        self.mat_mesh = rendering.MaterialRecord()
        self.mat_mesh.shader = "defaultLit"
        self.mat_line = rendering.MaterialRecord()
        self.mat_line.shader = "unlitLine"
        self.mat_line.line_width = 2.0
        self._camera_init = False
        self._running = True

    # ----------------------------------------------------------- widgets

    def _build_panel(self, em):
        gui = self.gui

        def checkbox(label, attr, default):
            cb = gui.Checkbox(label)
            cb.checked = default

            def on(checked, attr=attr):
                setattr(self.cp, attr, checked)
                self._push_control()
            cb.set_on_checked(on)
            self.panel.add_child(cb)
            return cb

        self.cb_pause = checkbox("pause SLAM", "flag_pause", False)
        self.cb_np = checkbox("neural point map", "flag_vis",
                              self.params.neural_point_map_default_on)
        self.cb_scan = checkbox("current scan", "flag_source", True)
        self.cb_mesh = checkbox("mesh", "flag_mesh",
                                self.params.mesh_default_on)
        self.cb_sdf = checkbox("SDF slice", "flag_sdf",
                               self.params.sdf_default_on)
        self.cb_global = checkbox("global view", "flag_global", False)

        def slider(label, attr, lo, hi, val, is_int=False):
            self.panel.add_child(gui.Label(label))
            s = gui.Slider(gui.Slider.INT if is_int else gui.Slider.DOUBLE)
            s.set_limits(lo, hi)
            if is_int:
                s.int_value = int(val)
            else:
                s.double_value = float(val)

            def on(v, attr=attr, is_int=is_int):
                setattr(self.cp, attr, int(v) if is_int else float(v))
                self._push_control()
            s.set_on_value_changed(on)
            self.panel.add_child(s)
            return s

        slider("mesh res [m]", "mc_res_m", 0.05, 1.0, self.cp.mc_res_m)
        slider("mesh freq [frames]", "mesh_freq_frame", 1, 100,
               self.cp.mesh_freq_frame, is_int=True)
        slider("SDF slice height [m]", "sdf_slice_height", -2.0, 5.0,
               self.cp.sdf_slice_height)
        self.stats = gui.Label("waiting for SLAM ...")
        self.panel.add_child(self.stats)

    def _on_layout(self, ctx):
        r = self.window.content_rect
        panel_w = 20 * ctx.theme.font_size
        self.widget3d.frame = self.gui.Rect(r.x, r.y, r.width - panel_w,
                                            r.height)
        self.panel.frame = self.gui.Rect(r.get_right() - panel_w, r.y,
                                         panel_w, r.height)

    def _push_control(self):
        if self.params.q_vis2main is not None:
            self.cp.cur_frame_id = getattr(self.last_pkt, "frame_id", 0) or 0
            self.params.q_vis2main.put(self.cp)

    # ------------------------------------------------------------ render

    def _set_cloud(self, name, xyz, rgb=None, uniform=None):
        o3d = self.o3d
        scene = self.scene
        if scene.has_geometry(name):
            scene.remove_geometry(name)
        if xyz is None or len(xyz) == 0:
            return
        pc = o3d.geometry.PointCloud(
            o3d.utility.Vector3dVector(np.asarray(xyz, np.float64)))
        if rgb is not None:
            pc.colors = o3d.utility.Vector3dVector(
                np.clip(np.asarray(rgb, np.float64), 0, 1))
        elif uniform is not None:
            pc.paint_uniform_color(uniform)
        scene.add_geometry(name, pc, self.mat_pts)

    def _set_mesh(self, verts, faces, rgb):
        o3d = self.o3d
        scene = self.scene
        if scene.has_geometry(self.MESH_NAME):
            scene.remove_geometry(self.MESH_NAME)
        if verts is None or faces is None or len(faces) == 0:
            return
        m = o3d.geometry.TriangleMesh(
            o3d.utility.Vector3dVector(np.asarray(verts, np.float64)),
            o3d.utility.Vector3iVector(np.asarray(faces, np.int32)))
        if rgb is not None:
            m.vertex_colors = o3d.utility.Vector3dVector(
                np.clip(np.asarray(rgb, np.float64), 0, 1))
        m.compute_vertex_normals()
        scene.add_geometry(self.MESH_NAME, m, self.mat_mesh)

    def _set_traj(self, pkt):
        o3d = self.o3d
        scene = self.scene
        for name in (self.TRAJ_NAME, self.LOOP_NAME):
            if scene.has_geometry(name):
                scene.remove_geometry(name)
        if pkt.slam_poses is None or len(pkt.slam_poses) < 2:
            return
        t = np.asarray(pkt.slam_poses, np.float64)[:, :3, 3]
        lines = [[i, i + 1] for i in range(len(t) - 1)]
        ls = o3d.geometry.LineSet(
            o3d.utility.Vector3dVector(t),
            o3d.utility.Vector2iVector(np.asarray(lines, np.int32)))
        ls.paint_uniform_color([0.9, 0.2, 0.2])
        scene.add_geometry(self.TRAJ_NAME, ls, self.mat_line)
        if pkt.loop_edges:
            le = [[i, j] for i, j in pkt.loop_edges if max(i, j) < len(t)]
            if le:
                ls2 = o3d.geometry.LineSet(
                    o3d.utility.Vector3dVector(t),
                    o3d.utility.Vector2iVector(np.asarray(le, np.int32)))
                ls2.paint_uniform_color([0.2, 0.9, 0.2])
                scene.add_geometry(self.LOOP_NAME, ls2, self.mat_line)

    def _render_packet(self, pkt):
        npd = pkt.neural_points_data
        if self.cb_np.checked and npd is not None \
                and npd.get("position") is not None:
            self._set_cloud(self.NP_NAME, npd["position"],
                            rgb=npd.get("color_pca_geo"),
                            uniform=[0.55, 0.55, 0.9])
        else:
            self._set_cloud(self.NP_NAME, None)
        self._set_cloud(
            self.SCAN_NAME,
            pkt.current_pointcloud_xyz if self.cb_scan.checked else None,
            rgb=pkt.current_pointcloud_rgb, uniform=[0.9, 0.9, 0.3])
        self._set_cloud(
            self.SDF_NAME,
            pkt.sdf_slice_xyz if self.cb_sdf.checked else None,
            rgb=pkt.sdf_slice_rgb)
        if self.cb_mesh.checked:
            self._set_mesh(pkt.mesh_verts, pkt.mesh_faces,
                           pkt.mesh_verts_rgb)
        else:
            self._set_mesh(None, None, None)
        self._set_traj(pkt)

        info = [f"frame {pkt.frame_id}"]
        if pkt.cur_fps:
            info.append(f"{pkt.cur_fps:.1f} fps")
        if npd is not None and npd.get("count") is not None:
            info.append(f"{npd['count']} neural points")
        if npd is not None and npd.get("map_memory_mb") is not None:
            info.append(f"{npd['map_memory_mb']:.0f} MB")
        if pkt.travel_dist is not None:
            info.append(f"{pkt.travel_dist:.1f} m")
        self.stats.text = "  |  ".join(info)

        if not self._camera_init and pkt.current_pointcloud_xyz is not None:
            bounds = self.widget3d.scene.bounding_box
            self.widget3d.setup_camera(60.0, bounds, bounds.get_center())
            self._camera_init = True

    def _on_tick(self):
        pkt = get_latest_queue(self.params.q_main2vis)
        if pkt is not None:
            if pkt.finish:
                self._running = False
                self.gui.Application.instance.quit()
                return False
            self.last_pkt = pkt
            self._render_packet(pkt)
            return True
        time.sleep(0.01)
        return False

    def run(self):
        self.gui.Application.instance.run()


def run_viewer(params: ParamsGUI):
    """Viewer-process entry for the Open3D backend (same contract as
    slam_viewer.viewer_main)."""
    _O3DViewer(params).run()


class OffscreenPacketRenderer:
    """Render a VisPacket to a PNG via Open3D's OffscreenRenderer (EGL /
    OSMesa, no display). Shares the geometry-population methods with the
    interactive backend, so an offscreen render exercises the same open3d
    calls _O3DViewer makes, where open3d is installed."""

    NP_NAME = _O3DViewer.NP_NAME
    SCAN_NAME = _O3DViewer.SCAN_NAME
    MESH_NAME = _O3DViewer.MESH_NAME
    SDF_NAME = _O3DViewer.SDF_NAME
    TRAJ_NAME = _O3DViewer.TRAJ_NAME
    LOOP_NAME = _O3DViewer.LOOP_NAME
    _set_cloud = _O3DViewer._set_cloud
    _set_mesh = _O3DViewer._set_mesh
    _set_traj = _O3DViewer._set_traj

    def __init__(self, width: int = 1280, height: int = 720):
        import open3d as o3d
        import open3d.visualization.rendering as rendering

        self.o3d, self.rendering = o3d, rendering
        self.renderer = rendering.OffscreenRenderer(width, height)
        self.scene = self.renderer.scene
        self.scene.set_background([0.08, 0.08, 0.1, 1.0])
        self.mat_pts = rendering.MaterialRecord()
        self.mat_pts.shader = "defaultUnlit"
        self.mat_pts.point_size = float(_O3DViewer.POINT_SIZE)
        self.mat_mesh = rendering.MaterialRecord()
        self.mat_mesh.shader = "defaultLit"
        self.mat_line = rendering.MaterialRecord()
        self.mat_line.shader = "unlitLine"
        self.mat_line.line_width = 2.0

    def populate(self, pkt):
        """Add every geometry the packet carries (all layers on)."""
        npd = pkt.neural_points_data
        if npd is not None and npd.get("position") is not None:
            self._set_cloud(self.NP_NAME, npd["position"],
                            rgb=npd.get("color_pca_geo"),
                            uniform=[0.55, 0.55, 0.9])
        self._set_cloud(self.SCAN_NAME, pkt.current_pointcloud_xyz,
                        rgb=pkt.current_pointcloud_rgb,
                        uniform=[0.9, 0.9, 0.3])
        self._set_cloud(self.SDF_NAME, pkt.sdf_slice_xyz,
                        rgb=pkt.sdf_slice_rgb)
        self._set_mesh(pkt.mesh_verts, pkt.mesh_faces, pkt.mesh_verts_rgb)
        self._set_traj(pkt)

    def render_to_png(self, pkt, out_png: str):
        self.populate(pkt)
        bounds = self.scene.bounding_box
        center = np.asarray(bounds.get_center(), np.float64)
        extent = float(np.max(np.asarray(bounds.get_extent(), np.float64)))
        eye = center + np.array([0.7, 0.7, 0.5]) * max(extent, 1.0) * 1.8
        self.scene.camera.look_at(center.tolist(), eye.tolist(),
                                  [0.0, 0.0, 1.0])
        img = self.renderer.render_to_image()
        self.o3d.io.write_image(out_png, img)
        return np.asarray(img)
