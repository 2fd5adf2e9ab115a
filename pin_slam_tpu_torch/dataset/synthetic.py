"""Synthetic LiDAR sequences from analytic SDF scenes (host-side NumPy).

The port's own copy of `pin_slam_tpu/dataset/synthetic.py`, so the port
and its tests need nothing of the JAX package.

The tests and the chip smoke run ray-cast analytic scenes: ground-truth
poses and ground-truth SDF are known exactly, so odometry ATE can be
asserted without any dataset.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

import numpy as np


# ----------------------------------------------------------------- scene SDFs


def sdf_box_interior(half_extent: np.ndarray):
    """Signed distance of the *interior* of an axis-aligned room centered at
    origin: positive inside (free), zero at walls, negative outside."""

    he = np.asarray(half_extent, np.float64)

    def f(p: np.ndarray) -> np.ndarray:
        q = he - np.abs(p)  # distance to each wall pair, positive inside
        return np.min(q, axis=-1)

    return f


def sdf_sphere(center: np.ndarray, radius: float):
    c = np.asarray(center, np.float64)

    def f(p: np.ndarray) -> np.ndarray:
        return np.linalg.norm(p - c, axis=-1) - radius

    return f


def sdf_cylinder_z(center_xy: np.ndarray, radius: float):
    c = np.asarray(center_xy, np.float64)

    def f(p: np.ndarray) -> np.ndarray:
        return np.linalg.norm(p[..., :2] - c, axis=-1) - radius

    return f


def scene_union(free_space: Callable, obstacles: List[Callable]):
    """SDF of free space: room interior minus obstacles (distance to the
    nearest surface; positive in free space)."""

    def f(p: np.ndarray) -> np.ndarray:
        d = free_space(p)
        for ob in obstacles:
            d = np.minimum(d, ob(p))
        return d

    return f


def default_scene(half_extent=(20.0, 14.0, 4.0), n_ring_pillars: int = 14,
                  seed: int = 7):
    """A room with a rich ring of pillars and spheres — enough geometry to
    constrain all 6 DoF of a scan registration from anywhere on a circular
    trajectory (large bare planar walls alone leave the along-wall
    translation weakly observable, which real LiDAR scenes rarely do).
    The xy annulus radius 3..9 is kept free of obstacles so circular test
    trajectories up to radius ~8 never enter an object."""
    rng = np.random.RandomState(seed)
    obstacles = [
        sdf_cylinder_z([0.0, 0.0], 1.5),       # center island
        sdf_sphere([0.0, 0.0, 3.0], 2.2),      # cap on the island
    ]
    # irregular ring of pillars outside the trajectory annulus
    for i in range(n_ring_pillars):
        ang = 2 * np.pi * i / n_ring_pillars + rng.uniform(-0.15, 0.15)
        rad = rng.uniform(10.5, 13.0)
        cx = np.clip(rad * np.cos(ang), -half_extent[0] + 1.5,
                     half_extent[0] - 1.5)
        cy = np.clip(rad * np.sin(ang), -half_extent[1] + 1.5,
                     half_extent[1] - 1.5)
        r = rng.uniform(0.5, 1.1)
        obstacles.append(sdf_cylinder_z([cx, cy], r))
        if i % 3 == 0:
            obstacles.append(
                sdf_sphere([cx, cy, rng.uniform(1.0, 3.0)], r + 0.6))
    return scene_union(sdf_box_interior(np.array(half_extent)), obstacles)


# ------------------------------------------------------------------- raycast


def lidar_directions(n_az: int = 256, n_el: int = 16,
                     el_range=(-20.0, 10.0)) -> np.ndarray:
    """Spinning-LiDAR ray directions [n_az*n_el, 3] in the sensor frame."""
    az = np.linspace(0, 2 * np.pi, n_az, endpoint=False)
    el = np.radians(np.linspace(el_range[0], el_range[1], n_el))
    azg, elg = np.meshgrid(az, el, indexing="ij")
    d = np.stack(
        [np.cos(elg) * np.cos(azg), np.cos(elg) * np.sin(azg), np.sin(elg)],
        axis=-1,
    )
    return d.reshape(-1, 3)


def raycast(
    scene_sdf: Callable,
    origin: np.ndarray,
    dirs: np.ndarray,
    max_range: float = 60.0,
    iters: int = 96,
    tol: float = 1e-4,
) -> np.ndarray:
    """Sphere-trace depths [N]; np.inf where no hit within max_range.

    Active-set marching: most rays converge in ~20 steps, so each
    iteration only advances the not-yet-converged subset (identical
    result, ~4x less SDF work at 100k+ rays/frame)."""
    n = dirs.shape[0]
    t = np.zeros(n)
    act = np.arange(n)
    for _ in range(iters):
        p = origin + t[act, None] * dirs[act]
        d = scene_sdf(p)
        ta = np.minimum(t[act] + np.maximum(d, 0.0) * 0.95,
                        max_range * 1.01)
        t[act] = ta
        live = ~((np.abs(d) < tol) | (ta >= max_range))
        act = act[live]
        if act.size == 0:
            break
    p = origin + t[:, None] * dirs
    hit = (np.abs(scene_sdf(p)) < 5e-3) & (t < max_range)
    depths = np.where(hit, t, np.inf)
    return depths


# ------------------------------------------------------------------ sequence


def procedural_color(points_world: np.ndarray) -> np.ndarray:
    """Smooth position-dependent RGB in [0,1] — exact color ground truth for
    RGB-D tests."""
    p = points_world * 0.35
    return 0.5 + 0.5 * np.stack(
        [np.sin(p[:, 0]), np.sin(p[:, 1] + 2.0), np.sin(p[:, 2] + 4.0)], -1)


@dataclass
class SyntheticSequence:
    """A ray-cast LiDAR/RGB-D sequence with ground-truth poses.

    With `sweep=True` the scan is simulated as a spinning sensor: each ray
    fires from the pose slerp-interpolated by its azimuth fraction between
    this frame's pose and the next, and the raw point is recorded in the
    FIRING-TIME sensor frame (exactly a real rotor's rolling-shutter
    distortion, reference get_point_ts dataset/slam_dataset.py:297-347);
    `frame_with_ts` then also returns the per-point [0,1) timestamps that
    a deskew step needs. With `scene_sdf_t` (fn(points, frame_i)->sdf) the
    scene may contain MOVING geometry; `frame` raycasts the time-dependent
    scene while evals score against the static `scene_sdf`."""

    scene_sdf: Callable
    poses: np.ndarray          # [T, 4, 4] float64, sensor->world
    dirs: np.ndarray           # [N, 3] sensor-frame ray dirs
    max_range: float = 60.0
    noise_std: float = 0.0
    seed: int = 0
    color_fn: Callable = None  # world pts [M,3] -> [M,3] rgb in [0,1]
    sweep: bool = False
    scene_sdf_t: Callable = None  # (p [N,3], frame_i) -> sdf

    def __len__(self) -> int:
        return self.poses.shape[0]

    def _scene_at(self, i: int) -> Callable:
        if self.scene_sdf_t is None:
            return self.scene_sdf
        return lambda p: self.scene_sdf_t(p, i)

    def _pose_at(self, i: int, frac: float) -> np.ndarray:
        """Pose at fractional time i+frac (linear translation + yaw)."""
        j = min(i + 1, len(self) - 1)
        Ta, Tb = self.poses[i], self.poses[j]
        T = np.eye(4)
        T[:3, 3] = (1 - frac) * Ta[:3, 3] + frac * Tb[:3, 3]
        from pin_slam_tpu_torch.ops.transforms import np_slerp_rotmats
        dR = Tb[:3, :3] @ Ta[:3, :3].T
        T[:3, :3] = np_slerp_rotmats(dR, np.array([frac]))[0] @ Ta[:3, :3]
        return T

    def frame_with_ts(self, i: int):
        """(points [M, 3(+3)], ts [M] in [0,1)) in the sensor frame."""
        scene = self._scene_at(i)
        if not self.sweep:
            pts = self._cast_static(scene, i)
            az = np.arctan2(pts[:, 1], pts[:, 0])
            ts = ((az + 2 * np.pi) % (2 * np.pi)) / (2 * np.pi)
            return pts, ts.astype(np.float32)

        # swept scan: group rays by azimuth into NSEG firing instants
        NSEG = 16
        az = np.arctan2(self.dirs[:, 1], self.dirs[:, 0])
        frac_all = ((az + 2 * np.pi) % (2 * np.pi)) / (2 * np.pi)
        seg = np.minimum((frac_all * NSEG).astype(int), NSEG - 1)
        pts_parts, ts_parts = [], []
        for s in range(NSEG):
            sel = seg == s
            if not np.any(sel):
                continue
            frac = (s + 0.5) / NSEG
            T = self._pose_at(i, frac)
            wd = self.dirs[sel] @ T[:3, :3].T
            depths = raycast(scene, T[:3, 3], wd, self.max_range)
            hit = np.isfinite(depths)
            d = depths[hit]
            if self.noise_std > 0:
                rng = np.random.RandomState(self.seed + i * NSEG + s)
                d = d + rng.randn(d.shape[0]) * self.noise_std
            # raw point in the firing-time sensor frame (rigid-frame
            # assumption downstream sees the rolling-shutter distortion)
            local = (self.dirs[sel][hit] * d[:, None]).astype(np.float32)
            pts_parts.append(local)
            ts_parts.append(np.full(len(local), frac, np.float32))
        pts = np.concatenate(pts_parts)
        ts = np.concatenate(ts_parts)
        if self.color_fn is not None:
            T = self.poses[i]
            world = pts @ T[:3, :3].T.astype(np.float32) + \
                T[:3, 3].astype(np.float32)
            pts = np.hstack([pts, self.color_fn(world).astype(np.float32)])
        return pts, ts

    def _cast_static(self, scene: Callable, i: int) -> np.ndarray:
        T = self.poses[i]
        world_dirs = self.dirs @ T[:3, :3].T
        depths = raycast(scene, T[:3, 3], world_dirs, self.max_range)
        hit = np.isfinite(depths)
        d = depths[hit]
        if self.noise_std > 0:
            rng = np.random.RandomState(self.seed + i)
            d = d + rng.randn(d.shape[0]) * self.noise_std
        local = (self.dirs[hit] * d[:, None]).astype(np.float32)
        if self.color_fn is not None:
            world = local @ T[:3, :3].T.astype(np.float32) + \
                T[:3, 3].astype(np.float32)
            rgb = self.color_fn(world).astype(np.float32)
            return np.hstack([local, rgb])
        return local

    def frame(self, i: int) -> np.ndarray:
        """Point cloud [M, 3(+3 rgb)] in the sensor frame (hits only)."""
        if self.sweep:
            return self.frame_with_ts(i)[0]
        return self._cast_static(self._scene_at(i), i)


def circle_trajectory(
    n_frames: int, radius: float = 6.0, height: float = 0.0,
    yaw_follow: bool = True, revolutions: float = 0.6,
    ease_in_frames: int = 0,
) -> np.ndarray:
    """Smooth circular trajectory [T, 4, 4] (float64). `ease_in_frames`
    ramps the speed up over the first frames (vehicles don't start at full
    speed; the tracker's constant-velocity prior needs a warm-up)."""
    poses = np.zeros((n_frames, 4, 4))
    if ease_in_frames > 0:
        vel = np.ones(n_frames)
        ramp = np.linspace(0.0, 1.0, ease_in_frames + 1)[1:]
        vel[:ease_in_frames] = ramp * ramp * (3 - 2 * ramp)  # smoothstep
        sdist = np.concatenate([[0.0], np.cumsum(vel[:-1])])
        ang = 2 * np.pi * revolutions * sdist / sdist[-1]
    else:
        ang = np.linspace(0, 2 * np.pi * revolutions, n_frames)
    for i, a in enumerate(ang):
        T = np.eye(4)
        T[:3, 3] = [radius * np.cos(a), radius * np.sin(a), height]
        if yaw_follow:
            yaw = a + np.pi / 2
            c, s = np.cos(yaw), np.sin(yaw)
            T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        poses[i] = T
    return poses


def oval_trajectory(
    n_frames: int, a: float = 16.0, b: float = 8.0,
    laps: float = 2.0, height_amp: float = 0.0, height_waves: float = 2.0,
    ease_in_frames: int = 0,
) -> np.ndarray:
    """Stadium/oval trajectory [T, 4, 4]: an ellipse with semi-axes (a, b),
    yaw following the tangent, and optional VERTICAL motion — height
    oscillates `height_waves` times per lap with amplitude `height_amp`
    (exercises z-translation + pitch observability that planar circles
    never do)."""
    if ease_in_frames > 0:
        vel = np.ones(n_frames)
        ramp = np.linspace(0.0, 1.0, ease_in_frames + 1)[1:]
        vel[:ease_in_frames] = ramp * ramp * (3 - 2 * ramp)
        sdist = np.concatenate([[0.0], np.cumsum(vel[:-1])])
        ang = 2 * np.pi * laps * sdist / sdist[-1]
    else:
        ang = np.linspace(0, 2 * np.pi * laps, n_frames)
    poses = np.zeros((n_frames, 4, 4))
    for i, t in enumerate(ang):
        T = np.eye(4)
        x, y = a * np.cos(t), b * np.sin(t)
        z = height_amp * np.sin(height_waves * t)
        T[:3, 3] = [x, y, z]
        # yaw along the tangent of the ellipse
        yaw = np.arctan2(b * np.cos(t), -a * np.sin(t))
        c, s = np.cos(yaw), np.sin(yaw)
        T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        poses[i] = T
    return poses


def large_scene(half_extent=(34.0, 24.0, 5.0), n_ring_pillars: int = 22,
                seed: int = 11, ring_radii=(19.0, 26.0),
                keepout_a: float = 17.5, keepout_b: float = 9.5):
    """A hall big enough for an oval track: pillar rings inside and outside
    the track's keep-out ellipse (semi-axes keepout_a/b), plus the center
    island. Drives a larger neural-point map than default_scene (capacity
    growth / pruning become reachable in a long run)."""
    rng = np.random.RandomState(seed)
    obstacles = [
        sdf_cylinder_z([0.0, 0.0], 2.5),
        sdf_sphere([0.0, 0.0, 3.5], 3.0),
        sdf_cylinder_z([8.0, 0.0], 1.2),
        sdf_cylinder_z([-8.0, 0.0], 1.2),
    ]
    for i in range(n_ring_pillars):
        ang = 2 * np.pi * i / n_ring_pillars + rng.uniform(-0.12, 0.12)
        rad = rng.uniform(*ring_radii)
        cx = np.clip(rad * np.cos(ang), -half_extent[0] + 1.5,
                     half_extent[0] - 1.5)
        cy = np.clip(rad * np.sin(ang), -half_extent[1] + 1.5,
                     half_extent[1] - 1.5)
        # keep the oval track clear
        if (cx / keepout_a) ** 2 + (cy / keepout_b) ** 2 < 1.0 \
                and abs(cx) < keepout_a:
            cy = np.sign(cy or 1.0) * (half_extent[1] - rng.uniform(2, 6))
        r = rng.uniform(0.5, 1.2)
        obstacles.append(sdf_cylinder_z([cx, cy], r))
        if i % 3 == 0:
            obstacles.append(
                sdf_sphere([cx, cy, rng.uniform(1.0, 3.5)], r + 0.6))
    return scene_union(sdf_box_interior(np.array(half_extent)), obstacles)


def moving_spheres_scene(static_scene: Callable, n_frames: int,
                         n_movers: int = 3, radius: float = 0.8,
                         seed: int = 3):
    """Time-dependent scene: `static_scene` plus `n_movers` spheres
    ("pedestrians") crossing the hall on straight paths at ~0.15 m/frame.
    Returns (scene_t(p, frame_i) -> sdf, mover_centers [T, n, 3]) — the
    centers let an eval measure how many measurements were dynamic."""
    rng = np.random.RandomState(seed)
    starts = np.stack([rng.uniform([-14, -10, 0.8], [14, 10, 1.6])
                       for _ in range(n_movers)])
    vels = rng.uniform(-1, 1, (n_movers, 3))
    vels[:, 2] = 0.0
    vels /= np.linalg.norm(vels, axis=1, keepdims=True)
    vels *= 0.15
    t = np.arange(n_frames)[:, None, None]
    centers = starts[None] + vels[None] * t          # [T, n, 3]
    # bounce at the hall walls
    centers[..., 0] = 14.0 - np.abs(np.abs(centers[..., 0]) % 56.0 - 28.0)
    centers[..., 1] = 10.0 - np.abs(np.abs(centers[..., 1]) % 40.0 - 20.0)

    def scene_t(p: np.ndarray, frame_i: int) -> np.ndarray:
        d = static_scene(p)
        for m in range(n_movers):
            c = centers[min(frame_i, n_frames - 1), m]
            d = np.minimum(d, np.linalg.norm(p - c, axis=-1) - radius)
        return d

    return scene_t, centers


def make_default_sequence(
    n_frames: int = 20, n_az: int = 256, n_el: int = 16,
    noise_std: float = 0.0, radius: float = 6.0, max_range: float = 60.0,
) -> SyntheticSequence:
    return SyntheticSequence(
        scene_sdf=default_scene(),
        poses=circle_trajectory(n_frames, radius=radius),
        dirs=lidar_directions(n_az, n_el),
        max_range=max_range,
        noise_std=noise_std,
    )


def default_scene_semantic(half_extent=(20.0, 14.0, 4.0),
                           n_ring_pillars: int = 14, seed: int = 7):
    """`default_scene` plus a ground-truth semantic labeling: returns
    (scene_sdf, label_fn) where label_fn(world_pts [N,3]) -> [N] int32
    classes {1: room shell, 2: pillars, 3: spheres} (0 reserved for
    unlabeled — excluded from the semantic NLL, reference
    utils/mapper.py:788-793). The label is the argmin-|sdf| primitive."""
    rng = np.random.RandomState(seed)
    shell = sdf_box_interior(np.array(half_extent))
    cylinders = [sdf_cylinder_z([0.0, 0.0], 1.5)]
    spheres = [sdf_sphere([0.0, 0.0, 3.0], 2.2)]
    for i in range(n_ring_pillars):
        ang = 2 * np.pi * i / n_ring_pillars + rng.uniform(-0.15, 0.15)
        rad = rng.uniform(10.5, 13.0)
        cx = np.clip(rad * np.cos(ang), -half_extent[0] + 1.5,
                     half_extent[0] - 1.5)
        cy = np.clip(rad * np.sin(ang), -half_extent[1] + 1.5,
                     half_extent[1] - 1.5)
        r = rng.uniform(0.5, 1.1)
        cylinders.append(sdf_cylinder_z([cx, cy], r))
        if i % 3 == 0:
            spheres.append(
                sdf_sphere([cx, cy, rng.uniform(1.0, 3.0)], r + 0.6))
    scene = scene_union(shell, cylinders + spheres)

    def label_fn(p: np.ndarray) -> np.ndarray:
        d_shell = np.abs(shell(p))
        d_cyl = np.min(np.stack([np.abs(c(p)) for c in cylinders]), 0)
        d_sph = np.min(np.stack([np.abs(s(p)) for s in spheres]), 0)
        return (np.argmin(np.stack([d_shell, d_cyl, d_sph]), 0) + 1
                ).astype(np.int32)

    return scene, label_fn
