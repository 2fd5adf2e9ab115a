"""The general frame generator: a configuration's sensor driven along a
traffic file's route through the town that the seed lays out, ray-cast on
the device in batches of frames.

The scans come out as a sensor driver hands them over: host NumPy arrays
of points [N, 3] (float64, in the sensor frame), every column fired from
the scan's pose, which is the frame's ground truth.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from slambench.scene import cast as cast_t
from slambench.scene.route import build_town, frame_arclengths, poses_at

FRAME_BATCH = 4        # scans ray-cast in one call
CULL_MARGIN_M = 40.0   # primitives farther than range + this are skipped
LEAD_M = 60.0          # route before the first frame


@dataclass
class Frames:
    points: List[np.ndarray]           # [N, 3] float64, sensor frame
    truth: np.ndarray                  # [F, 4, 4] the scans' poses
    boxes: np.ndarray
    cylinders: np.ndarray


def sensor_dirs(sensor: dict) -> np.ndarray:
    """Unit ray directions [W, H, 3] of a spinning LiDAR: column c at
    azimuth 2 pi c / W, rows over the elevation range."""
    W, H = sensor["columns"], sensor["rows"]
    az = np.linspace(0.0, 2 * np.pi, W, endpoint=False)
    el = np.radians(np.linspace(sensor["elevation_min_deg"],
                                sensor["elevation_max_deg"], H))
    azg, elg = np.meshgrid(az, el, indexing="ij")
    return np.stack([np.cos(elg) * np.cos(azg), np.cos(elg) * np.sin(azg),
                     np.sin(elg)], -1)


def lower_elevation(p: torch.Tensor, deg: float) -> torch.Tensor:
    """Each point's elevation lowered by `deg`, its range kept: the inverse
    of the dataset layer's KITTI vertical-angle correction."""
    dist = torch.linalg.norm(p, dim=-1).clamp(min=1e-12)
    v = torch.asin(torch.clamp(p[:, 2] / dist, -1.0, 1.0))
    vc = v - math.radians(deg)
    scale = torch.cos(vc) / torch.cos(v).clamp(min=1e-12)
    return torch.stack([p[:, 0] * scale, p[:, 1] * scale,
                        dist * torch.sin(vc)], -1)


def route_need_m(traffic: dict, n_frames: int, sensor: dict) -> float:
    return (n_frames + 2) * traffic["route"]["speed_straight_m"] \
        + sensor["max_range_m"] + LEAD_M + 60.0


def make_frames(spec: dict, traffic: dict, seed: int, n_frames: int,
                device) -> Frames:
    """`n_frames` scans of configuration `spec`'s sensor along `traffic`'s
    route, the town and the range noise drawn from `seed`."""
    sensor = spec["sensor"]
    route, boxes, cyls = build_town(traffic, seed,
                                    route_need_m(traffic, n_frames, sensor))
    # the first frame starts LEAD_M into the town, so that the street
    # behind it is built too
    s0 = frame_arclengths(traffic, n_frames, route.length, LEAD_M)
    h = sensor["height_m"]
    W = sensor["columns"]
    dirs = sensor_dirs(sensor)                              # [W, H, 3]
    truth = poses_at(route, s0, h)

    dt = torch.float32
    dev = torch.device(device)
    dirs_t = torch.as_tensor(dirs, dtype=dt, device=dev)
    box_t = torch.as_tensor(boxes, dtype=dt, device=dev)
    cyl_t = torch.as_tensor(cyls, dtype=dt, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 63))
    sigma = float(sensor["range_noise_m"])
    rmax = float(sensor["max_range_m"])

    points = []
    for f0 in range(0, n_frames, FRAME_BATCH):
        fs = list(range(f0, min(f0 + FRAME_BATCH, n_frames)))
        T = np.broadcast_to(truth[fs][:, None], (len(fs), W, 4, 4))
        org = T[:, :, :2, 3]
        near_b = _near(boxes[:, :2], org, rmax)
        near_c = _near(cyls[:, :2], org, rmax)
        T_t = torch.as_tensor(np.ascontiguousarray(T), dtype=dt, device=dev)
        R = T_t[:, :, :3, :3]                               # [B, W, 3, 3]
        o = T_t[:, :, None, :3, 3].expand(-1, -1, dirs.shape[1], -1)
        d = torch.einsum("bwij,whj->bwhi", R, dirs_t)
        depth = cast_t.cast(o.reshape(-1, 3), d.reshape(-1, 3),
                            box_t[near_b.to(dev)], cyl_t[near_c.to(dev)])
        depth = depth.reshape(len(fs), -1)
        depth = depth + sigma * torch.randn(depth.shape, generator=gen,
                                            device=dev, dtype=dt)
        for b in range(len(fs)):
            ok = torch.isfinite(depth[b]) & (depth[b] < rmax) \
                & (depth[b] > 0.1)
            p = dirs_t.reshape(-1, 3)[ok] * depth[b][ok][:, None]
            if sensor.get("lower_elevation_deg"):
                p = lower_elevation(p, sensor["lower_elevation_deg"])
            points.append(p.double().cpu().numpy())
    return Frames(points, truth, boxes, cyls)


def _near(centres: np.ndarray, origins: np.ndarray, rmax: float):
    """Mask of primitives whose centre lies within range + margin of any
    ray origin of the batch (origins [B, W, 2])."""
    if centres.shape[0] == 0:
        return torch.zeros(0, dtype=torch.bool)
    o = origins.reshape(-1, 2)[:: max(1, origins.shape[1] // 8)]
    d = np.linalg.norm(centres[:, None, :] - o[None], axis=-1).min(1)
    return torch.as_tensor(d < rmax + CULL_MARGIN_M)
