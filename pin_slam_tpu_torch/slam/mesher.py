"""Mesh reconstruction: dense SDF-grid queries + marching tetrahedra. Port
of `pin_slam_tpu/slam/mesher.py`.

The dense grid coordinates stream in `infer_bs`-sized batches through the
lset-less query/decode path (`map_query.query_decode` with a `MapState`:
the cell-table probe, then the decode), the marching mask keeps only cells
whose corners all saw >= mesh_min_nn neighbors, and the iso-surface is
extracted on the host by the vectorized marching-tetrahedra pass of
`ops/marching.py`. Chunking over the map bounding box keeps peak memory
bounded for city-scale maps.

Queries run under `torch.no_grad()`. In `weighted_first=False` mode with a
decoder the kernel of `ops/fused_decode.py` computes (one hidden layer,
ReLU) every batch is one launch of that kernel; the mesher picks the route
from these static facts before its first query and keeps it in
`decode_route`. Grid coordinates are made on the map's device per
batch (the last batch is ragged, not padded) and each grid is pulled to the
host once. Per-vertex colour/semantics (`vertex_attributes`) and sharding
the batches over several devices are not ported yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from pin_slam_tpu_torch.models import neural_points as npm
from pin_slam_tpu_torch.ops import fused_decode
from pin_slam_tpu_torch.ops.marching import (
    filter_small_clusters,
    marching_tetrahedra,
)
from pin_slam_tpu_torch.slam import map_query as mq


@dataclass
class MeshConfig:
    mc_res_m: float = 0.3
    pad_voxel: int = 3
    skip_top_voxel: int = 2
    mc_mask_on: bool = True
    mesh_min_nn: int = 8
    min_cluster_vertices: int = 300
    infer_bs: int = 1 << 16
    chunk_m: float = 100.0


class Mesher:
    def __init__(self, qp: mq.QueryParams, mc: MeshConfig):
        self.qp = qp
        self.mc = mc
        # running totals over this mesher's calls (logs and benchmarks)
        self.n_batches = 0
        self.query_seconds = 0.0      # grid queries incl. the pull to the host
        self.marching_seconds = 0.0   # host-side iso-surface extraction
        # "fused_decode" or "plain", set by the first query
        self.decode_route: Optional[str] = None

    # ---------------------------------------------------------------- query

    def _query_points(
        self, state: npm.MapState, geo_features, geo_mlp, n: int,
        coords_of: Callable[[int, int], torch.Tensor],
    ) -> Tuple[np.ndarray, np.ndarray]:
        """SDF and nn-count of n points, `coords_of(lo, hi)` giving the
        device coordinates of rows lo..hi, in batches of infer_bs."""
        dev = state.positions.device
        bs = self.mc.infer_bs
        t0 = time.time()
        fused = (not self.qp.weighted_first
                 and fused_decode.supports(geo_mlp, self.qp.mlp_leaky_relu))
        self.decode_route = "fused_decode" if fused else "plain"
        sdf = torch.empty(n, dtype=torch.float32, device=dev)
        nn = torch.empty(n, dtype=torch.int32, device=dev)
        with torch.no_grad():
            for lo in range(0, n, bs):
                hi = min(lo + bs, n)
                out = mq.query_decode(geo_features, geo_mlp,
                                      coords_of(lo, hi), self.qp,
                                      state=state, fused=fused)
                sdf[lo:hi] = out.sdf
                nn[lo:hi] = out.nn_count
                self.n_batches += 1
        sdf, nn = sdf.cpu().numpy(), nn.cpu().numpy()
        self.query_seconds += time.time() - t0
        return sdf, nn

    def grid_coords(self, origin: np.ndarray, dims: Tuple[int, int, int],
                    lo: int, hi: int, device) -> torch.Tensor:
        """Coordinates [hi-lo, 3] of rows lo..hi of the dense [X,Y,Z] grid
        (z fastest), made on `device`."""
        _, Y, Z = dims
        org = torch.as_tensor(np.asarray(origin, np.float32), device=device)
        idx = torch.arange(lo, hi, dtype=torch.int64, device=device)
        ijk = torch.stack(
            [torch.div(idx, Y * Z, rounding_mode="floor"),
             torch.div(idx, Z, rounding_mode="floor") % Y, idx % Z], -1)
        return ijk.to(torch.float32) * self.mc.mc_res_m + org

    def query_sdf_grid(
        self, state: npm.MapState, geo_features, geo_mlp,
        origin: np.ndarray, dims: Tuple[int, int, int],
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Query SDF + nn-count over a dense [X,Y,Z] grid in fixed-size
        batches."""
        X, Y, Z = dims
        dev = state.positions.device
        sdf, nn = self._query_points(
            state, geo_features, geo_mlp, X * Y * Z,
            lambda lo, hi: self.grid_coords(origin, dims, lo, hi, dev))
        return sdf.reshape(dims), nn.reshape(dims)

    # ------------------------------------------------------------- chunking

    @staticmethod
    def split_chunks(min_bound: np.ndarray, max_bound: np.ndarray,
                     chunk_m: float) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Split an AABB into <= chunk_m-sized tiles along the two longest
        horizontal axes."""
        rng = max_bound - min_bound
        ax0 = 0 if rng[0] > rng[1] else 1
        ax1 = 1 - ax0
        chunks = []
        s0 = np.arange(min_bound[ax0], max_bound[ax0] + 1e-5, chunk_m)
        for a in s0:
            s1 = np.arange(min_bound[ax1], max_bound[ax1] + 1e-5, chunk_m)
            for b in s1:
                lo = min_bound.copy()
                hi = max_bound.copy()
                lo[ax0], hi[ax0] = a, min(a + chunk_m, max_bound[ax0])
                lo[ax1], hi[ax1] = b, min(b + chunk_m, max_bound[ax1])
                if np.all(hi > lo):
                    chunks.append((lo, hi))
        return chunks

    # ------------------------------------------------------------ recon api

    def aabb_grid(self, min_bound: np.ndarray, max_bound: np.ndarray,
                  ) -> Tuple[np.ndarray, Tuple[int, int, int]]:
        """Origin and dims of the marching grid over one AABB: padded by
        pad_voxel cells, the top skip_top_voxel cells dropped."""
        res = self.mc.mc_res_m
        lo = np.asarray(min_bound, np.float64) - self.mc.pad_voxel * res
        hi = np.asarray(max_bound, np.float64) + self.mc.pad_voxel * res
        hi[2] -= self.mc.skip_top_voxel * res
        dims = tuple(
            int(max(np.ceil((hi[i] - lo[i]) / res) + 1, 2)) for i in range(3))
        if np.prod(dims) > 5e8:
            raise ValueError(f"mc grid too large: {dims}")
        return lo, dims

    def recon_aabb_mesh(
        self, state: npm.MapState, geo_features, geo_mlp,
        min_bound: np.ndarray, max_bound: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Mesh one AABB."""
        res = self.mc.mc_res_m
        lo, dims = self.aabb_grid(min_bound, max_bound)
        sdf, nn = self.query_sdf_grid(state, geo_features, geo_mlp, lo, dims)
        mask = (nn >= self.mc.mesh_min_nn) if self.mc.mc_mask_on else None
        t0 = time.time()
        verts, faces = marching_tetrahedra(
            sdf, mask, origin=lo, voxel_size=res)
        self.marching_seconds += time.time() - t0
        return verts, faces

    def recon_map_mesh(
        self, state: npm.MapState, geo_features, geo_mlp,
        filter_isolated: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Mesh the whole map, chunked."""
        cnt = int(state.count)
        if cnt == 0:
            return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
        pos = state.positions[:cnt]
        lo = pos.amin(0).cpu().numpy()
        hi = pos.amax(0).cpu().numpy()
        all_v, all_f = [], []
        voff = 0
        for c_lo, c_hi in self.split_chunks(lo, hi, self.mc.chunk_m):
            v, f = self.recon_aabb_mesh(state, geo_features, geo_mlp,
                                        c_lo, c_hi)
            if v.shape[0] == 0:
                continue
            all_v.append(v)
            all_f.append(f + voff)
            voff += v.shape[0]
        if not all_v:
            return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
        verts = np.concatenate(all_v)
        faces = np.concatenate(all_f)
        if filter_isolated and self.mc.min_cluster_vertices > 0:
            t0 = time.time()
            faces = filter_small_clusters(verts, faces,
                                          self.mc.min_cluster_vertices)
            self.marching_seconds += time.time() - t0
        return verts, faces

    # ------------------------------------------------------------ sdf slice

    def sdf_slice(
        self, state: npm.MapState, geo_features, geo_mlp,
        center: np.ndarray, extent: float, height: float,
        res: Optional[float] = None, axis: str = "z",
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """SDF slice for visualization. `axis` is the slice normal: "z"
        gives the horizontal slice at z=`height`; "x" or "y" give vertical
        slices at x/y=`height`. Returns (us, vs, sdf[U,V]) in the two
        in-plane axes."""
        res = res or self.mc.mc_res_m
        ax = {"x": 0, "y": 1, "z": 2}[axis]
        u_ax, v_ax = [a for a in range(3) if a != ax]
        xs = np.arange(center[u_ax] - extent, center[u_ax] + extent, res)
        ys = np.arange(center[v_ax] - extent, center[v_ax] + extent, res)
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        cols = [None, None, None]
        cols[u_ax], cols[v_ax] = gx, gy
        cols[ax] = np.full_like(gx, height)
        pts = torch.as_tensor(
            np.stack(cols, -1).reshape(-1, 3).astype(np.float32),
            device=state.positions.device)
        sdf, _ = self._query_points(state, geo_features, geo_mlp,
                                    pts.shape[0], lambda lo, hi: pts[lo:hi])
        return xs, ys, sdf.reshape(len(xs), len(ys))


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray,
              colors: Optional[np.ndarray] = None):
    """Minimal ASCII PLY writer (host tooling)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {verts.shape[0]}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write(f"element face {faces.shape[0]}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        if colors is not None:
            cu = np.clip(colors * 255, 0, 255).astype(np.uint8)
            for v, c in zip(verts, cu):
                f.write(f"{v[0]:.4f} {v[1]:.4f} {v[2]:.4f} "
                        f"{c[0]} {c[1]} {c[2]}\n")
        else:
            for v in verts:
                f.write(f"{v[0]:.4f} {v[1]:.4f} {v[2]:.4f}\n")
        for fc in faces:
            f.write(f"3 {fc[0]} {fc[1]} {fc[2]}\n")
