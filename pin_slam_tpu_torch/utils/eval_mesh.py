"""Mesh quality evaluation: chamfer distances, precision/recall/F-score.
Own copy of `pin_slam_tpu/utils/eval_mesh.py`, unchanged in behaviour.

Rebuilds reference eval/eval_mesh_utils.py:8-125 (uniform mesh sampling +
truncated nearest-neighbor correspondences) with scipy's cKDTree replacing
Open3D's KD-tree.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.spatial import cKDTree


def sample_mesh_points(verts: np.ndarray, faces: np.ndarray,
                       n: int, seed: int = 0) -> np.ndarray:
    """Area-weighted uniform sampling of a triangle mesh."""
    tri = verts[faces]
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    if area.sum() <= 0:
        return np.zeros((0, 3))
    rng = np.random.RandomState(seed)
    pick = rng.choice(faces.shape[0], n, p=area / area.sum())
    r1 = np.sqrt(rng.rand(n))
    r2 = rng.rand(n)
    a, b, c = tri[pick, 0], tri[pick, 1], tri[pick, 2]
    return (1 - r1)[:, None] * a + (r1 * (1 - r2))[:, None] * b + \
        (r1 * r2)[:, None] * c


def nn_distances(src: np.ndarray, dst: np.ndarray,
                 truncation: float) -> np.ndarray:
    """Truncated nearest-neighbor distances src -> dst
    (reference: eval/eval_mesh_utils.py:94-125)."""
    tree = cKDTree(dst)
    d, _ = tree.query(src, k=1)
    return np.minimum(d, truncation)


def crop_points_to_region(
    pts: np.ndarray, region_pts: np.ndarray,
    voxel: float = 0.5, margin: int = 1,
) -> np.ndarray:
    """Keep `pts` whose voxel lies within `margin` voxels of any
    `region_pts` voxel — the evaluation analog of the reference's
    intersection cropping (reference: eval/eval_mesh_utils.py:164-201):
    predicted surface in regions the sensor never observed must not count
    as spurious geometry."""
    occ = np.unique(np.floor(region_pts / voxel).astype(np.int64), axis=0)
    if margin > 0:
        offs = np.stack(np.meshgrid(*([np.arange(-margin, margin + 1)] * 3),
                                    indexing="ij"), -1).reshape(-1, 3)
        occ = np.unique((occ[:, None, :] + offs[None]).reshape(-1, 3),
                        axis=0)
    occ_v = np.ascontiguousarray(occ).view(
        np.dtype((np.void, occ.dtype.itemsize * 3))).ravel()
    g = np.ascontiguousarray(
        np.floor(pts / voxel).astype(np.int64)).view(
        np.dtype((np.void, 8 * 3))).ravel()
    keep = np.isin(g, occ_v)
    return pts[keep]


def eval_mesh(
    pred_points: np.ndarray,
    gt_points: np.ndarray,
    threshold: float = 0.05,
    truncation_acc: float = 0.5,
    truncation_com: float = 0.5,
    crop_pred_to_gt: bool = False,
    crop_voxel: float = 0.5,
) -> Dict[str, float]:
    """Chamfer-L1/L2 [m] + precision/recall/F-score [%] at `threshold`
    (reference: eval/eval_mesh_utils.py:8-91). With crop_pred_to_gt the
    predicted samples are first restricted to the GT-observed region
    (reference intersection-crop protocol, :164-201)."""
    if crop_pred_to_gt and pred_points.shape[0] and gt_points.shape[0]:
        pred_points = crop_points_to_region(pred_points, gt_points,
                                            voxel=crop_voxel)
    if pred_points.shape[0] == 0 or gt_points.shape[0] == 0:
        return {
            "MAE_accuracy (m)": float("inf"),
            "MAE_completeness (m)": float("inf"),
            "Chamfer_L1 (m)": float("inf"),
            "Chamfer_L2 (m)": float("inf"),
            "Precision [Accuracy] (%)": 0.0,
            "Recall [Completeness] (%)": 0.0,
            "F-score (%)": 0.0,
            "Spacing (m)": threshold,
        }
    acc = nn_distances(pred_points, gt_points, truncation_acc)
    com = nn_distances(gt_points, pred_points, truncation_com)
    precision = float((acc < threshold).mean() * 100.0)
    recall = float((com < threshold).mean() * 100.0)
    fscore = (
        2 * precision * recall / (precision + recall)
        if precision + recall > 0 else 0.0
    )
    chamfer_l1 = float(0.5 * (acc.mean() + com.mean()))
    chamfer_l2 = float(np.sqrt(0.5 * ((acc**2).mean() + (com**2).mean())))
    return {
        "MAE_accuracy (m)": float(acc.mean()),
        "MAE_completeness (m)": float(com.mean()),
        "Chamfer_L1 (m)": chamfer_l1,
        "Chamfer_L2 (m)": chamfer_l2,
        "Precision [Accuracy] (%)": precision,
        "Recall [Completeness] (%)": recall,
        "F-score (%)": fscore,
        "Spacing (m)": threshold,
    }


def point_to_mesh_distance(points: np.ndarray, verts: np.ndarray,
                           faces: np.ndarray, k: int = 16,
                           block: int = 65536) -> np.ndarray:
    """EXACT point-to-triangle-mesh distance (Ericson's closest-point-on-
    triangle, vectorized), with a centroid k-d tree preselecting `k`
    candidate triangles per query.

    Point-cloud-sampled chamfer (the reference protocol,
    eval/eval_mesh_utils.py:94-125) adds the sample spacing as a distance
    floor — at gauntlet densities (~3.5 cm median spacing) an exactly
    correct surface fails a 5 cm threshold ~1/3 of the time. Exact
    triangle distance removes that bias; candidate preselection keeps it
    O(N k) instead of O(N F)."""
    if faces.shape[0] == 0 or points.shape[0] == 0:
        return np.full(points.shape[0], np.inf)
    tri = verts[faces].astype(np.float64)          # [F, 3, 3]
    cent = tri.mean(1)
    tree = cKDTree(cent)
    k = min(k, faces.shape[0])
    out = np.empty(points.shape[0])
    for s in range(0, points.shape[0], block):
        p = points[s: s + block].astype(np.float64)
        _, idx = tree.query(p, k=k)
        if k == 1:
            idx = idx[:, None]
        t = tri[idx]                               # [B, k, 3, 3]
        a, b, c = t[..., 0, :], t[..., 1, :], t[..., 2, :]
        q = p[:, None, :]
        ab, ac, ap = b - a, c - a, q - a
        d1 = np.einsum("bkd,bkd->bk", ab, ap)
        d2 = np.einsum("bkd,bkd->bk", ac, ap)
        bp = q - b
        d3 = np.einsum("bkd,bkd->bk", ab, bp)
        d4 = np.einsum("bkd,bkd->bk", ac, bp)
        cp = q - c
        d5 = np.einsum("bkd,bkd->bk", ab, cp)
        d6 = np.einsum("bkd,bkd->bk", ac, cp)
        va = d3 * d6 - d5 * d4
        vb = d5 * d2 - d1 * d6
        vc = d1 * d4 - d3 * d2
        denom = np.maximum(va + vb + vc, 1e-30)
        v = np.clip(vb / denom, 0.0, 1.0)
        w = np.clip(vc / denom, 0.0, 1.0)
        # interior closest point, then clamp the six edge/vertex regions
        closest = a + v[..., None] * ab + w[..., None] * ac
        # vertex regions
        closest = np.where((d1 <= 0)[..., None] & (d2 <= 0)[..., None],
                           a, closest)
        closest = np.where((d3 >= 0)[..., None] & (d4 <= d3)[..., None],
                           b, closest)
        closest = np.where((d6 >= 0)[..., None] & (d5 <= d6)[..., None],
                           c, closest)
        # edge AB
        vab = np.clip(np.where(d1 - d3 != 0, d1 / np.maximum(d1 - d3, 1e-30),
                               0.0), 0.0, 1.0)
        on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
        closest = np.where(on_ab[..., None], a + vab[..., None] * ab,
                           closest)
        # edge AC
        wac = np.clip(np.where(d2 - d6 != 0, d2 / np.maximum(d2 - d6, 1e-30),
                               0.0), 0.0, 1.0)
        on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
        closest = np.where(on_ac[..., None], a + wac[..., None] * ac,
                           closest)
        # edge BC
        num = d4 - d3
        wbc = np.clip(num / np.maximum(num + (d5 - d6), 1e-30), 0.0, 1.0)
        on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
        closest = np.where(on_bc[..., None], b + wbc[..., None] * (c - b),
                           closest)
        d = np.linalg.norm(q - closest, axis=-1)
        out[s: s + block] = d.min(1)
    return out
