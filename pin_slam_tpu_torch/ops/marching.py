"""Vectorized marching tetrahedra (host-side NumPy). Own copy of
`pin_slam_tpu/ops/marching.py`, unchanged in behaviour.

Replaces the reference's dependency on skimage.measure.marching_cubes
(Cython; reference: utils/mesher.py:369-397) with an in-repo, fully
vectorized marching-tetrahedra pass:

* each grid cell is split into 6 tetrahedra around the main diagonal,
* the 16-case tet triangulation table is generated programmatically (no
  hand-copied tables), and triangle orientation is fixed numerically by
  aligning each face normal with the local SDF gradient,
* vertices are welded by their (grid-edge) key so the output mesh is
  watertight across cells and chunks share no duplicated interior vertices.

The SDF grid itself is produced on the device by the shared query/decode path;
this pass is cheap, branch-free NumPy on the [X,Y,Z] value grid.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# cube corners (x, y, z) offsets, indexed 0..7
_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    np.int64,
)

# 6-tetrahedra split of the cube around the main diagonal c0-c6
_TETS = np.array(
    [
        [0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
        [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6],
    ],
    np.int64,
)


def _build_tet_table() -> np.ndarray:
    """[16, 2, 3, 2] table: case -> up to 2 triangles of 3 edges, each edge a
    (inside_vertex, outside_vertex) local pair; -1 padding."""
    table = np.full((16, 2, 3, 2), -1, np.int64)
    for case in range(1, 15):
        inside = [i for i in range(4) if case >> i & 1]
        outside = [i for i in range(4) if i not in inside]
        if len(inside) == 1:
            a = inside[0]
            tris = [[(a, outside[0]), (a, outside[1]), (a, outside[2])]]
        elif len(inside) == 3:
            d = outside[0]
            tris = [[(inside[0], d), (inside[1], d), (inside[2], d)]]
        else:  # 2 inside: quad -> 2 triangles
            i0, i1 = inside
            o0, o1 = outside
            quad = [(i0, o0), (i0, o1), (i1, o1), (i1, o0)]
            tris = [[quad[0], quad[1], quad[2]], [quad[0], quad[2], quad[3]]]
        for t, tri in enumerate(tris):
            for e, pair in enumerate(tri):
                table[case, t, e] = pair
    return table


_TET_TABLE = _build_tet_table()


def marching_tetrahedra(
    sdf: np.ndarray,
    mask: Optional[np.ndarray] = None,
    origin: Optional[np.ndarray] = None,
    voxel_size: float = 1.0,
    level: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the `level` iso-surface of a dense SDF grid.

    Args:
        sdf:  [X, Y, Z] float values (positive = free space / outside).
        mask: [X, Y, Z] bool; a cell is meshed only if all 8 corners are
              valid (semantics of the reference's mc_mask,
              utils/mesher.py:156-162,386-388).
        origin: world position of grid node (0,0,0).
        voxel_size: grid spacing (m).
    Returns:
        (vertices [V, 3] float64, faces [F, 3] int64), oriented so face
        normals point toward positive SDF.
    """
    X, Y, Z = sdf.shape
    if X < 2 or Y < 2 or Z < 2:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    vals = sdf - level

    # corner values per cell [Ncell, 8]
    cx, cy, cz = X - 1, Y - 1, Z - 1
    gi, gj, gk = np.meshgrid(
        np.arange(cx), np.arange(cy), np.arange(cz), indexing="ij")
    base = np.stack([gi, gj, gk], -1).reshape(-1, 3)        # [Ncell, 3]

    corner_idx = base[:, None, :] + _CORNERS[None, :, :]    # [Ncell, 8, 3]
    lin = (corner_idx[..., 0] * Y + corner_idx[..., 1]) * Z + corner_idx[..., 2]
    v8 = vals.reshape(-1)[lin]                               # [Ncell, 8]

    cell_ok = np.ones(base.shape[0], bool)
    if mask is not None:
        cell_ok = mask.reshape(-1)[lin].all(axis=1)
    # cells fully inside/outside can't produce surface
    sign = v8 < 0
    cell_active = cell_ok & ~(sign.all(1)) & (sign.any(1))
    if not np.any(cell_active):
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    v8 = v8[cell_active]
    lin = lin[cell_active]
    n_cell = v8.shape[0]

    all_tri_edges = []  # (edge endpoint grid ids [M, 3, 2], vals [M, 3, 2])
    for tet in _TETS:
        tv = v8[:, tet]                                      # [N, 4]
        tg = lin[:, tet]                                     # [N, 4]
        inside = tv < 0
        case = (inside * np.array([1, 2, 4, 8])).sum(1)      # [N]
        active = (case > 0) & (case < 15)
        if not np.any(active):
            continue
        tv, tg, case = tv[active], tg[active], case[active]
        pairs = _TET_TABLE[case]                             # [M, 2, 3, 2]
        for t in range(2):
            p = pairs[:, t]                                  # [M, 3, 2]
            ok = p[:, 0, 0] >= 0
            if not np.any(ok):
                continue
            pm, tvm, tgm = p[ok], tv[ok], tg[ok]
            rows = np.arange(pm.shape[0])[:, None, None]
            e_gid = tgm[rows, pm]                            # [M, 3, 2]
            e_val = tvm[rows, pm]                            # [M, 3, 2]
            all_tri_edges.append((e_gid, e_val))

    if not all_tri_edges:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    e_gid = np.concatenate([a for a, _ in all_tri_edges])    # [T, 3, 2]
    e_val = np.concatenate([b for _, b in all_tri_edges])    # [T, 3, 2]

    # weld vertices: canonical edge key (min gid, max gid)
    flat_gid = e_gid.reshape(-1, 2)
    flat_val = e_val.reshape(-1, 2)
    swap = flat_gid[:, 0] > flat_gid[:, 1]
    flat_gid[swap] = flat_gid[swap][:, ::-1]
    flat_val[swap] = flat_val[swap][:, ::-1]
    nvox = X * Y * Z
    key = flat_gid[:, 0] * nvox + flat_gid[:, 1]
    uniq, inv = np.unique(key, return_inverse=True)
    first = np.zeros(uniq.shape[0], np.int64)
    first[inv[::-1]] = np.arange(key.shape[0])[::-1]

    ugid = flat_gid[first]                                   # [V, 2]
    uval = flat_val[first]                                   # [V, 2]
    t = uval[:, 0] / (uval[:, 0] - uval[:, 1] + 1e-30)
    t = np.clip(t, 0.0, 1.0)

    def gid_to_xyz(g):
        return np.stack([g // (Y * Z), (g // Z) % Y, g % Z], -1).astype(
            np.float64)

    p0 = gid_to_xyz(ugid[:, 0])
    p1 = gid_to_xyz(ugid[:, 1])
    verts = p0 + t[:, None] * (p1 - p0)
    verts *= voxel_size
    if origin is not None:
        verts += np.asarray(origin, np.float64)

    faces = inv.reshape(-1, 3)

    # orient: normal should point toward positive SDF (outside).
    tri = verts[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    # local gradient from the edge directions: use interpolated endpoint vals
    # d(p1) - d(p0) along each welded edge gives a crude gradient sample
    edge_dir = (gid_to_xyz(ugid[:, 1]) - gid_to_xyz(ugid[:, 0])) * voxel_size
    edge_dval = uval[:, 1] - uval[:, 0]
    grad_v = edge_dir * np.sign(edge_dval)[:, None]
    g_tri = grad_v[faces].mean(axis=1)
    flip = (n * g_tri).sum(1) < 0
    faces[flip] = faces[flip][:, ::-1]

    # drop degenerate faces (two identical welded vertices)
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[good]


def filter_small_clusters(
    verts: np.ndarray, faces: np.ndarray, min_cluster_vertices: int
) -> np.ndarray:
    """Remove connected components with fewer vertices than the threshold
    (reference: utils/mesher.py:443-456, Open3D cluster_connected_triangles).
    Union-find over face edges. Returns filtered faces."""
    n = verts.shape[0]
    parent = np.arange(n)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for f in faces:
        ra, rb, rc = find(f[0]), find(f[1]), find(f[2])
        parent[rb] = ra
        parent[rc] = ra
    roots = np.array([find(i) for i in range(n)])
    counts = np.bincount(roots, minlength=n)
    keep_vert = counts[roots] >= min_cluster_vertices
    keep_face = keep_vert[faces].all(axis=1)
    return faces[keep_face]
