"""One step of PIN-SLAM's sliding-window bundle adjustment in plain
PyTorch, float64: the reference for the program's BA.

A BA run optimises the last W poses of the chain together with the map's
features against the squared SDF at measured surface points; the decoder
is frozen. Each pose is its frozen base pose right-multiplied by a tangent
delta [w, t]: pose_i = base_i @ [Exp(w) | t] for i >= first_opt (Exp is
SO(3)'s exponential, Rodrigues' formula). A surface sample, stored in
world coordinates and taken by frame ts, is moved into that frame's sensor
frame under its base pose and back out under its optimised pose:
coord = R_i (R_base_i^T (x - t_base_i)) + t_i. The loss is the mean of
the squared SDF over the samples (`decode.sdf`, with the neighbours the
cell probe finds round each sample's coordinate at delta 0). Adam then
steps two groups, the deltas at `lr_pose` and the features at `lr_map`;
its first step is lr * m1 / (sqrt(m2) + eps) with m1 = g, m2 = g^2 after
the bias corrections.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from slambench.reference import decode as R
from slambench.reference.settings import Settings


class BAStep(NamedTuple):
    loss: float
    sdf: torch.Tensor            # [N] float64, each sample's SDF
    grad_deltas: torch.Tensor    # [W, 6] float64
    grad_feats: torch.Tensor     # [M, F] float64
    step_deltas: torch.Tensor    # [W, 6] the deltas after Adam's step
    step_feats: torch.Tensor     # [M, F] the features' change


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] of axis-angle vectors w [..., 3]."""
    theta2 = (w * w).sum(-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2.clamp(min=1e-300))
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2.clamp(min=1e-300))
    z = torch.zeros_like(w[..., 0])
    K = torch.stack([z, -w[..., 2], w[..., 1],
                     w[..., 2], z, -w[..., 0],
                     -w[..., 1], w[..., 0], z], -1).reshape(
        w.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand_as(K)
    return eye + a * K + b * (K @ K)


def optimised_poses(base: torch.Tensor, deltas: torch.Tensor,
                    first_opt: int) -> torch.Tensor:
    """base [T, 4, 4] with the last W = T - first_opt right-multiplied by
    [Exp(w) | t] of deltas [W, 6] = [w, t]."""
    W = deltas.shape[0]
    D = torch.zeros((W, 4, 4), dtype=base.dtype, device=base.device)
    D[:, :3, :3] = so3_exp(deltas[:, :3])
    D[:, :3, 3] = deltas[:, 3:]
    D[:, 3, 3] = 1.0
    return torch.cat([base[:first_opt], base[first_opt:] @ D])


def ba_step(world: torch.Tensor, ts: torch.Tensor, base: torch.Tensor,
            first_opt: int, pts: torch.Tensor, map_ts: torch.Tensor,
            feats: torch.Tensor, params, st: Settings, *, lr_pose: float,
            lr_map: float, eps: float,
            quats: Optional[torch.Tensor] = None,
            filt: Optional[R.Filter] = None) -> BAStep:
    """BA's first step over the surface samples world [N, 3] (float32 as
    the pool keeps them) of frames ts [N], the base poses base [T, 4, 4]
    of which the last T - first_opt are optimised, and the map rows pts
    [M, 3] (created at frames map_ts [M]) with features feats [M, F] and
    the frozen decoder `params` ([W...], [b...]). Everything is computed
    in float64."""
    dev = world.device
    base = base.double()
    W = base.shape[0] - first_opt
    ts = ts.long()
    table = R.CellTable(pts, map_ts, st)
    nb = R.neighbours(world.double(), pts, table, st, filt=filt,
                      q_cell=world.float())
    params64 = ([w.double() for w in params[0]],
                [b.double() for b in params[1]])
    deltas = torch.zeros((W, 6), dtype=torch.float64, device=dev,
                         requires_grad=True)
    f64 = feats.double().clone().requires_grad_(True)
    poses = optimised_poses(base, deltas, first_opt)
    bT = base[ts]
    local = torch.einsum("nba,nb->na", bT[:, :3, :3],
                         world.double() - bT[:, :3, 3])
    oT = poses[ts]
    coord = torch.einsum("nab,nb->na", oT[:, :3, :3], local) + oT[:, :3, 3]
    sdf = R.sdf(coord, nb, pts, f64, params64, st, quats=quats)
    loss = (sdf * sdf).mean()
    g_d, g_f = torch.autograd.grad(loss, (deltas, f64))
    # Adam's first step: m1 / (1 - b1) = g and m2 / (1 - b2) = g^2
    step_d = -lr_pose * g_d / (g_d.abs() + eps)
    step_f = -lr_map * g_f / (g_f.abs() + eps)
    return BAStep(float(loss.detach()), sdf.detach(), g_d, g_f, step_d,
                  step_f)


def rel_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The norm of got - ref over the norm of ref."""
    return float(torch.linalg.vector_norm(got.double() - ref.double())
                 / torch.linalg.vector_norm(ref.double()).clamp(min=1e-300))


def step_gap(got: torch.Tensor, ref: torch.Tensor, grad: torch.Tensor,
             lr: float):
    """Adam's first step `got` against the reference's `ref` from its
    gradient `grad`: (the widest elementwise gap over lr where |grad| is
    above 1e-6 of its largest, the share of nonzero gradient elements
    below that, where float32 may flip the step's sign)."""
    clear = grad.abs() > 1e-6 * grad.abs().max()
    gap = ((got.double() - ref.double()).abs() / lr)[clear]
    return (float(gap.max()) if gap.numel() else 0.0,
            float((~clear & (grad != 0)).double().mean()))


def ambiguous(world: torch.Tensor, pts: torch.Tensor, map_ts: torch.Tensor,
              st: Settings, filt: Optional[R.Filter] = None,
              face_m: float = 1e-5) -> torch.Tensor:
    """[N] samples whose neighbour set float32 rounding could change: a
    distance tie or bound within rounding (`decode.neighbours`), or a
    coordinate within `face_m` of a voxel face, where the program's
    float32 round trip through the base pose may hash another voxel."""
    table = R.CellTable(pts, map_ts, st)
    amb = R.neighbours(world.double(), pts, table, st, filt=filt,
                       q_cell=world.float()).ambiguous
    u = world.double() / st.voxel_m
    frac = (u - torch.floor(u)) * st.voxel_m
    face = ((frac < face_m) | (frac > st.voxel_m - face_m)).any(-1)
    return amb | face
