"""Faults planted under the timed path, each of which `correct` has to
catch: the tests plant them at a CPU size, and `control.py --fault` reads
them at a cell's own size on the card. Each is a function of a patcher
with pytest's `monkeypatch.setattr(owner, name, value)`."""

from __future__ import annotations

import numpy as np
import torch


class Patcher:
    """`setattr` that `undo` reverts (monkeypatch's, outside pytest)."""

    def __init__(self):
        self._undo = []

    def setattr(self, owner, name, value):
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo = []


def _no_training(self, iters, frame_id, *a, **k):
    return self.last_train_metrics          # the map is left as it was


def _no_update(*a, **k):
    return None                             # Adam's step changes nothing


def _half_batch(orig):
    def loss(geo_features, geo_mlp, batch, mask, *a, **k):
        half = torch.arange(mask.shape[0], device=mask.device) \
            < mask.shape[0] // 2
        return orig(geo_features, geo_mlp, batch, mask & half, *a, **k)
    return loss


def _half_draws(orig):
    def draws(*a, **k):
        d = orig(*a, **k)
        h = d["hist"]
        return dict(d, hist=h[..., :h.shape[-1] // 2])  # half the history
    return draws


def _sdf_altered(orig):
    def query(*a, **k):
        out = orig(*a, **k)
        return out._replace(sdf=out.sdf + 1e-3)
    return query


def _pose_altered(orig):
    def update(self, frame_id, cur_pose):
        if frame_id % 4 == 3:           # one frame in four, from frame 3 on
            cur_pose = cur_pose.copy()
            cur_pose[:3, 3] += np.array([0.3, 0.0, 0.0])
        return orig(self, frame_id, cur_pose)
    return update


def _pose_held(orig):
    def update(self, frame_id, cur_pose):
        # the tracker's state left unchanged: each frame keeps the last pose
        return orig(self, frame_id, self.cur_pose_ref.copy())
    return update


def _plant(name):
    import torch.optim.adam as adam
    from pin_slam_tpu_torch.slam import map_query as mq
    from pin_slam_tpu_torch.slam import mapper as mp
    from pin_slam_tpu_torch.slam import system as sysm
    S = sysm.PinSLAMSystem
    return {
        "state_unchanged": lambda p: p.setattr(S, "train", _no_training),
        "step_unchanged": lambda p: p.setattr(adam, "adam", _no_update),
        "half_batch": lambda p: p.setattr(mp, "mapping_loss",
                                          _half_batch(mp.mapping_loss)),
        "half_draws": lambda p: p.setattr(
            mp, "draw_train_indices", _half_draws(mp.draw_train_indices)),
        "sdf_altered": lambda p: p.setattr(mq, "query_decode",
                                           _sdf_altered(mq.query_decode)),
        "pose_altered": lambda p: p.setattr(
            S, "_update_odom_pose", _pose_altered(S._update_odom_pose)),
        "tracker_unchanged": lambda p: p.setattr(
            S, "_update_odom_pose", _pose_held(S._update_odom_pose)),
    }[name]


FRAME_FAULTS = ("state_unchanged", "step_unchanged", "half_batch",
                "half_draws", "sdf_altered", "pose_altered",
                "tracker_unchanged")


def plant(name: str, patcher) -> None:
    """Plant fault `name` (one of FRAME_FAULTS) through `patcher`."""
    _plant(name)(patcher)
