"""Carry the JAX package's parameters and map state into the port.

`from_jax` takes plain numpy arrays (the caller pulls them out of the JAX
objects with `np.asarray`), so this module needs nothing of JAX itself:

    params_np = {"geo_mlp": {"w": [np.asarray(w) for w in mlp["w"]],
                             "b": [np.asarray(b) for b in mlp["b"]]}}
    state_np = {f: np.asarray(getattr(state, f)) for f in STATE_FIELDS}
    pool_np = {f: np.asarray(getattr(pool, f)) for f in POOL_FIELDS}

and, where the JAX objects carry them, "color_mlp" / "sem_mlp" in params_np,
"color_features" and the brick cache "btable" in state_np (COLOR_FIELDS,
BRICK_FIELDS) and "sem_label" / "color_label" in pool_np
(POOL_LABEL_FIELDS). A JAX `GaussianFourierFeatures` crosses with
`gaussian_pe_from_jax`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pin_slam_tpu_torch.device import resolve_device
from pin_slam_tpu_torch.models import neural_points as npm

STATE_FIELDS = ("positions", "orientations", "geo_features", "ts_create",
                "ts_update", "certainty", "count", "table")
POOL_FIELDS = ("coord", "sdf_label", "weight", "ts", "count", "new_idx",
               "new_count", "write_pos")
COLOR_FIELDS = ("color_features",)
BRICK_FIELDS = ("btable",)
POOL_LABEL_FIELDS = ("sem_label", "color_label")
MLP_NAMES = ("geo_mlp", "color_mlp", "sem_mlp")


def mlp_from_numpy(mlp_np, device=None):
    """The decoder's {"w": [...], "b": [...]} as float32 tensors on `device`
    (None: the card, see `device.resolve_device`)."""
    device = resolve_device(device)
    return {"w": [torch.as_tensor(np.array(w, np.float32), device=device)
                  for w in mlp_np["w"]],
            "b": [torch.as_tensor(np.array(b, np.float32), device=device)
                  for b in mlp_np["b"]]}


def state_from_numpy(state_np, device=None) -> npm.MapState:
    """A MapState from numpy arrays of the STATE_FIELDS (and the
    COLOR_FIELDS and BRICK_FIELDS, when given and not None) on `device`
    (None: the card). Without a "btable" the state keeps the dump brick
    alone; `neural_points.rebuild_probe_cache` cannot rebuild it then."""
    device = resolve_device(device)

    def t(name, dtype):
        return torch.as_tensor(np.array(state_np[name]), device=device
                               ).to(dtype).clone()

    return npm.MapState(
        positions=t("positions", torch.float32),
        orientations=t("orientations", torch.float32),
        geo_features=t("geo_features", torch.float32),
        ts_create=t("ts_create", torch.int32),
        ts_update=t("ts_update", torch.int32),
        certainty=t("certainty", torch.float32),
        count=t("count", torch.int64),
        table=t("table", torch.int64),
        color_features=None if state_np.get("color_features") is None
        else t("color_features", torch.float32),
        btable=npm._empty_btable(0, device)
        if state_np.get("btable") is None else t("btable", torch.int32),
    )


def pool_from_numpy(pool_np, device=None):
    """The replay pool (slam/mapper.PoolState) from numpy arrays of the
    POOL_FIELDS (and the POOL_LABEL_FIELDS, when given and not None) on
    `device` (None: the card)."""
    from pin_slam_tpu_torch.slam.mapper import PoolState

    device = resolve_device(device)
    dtypes = dict(coord=torch.float32, sdf_label=torch.float32,
                  weight=torch.float32, ts=torch.int32,
                  sem_label=torch.int32, color_label=torch.float32)
    fields = POOL_FIELDS + tuple(f for f in POOL_LABEL_FIELDS
                                 if pool_np.get(f) is not None)
    return PoolState(**{
        f: torch.as_tensor(np.array(pool_np[f]), device=device).to(
            dtypes.get(f, torch.int64)).clone() for f in fields})


def lset_from_numpy(lset_np: dict, device=None):
    """A LocalSet from numpy arrays (fields pts, gidx, count and optionally
    cert, ts_upd, quat), e.g. the JAX package's LocalSet._asdict(), on
    `device` (None: the card)."""
    from pin_slam_tpu_torch.ops.knn_join import LocalSet

    device = resolve_device(device)

    def t(name, dtype):
        a = lset_np.get(name)
        return None if a is None else torch.as_tensor(
            np.array(a), device=device).to(dtype)

    return LocalSet(pts=t("pts", torch.float32), gidx=t("gidx", torch.int64),
                    count=t("count", torch.int64),
                    cert=t("cert", torch.float32),
                    ts_upd=t("ts_upd", torch.int32),
                    quat=t("quat", torch.float32))


def gaussian_pe_from_jax(B_np, freq: float = 200.0, device=None):
    """A `models.pos_encoding.GaussianFourierFeatures` with the JAX
    encoder's random matrix `B` [d, bands] (None for zero bands) on
    `device` (None: the card)."""
    from pin_slam_tpu_torch.models.pos_encoding import (
        GaussianFourierFeatures)

    device = resolve_device(device)
    if B_np is None:
        return GaussianFourierFeatures(None, freq=freq, num_bands=0,
                                       device=device)
    B = np.asarray(B_np, np.float32)
    return GaussianFourierFeatures(
        None, freq=freq, num_bands=B.shape[1], dimensionality=B.shape[0],
        B=torch.as_tensor(B, device=device), device=device)


def from_jax(params_np: Optional[dict], state_np: Optional[dict],
             device=None):
    """(params, state) of the port from the JAX package's decoder params
    ({"geo_mlp": {"w": [...], "b": [...]}}, optional "color_mlp",
    "sem_mlp" and "geo_features") and MapState fields (see STATE_FIELDS and
    COLOR_FIELDS), all as numpy arrays. The map's feature arrays become
    params["geo_features"] (and "color_features"), as in PinSLAMSystem.
    Tensors go to `device`; None means the card, as at every entry point,
    and raises without one."""
    device = resolve_device(device)
    state = None if state_np is None else state_from_numpy(state_np, device)
    params = None
    if params_np is not None:
        params = {k: mlp_from_numpy(params_np[k], device) for k in MLP_NAMES
                  if params_np.get(k) is not None}
        if state is not None:
            params["geo_features"] = state.geo_features
            if state.color_features is not None:
                params["color_features"] = state.color_features
        elif "geo_features" in params_np:
            params["geo_features"] = torch.as_tensor(
                np.asarray(params_np["geo_features"], np.float32),
                device=device)
    return params, state
