"""Neural point map save / load. Port of `pin_slam_tpu/utils/map_io.py`.

`pin_map.npz` holds the compacted map arrays, the decoders and the key
reconstruction hyper-parameters, in the JAX package's layout: the same
array keys (`positions`, `orientations`, `geo_features[:count + 1]`,
`ts_create`, `ts_update`, `certainty`, `color_features[:count + 1]`), the
decoders flattened to `mlp/<name>.w.<i>` / `mlp/<name>.b.<i>` and the same
`meta_json` keys, so a map written by either package loads in the other.
Loading rebuilds the hash table and, with `with_btable`, the brick probe
cache (`neural_points.rehash`), as the JAX package does.
"""

from __future__ import annotations

import json
from typing import Tuple

import numpy as np
import torch

from pin_slam_tpu_torch.config import Config
from pin_slam_tpu_torch.convert import mlp_from_numpy
from pin_slam_tpu_torch.device import resolve_device
from pin_slam_tpu_torch.models import neural_points as npm


def _flatten_params(params: dict, prefix: str = "") -> dict:
    """{"geo_mlp": {"w": [W0, W1], "b": [...]}} -> {"geo_mlp.w.0": W0, ...}
    as numpy arrays (the JAX package's `_flatten_params`)."""
    out = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_params(v, key + "."))
        elif isinstance(v, list):
            for i, vi in enumerate(v):
                out[f"{key}.{i}"] = _numpy(vi)
        else:
            out[key] = _numpy(v)
    return out


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _unflatten_mlps(flat: dict) -> dict:
    """{"geo_mlp.w.0": W0, ...} -> {"geo_mlp": {"w": [W0, ...], "b": ...}}
    as numpy arrays."""
    mlps: dict = {}
    for key, v in flat.items():
        name, kind, i = key.split(".")
        mlps.setdefault(name, {}).setdefault(kind, {})[int(i)] = v
    return {name: {kind: [d[i] for i in range(len(d))]
                   for kind, d in mlp.items()}
            for name, mlp in mlps.items()}


def save_implicit_map(path: str, state: npm.MapState, params: dict,
                      config: Config):
    """Write `pin_map.npz` with the compacted map and the decoders."""
    cnt = int(state.count)
    arrays = {
        "positions": _numpy(state.positions[:cnt]),
        "orientations": _numpy(state.orientations[:cnt]),
        "geo_features": _numpy(state.geo_features[: cnt + 1]),
        "ts_create": _numpy(state.ts_create[:cnt]),
        "ts_update": _numpy(state.ts_update[:cnt]),
        "certainty": _numpy(state.certainty[:cnt]),
    }
    if state.color_features is not None:
        arrays["color_features"] = _numpy(state.color_features[: cnt + 1])
    mlps = {k: v for k, v in params.items() if k.endswith("_mlp")}
    arrays.update(_flatten_params(mlps, "mlp/"))
    meta = {
        "count": cnt,
        "voxel_size_m": config.voxel_size_m,
        "feature_dim": config.feature_dim,
        "buffer_size": config.buffer_size,
        "sigma_sigmoid_m": config.sigma_sigmoid_m,
        "logistic_gaussian_ratio": config.logistic_gaussian_ratio,
        "main_loss_type": config.main_loss_type,
        "color_on": config.color_on,
        "geo_mlp_hidden_dim": config.geo_mlp_hidden_dim,
        "geo_mlp_level": config.geo_mlp_level,
    }
    arrays["meta_json"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_implicit_map(path: str, capacity: int = 0,
                      with_btable: bool = True, device=None
                      ) -> Tuple[npm.MapState, dict, dict]:
    """Load a saved map onto `device` (None: the card). Returns (state with
    the hash table rebuilt, decoders {name: {"w": [...], "b": [...]}}, meta
    dict). The capacity is the larger of `capacity` and the power of two
    above count + 1. `with_btable=False` keeps no brick cache (the join and
    cell probes never read it)."""
    device = resolve_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
        arrays = {k: z[k] for k in z.files if k != "meta_json"}
    cnt = int(meta["count"])
    cap = max(capacity, 1 << int(np.ceil(np.log2(max(cnt + 1, 2)))))
    color_on = bool(meta.get("color_on", False))
    state = npm.init_map_state(cap, int(meta["buffer_size"]),
                               int(meta["feature_dim"]), color_on=color_on,
                               device=device, with_btable=with_btable)

    def put(dst: torch.Tensor, name: str):
        dst[:cnt] = torch.as_tensor(arrays[name][:cnt], device=device)

    put(state.positions, "positions")
    put(state.orientations, "orientations")
    put(state.geo_features, "geo_features")
    put(state.ts_create, "ts_create")
    put(state.ts_update, "ts_update")
    put(state.certainty, "certainty")
    if color_on and "color_features" in arrays:
        put(state.color_features, "color_features")
    state.count = torch.tensor(cnt, dtype=torch.int64, device=device)
    state = npm.rehash(state, 0, resolution=meta["voxel_size_m"],
                       use_mid_ts=False)
    flat = {k[len("mlp/"):]: v for k, v in arrays.items()
            if k.startswith("mlp/")}
    mlps = {name: mlp_from_numpy(mlp, device)
            for name, mlp in _unflatten_mlps(flat).items()}
    return state, mlps, meta
