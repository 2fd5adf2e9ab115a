"""What a PIN-SLAM configuration states about the map query, the decoder
and the mapping loss, read from its YAML dict with PIN-SLAM's defaults
(PRBonn/PIN_SLAM `utils/config.py`) for the keys a YAML leaves out. The
reference computes from these and from nothing of the program; the harness
holds the program's own reading of the configuration to them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Settings:
    voxel_m: float
    nn_k: int
    num_nei_cells: int
    search_alpha: float
    feature_dim: int
    weighted_first: bool
    idw_index: int
    sdf_scale: float            # the decoder's output scale
    bce_sigma: float            # the BCE's sharpness (the scaled sigma)
    loss_weight_on: bool
    eikonal_on: bool
    weight_e: float
    grad_eps: float
    grad_decimation: int
    mlp_hidden: int
    mlp_level: int
    table_size: int             # the voxel hash table's slots
    bs: int                     # a training batch's rows
    lr: float                   # Adam's learning rate
    adam_eps: float
    freeze_after_frame: int     # the decoder trains before this frame only

    @property
    def offsets(self) -> np.ndarray:
        """The cell probe's neighbourhood: {o : |o| < cells + alpha}."""
        n = self.num_nei_cells
        r = np.arange(-n, n + 1)
        o = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
        return o[(o.astype(np.float64) ** 2).sum(-1)
                 < (n + self.search_alpha) ** 2]

    @property
    def cell_dist2(self) -> float:
        """The cell probe's distance bound."""
        return 3.0 * ((self.num_nei_cells + 1) * self.voxel_m) ** 2


def read(yaml: dict) -> Settings:
    npt = yaml.get("neuralpoints", {}) or {}
    lo = yaml.get("loss", {}) or {}
    dec = yaml.get("decoder", {}) or {}
    opt = yaml.get("optimizer", {}) or {}
    voxel = float(npt.get("voxel_size_m", 0.3))
    sigma = float(lo.get("sigma_sigmoid_m", 0.1))
    main = lo.get("main_loss_type", "bce")
    if main != "bce":
        raise ValueError(f"the reference computes the bce loss, not {main}")
    scale = 0.55 * sigma
    numerical = lo.get("numerical_grad_on", True)
    return Settings(
        voxel_m=voxel,
        nn_k=int(npt.get("query_nn_k", 6)),
        num_nei_cells=int(npt.get("num_nei_cells", 2)),
        search_alpha=float(npt.get("search_alpha", 0.2)),
        feature_dim=int(npt.get("feature_dim", 8)),
        weighted_first=bool(npt.get("weighted_first", True)),
        idw_index=2,
        sdf_scale=scale,
        bce_sigma=scale,
        loss_weight_on=bool(lo.get("loss_weight_on", False)),
        eikonal_on=bool(lo.get("ekional_loss_on", True)),
        weight_e=float(lo.get("weight_e", 0.5)),
        grad_eps=voxel * float(lo.get("num_grad_step_ratio", 0.2)),
        grad_decimation=int(lo.get("grad_decimation", 10)) if numerical
        else 1,
        mlp_hidden=int(dec.get("mlp_hidden_dim", 64)),
        mlp_level=int(dec.get("mlp_level", 1)),
        table_size=int((yaml.get("tpu", {}) or {}).get("hash_table_size",
                                                        1 << 24)),
        bs=int(opt.get("batch_size", 16384)),
        lr=float(opt.get("learning_rate", 0.01)),
        adam_eps=float(opt.get("adam_eps", 1e-15)),
        freeze_after_frame=int(dec.get("freeze_after_frame", 40)),
    )
