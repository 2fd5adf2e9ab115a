"""Experiment metrics logging (reference: utils/tools.py:207-222
setup_wandb + the wandb.log calls across utils/mapper.py and pin_slam.py).
The port's own copy of `pin_slam_tpu/utils/logger.py`.

Backends:
  * wandb, when importable AND `wandb_vis_on` — initialized in offline
    mode unless WANDB_MODE overrides (a run needs no network);
  * always: `<run_path>/log/metrics.jsonl`, one JSON object per log call,
    so runs are inspectable without any service.

Device-value caution: every device scalar pulled to the host waits for the
device — callers should log on a cadence, and `log()` converts lazily only
then.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, config, run_path: str):
        self.path = os.path.join(run_path, "log", "metrics.jsonl")
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._f = open(self.path, "a", buffering=1)
        self._t0 = time.time()
        self._wandb = None
        if getattr(config, "wandb_vis_on", False):
            try:
                import wandb
                os.environ.setdefault("WANDB_MODE", "offline")
                self._wandb = wandb
                wandb.init(project="pin-slam-tpu",
                           name=os.path.basename(run_path),
                           dir=run_path,
                           config={k: v for k, v in vars(config).items()
                                   if isinstance(v, (int, float, str, bool))})
            except Exception as e:  # wandb genuinely optional
                print(f"[logger] wandb unavailable ({e}); jsonl only")
                self._wandb = None

    def log(self, metrics: dict, step: Optional[int] = None):
        row = {"t": round(time.time() - self._t0, 3)}
        if step is not None:
            row["step"] = int(step)
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = str(v)
        self._f.write(json.dumps(row) + "\n")
        if self._wandb is not None:
            self._wandb.log(row, step=step)

    def finish(self):
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
