"""Replica devices of the data-parallel training loop and mesher. The
port's counterpart of `pin_slam_tpu/parallel/dp.py`.

The JAX package builds a `jax.sharding.Mesh` and runs its training loop and
mesher under `shard_map` / sharded `jit`: one program, one replica per
device. The port keeps that single-controller design: one process drives
every replica, `slam/mapper.make_train_loop(mesh=)` runs each replica's
batch on its device and averages the gradients on the first, and
`slam/mesher.Mesher(mesh=)` splits each grid batch over the replicas. A
"mesh" here is the list of replica devices; a device may appear more than
once (several replicas on one card, or on the CPU in tests).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> List[torch.device]:
    """The replica devices: `devices` as given, else the first `n_devices`
    visible CUDA cards (all of them for None or 0)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                           "devices= to place replicas elsewhere")
    return [torch.device("cuda", i) for i in range(min(n_devices or n, n))]


def replicate(obj, device):
    """`obj` with every tensor it holds (in dataclasses, named tuples,
    dicts, lists) on `device`. Tensors already there are not copied, so a
    replica on the first device shares its storage."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: replicate(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[replicate(v, device) for v in obj])
    if isinstance(obj, dict):
        return {k: replicate(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(replicate(v, device) for v in obj)
    return obj


def replica_generators(generator: torch.Generator,
                       devices: Sequence[torch.device]):
    """One generator per replica, seeded from one draw of the frame's
    `generator` and the replica index (the counterpart of the JAX loop's
    `fold_in(key, axis_index)`): the replicas draw different batches, and
    all of them follow the frame's generator. Costs one host sync."""
    seed = int(torch.randint(0, 1 << 62, (1,), generator=generator,
                             device=generator.device).item())
    return [torch.Generator(device=d).manual_seed(
        (seed + 0x9E3779B97F4A7C15 * r) % (1 << 63))
        for r, d in enumerate(devices)]
