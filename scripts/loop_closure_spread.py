#!/usr/bin/env python3
"""Spread of the loop closure over random draws, in either package, on the
CPU: the scenario of tests/test_torch_loop.py (a drifted revisit in mapping
mode), run up to its closure frame.

    python3 scripts/loop_closure_spread.py jax   KEY [KEY ...]
    python3 scripts/loop_closure_spread.py torch SEED [SEED ...]

Every run starts from the JAX package's initial decoder of key 42; the JAX
runs differ in their PRNG key, the port's in its generator seed. Prints,
per run, the closure (frame, loop frame), how far the refinement moved the
pose, and the PGO pose's position error at the closure frame against ground
truth. About 40 s a JAX run and 15 s a port run.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import torch

    import tests.test_torch_loop as T
    from pin_slam_tpu.config import Config as JConfig
    from pin_slam_tpu.slam.loop import LoopPgoManager as JLoop
    from pin_slam_tpu.slam.system import PinSLAMSystem as JSystem
    from pin_slam_tpu_torch import convert
    from pin_slam_tpu_torch.config import Config as TConfig
    from pin_slam_tpu_torch.slam.loop import LoopPgoManager as TLoop
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem as TSystem

    pkg, seeds = sys.argv[1], [int(a) for a in sys.argv[2:]]
    gt, drifted, frames = T.scenario.__wrapped__()
    init = jax.tree.map(np.asarray,
                        JSystem(T.loop_config(JConfig)).params["geo_mlp"])
    for seed in seeds:
        if pkg == "jax":
            cfg = T.loop_config(JConfig)
            system = JSystem(cfg, key=jax.random.PRNGKey(seed))
            system.params["geo_mlp"] = jax.tree.map(jax.numpy.asarray, init)
            mgr = JLoop(cfg, system)
        else:
            cfg = T.loop_config(TConfig)
            system = TSystem(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(seed))
            system.params["geo_mlp"] = convert.mlp_from_numpy(init, "cpu")
            mgr = TLoop(cfg, system)
        system.set_gt_poses(drifted)
        for fid in range(T.N):
            system.process_frame(fid, frames[fid],
                                 loop_hook=lambda f, _p=frames[fid]:
                                 mgr.after_frame(f, _p))
            if mgr.pgo_count:
                break
        if not mgr.pgo_count:
            print(f"{pkg} {seed}: no closure", flush=True)
            continue
        d = mgr.pgm.loop_diags[0]
        f = d["frame"]
        err = np.linalg.norm(system.pgo_poses[f][:3, 3] - gt[f][:3, 3])
        print(f"{pkg} {seed}: closure {f} -> {d['loop']}, refinement moved "
              f"{d['refine_moved_m']:.4f} m, PGO position error at the "
              f"closure frame {err:.4f} m", flush=True)


if __name__ == "__main__":
    main()
