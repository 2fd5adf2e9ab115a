#!/usr/bin/env python3
"""The port's `_close_loop` on the JAX package's pre-closure state (the
scenario of tests/test_torch_loop.py) at several torch thread counts, on the
CPU: how far the refined loop edge, the PGO poses, the deformed map and the
replay pool land from the JAX package's.

    python3 scripts/loop_close_threads.py [--fixed] [THREADS ...]
    # threads default to 1 2 4 8

The registration stops at the tracker's termination threshold (1 mm, 0.01
deg), so the float summation order (which torch's CPU reductions take from
the thread count) can decide whether it takes one more step. `--fixed`
sets the threshold to 0 in both packages, so that both registrations take
all reg_iter_n GN steps. About 1 min.
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

    args = sys.argv[1:]
    if "--fixed" in args:
        args.remove("--fixed")
        stock = T.loop_config

        def loop_config(cls):
            cfg = stock(cls)
            cfg.reg_term_thre_m = cfg.reg_term_thre_deg = 0.0
            return cfg

        T.loop_config = loop_config
    threads = [int(a) for a in args] or [1, 2, 4, 8]
    sc = T.scenario.__wrapped__()
    rec = T.jax_run.__wrapped__(sc)
    after = rec["after"]
    n = rec["args"][0] + 1
    cnt, P = int(after["state"]["count"]), int(after["pool"]["count"])
    frame_id, loop_id, T_loop = rec["args"]
    for th in threads:
        torch.set_num_threads(th)
        ts, tm = T._port_from_snapshot(rec["before"])
        ok = tm._close_loop(frame_id, loop_id, T_loop.copy(), sc[2][frame_id])
        je, te = after["pgm"]["loop_trans"][-1], tm.pgm.loop_trans[-1]
        jp, tp = after["pgm"]["pgo_poses"][:n], tm.pgm.pgo_poses[:n]
        pos = np.abs(ts.state.positions[:cnt].numpy()
                     - after["state"]["positions"][:cnt]).max()
        pool = np.abs(ts.pool.coord[:P].numpy()
                      - after["pool"]["coord"][:P]).max()
        print(f"{th} threads: closed {ok}; edge {np.linalg.norm(je[:3, 3] - te[:3, 3]):.3g} m, "
              f"{T._angle_deg(je[:3, :3], te[:3, :3]):.3g} deg; PGO poses "
              f"{np.abs(jp[:, :3, 3] - tp[:, :3, 3]).max():.3g} m; map "
              f"{pos:.3g} m; pool {pool:.3g} m", flush=True)


if __name__ == "__main__":
    main()
