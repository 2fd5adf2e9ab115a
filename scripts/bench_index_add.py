#!/usr/bin/env python3
"""Cost of the order-free scatter-add on one GPU.

    python3 scripts/bench_index_add.py

Times, with CUDA events, four ways of summing M rows into a 65537-row
array at the shapes of the track+map loop's feature backward (M = 77568 x 6
neighbour rows of 8 features, 30 % of them zero padding sent to the last
row) and its certainty sum (one column):

* `Tensor.index_add_` on float32 (atomics, order-dependent);
* `ops.scatter.index_add_exact` (64-bit fixed point, order-free);
* `Tensor.index_put_(accumulate=True)`, the sort-based form that
  `torch.use_deterministic_algorithms` substitutes for `index_add_`;
* the int64 `index_add_` alone, without the conversions around it.

Then what the order-free sum costs end to end: the 20-frame workload of
chip_smoke.py through four fresh default `PinSLAMSystem`s in one process,
the first and last with the loop's scatter-adds swapped back to the float
`index_add_`, the two in between as shipped; prints each run's steady-state
ms/frame and the vertical pose error at the last frame.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch
    from chip_smoke import cuda_time_ms
    from pin_slam_tpu_torch.ops.scatter import index_add_exact

    if not torch.cuda.is_available():
        print("bench_index_add: no CUDA device", file=sys.stderr)
        return 2
    dev = "cuda"
    torch.manual_seed(0)
    rows = 65537
    for m, f, frac in ((77568 * 6, 8, 0.3), (77568 * 6, 8, 0.0),
                       (6 * 4096 * 8, 8, 0.3), (77568 * 6, 1, 0.3)):
        idx = torch.randint(0, 30000, (m,), device=dev)
        dead = torch.rand(m, device=dev) < frac
        idx = torch.where(dead, torch.full_like(idx, rows - 1), idx)
        src = torch.randn(m, f, device=dev) * 1e-5
        src = torch.where(dead[:, None], torch.zeros_like(src), src)
        if f == 1:
            src = src[:, 0]
        z = torch.zeros((rows, f) if f > 1 else (rows,), device=dev)
        fixed = (src * 1e12).long()
        print(f"M={m} columns={f} padding={frac:.0%}: float index_add_ "
              f"{cuda_time_ms(lambda: z.clone().index_add_(0, idx, src), 20):.3f}"
              " ms, index_add_exact "
              f"{cuda_time_ms(lambda: index_add_exact(z, idx, src), 20):.3f}"
              " ms, index_put_ accumulate "
              f"{cuda_time_ms(lambda: z.clone().index_put_((idx,), src, accumulate=True), 20):.3f}"
              " ms, int64 index_add_ alone "
              f"{cuda_time_ms(lambda: torch.zeros(z.shape, dtype=torch.int64, device=dev).index_add_(0, idx, fixed), 20):.3f}"
              " ms", flush=True)

    from multiprocessing import get_context

    import chip_smoke as cs
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.slam import map_query, mapper
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem

    def float_add(dst, idx, src):
        return dst.index_add(0, idx, src)

    seq = cs.make_sequence(cs.N_FRAMES)
    with get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        frames = pool.map(cs._frame, range(cs.N_FRAMES))
    cs.log = lambda *a: None          # no per-frame lines
    for name, add in (("float", float_add), ("exact", index_add_exact),
                      ("exact", index_add_exact), ("float", float_add)):
        map_query.index_add_exact = mapper.index_add_exact = add
        system = PinSLAMSystem(cs.bench_config(Config), device=dev)
        system.set_gt_poses(seq.poses)
        est, steady_s = cs.run_frames(system, frames, seq.poses, name)
        print(f"loop with {name} scatter-adds: {steady_s * 1e3:.1f} ms/frame "
              f"steady, z at the last frame "
              f"{(est[-1, 2, 3] - seq.poses[len(est) - 1][2, 3]) * 100:+.2f} "
              "cm", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
