#!/usr/bin/env python3
"""The program's bundle adjustment against the plain float64 reference
(`reference/ba.py`) at a cell's own size: one run of a frames cell as
`run.py` makes it, in which the `--ba`-th BA run (0: the first) keeps its
inputs and its first step, then one JSON line:

    python3 slambench/ba_check.py --workload ncd_cells.walk --seed <n> \\
        --seconds 50 [--ba 0]

It gives the BA run's frame, window and samples, and against the
reference: the first iteration's loss over the samples whose neighbours
rounding cannot change (`loss_rel`), each sample's SDF there
(`sdf_gap_m`), the gradient of the pose deltas and of the features
(`grad_rel_*`: the norm of the difference over the reference's norm) and
Adam's first step (`step_gap_*`: the widest gap over the group's
learning rate, where the reference's gradient is clear of rounding).
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(CHECKOUT))


class Keeper:
    """Wraps `ba.make_ba_loop` so that the `index`-th BA run keeps its
    inputs, its first loss's SDFs and its first Adam step."""

    def __init__(self, index: int):
        self.index = index
        self.seen = 0
        self.cap = None

    def install(self, patcher):
        from torch.optim.optimizer import register_optimizer_step_post_hook

        from pin_slam_tpu_torch.slam import ba
        from pin_slam_tpu_torch.slam import map_query as mq
        from slambench.harness import filter_of
        keeper = self
        make = ba.make_ba_loop

        def make_and_keep(qp, *, n_iters, bs, window, lr_pose, lr_map,
                          adam_eps=1e-15):
            run = make(qp, n_iters=n_iters, bs=bs, window=window,
                       lr_pose=lr_pose, lr_map=lr_map, adam_eps=adam_eps)

            def run_kept(state, pool, geo_features, geo_mlp, base_poses,
                         first_opt, generator, lf, draws=None, info=None):
                keep = keeper.seen == keeper.index
                keeper.seen += 1
                if not keep:
                    return run(state, pool, geo_features, geo_mlp,
                               base_poses, first_opt, generator, lf,
                               draws=draws, info=info)
                sidx, scount = ba.collect_surface_samples(
                    pool, ba.SURFACE_SAMPLE_CAP)
                if draws is None:
                    draws = ba.draw_ba_indices(generator, scount,
                                               n_iters=n_iters, bs=bs)
                rows = sidx[draws[0]]
                n = int(state.count)
                cap = dict(world=pool.coord[rows].clone(),
                           ts=pool.ts[rows].clone(),
                           base=base_poses.clone(), first_opt=first_opt,
                           pts=state.positions[:n].clone(),
                           map_ts=state.ts_create[:n].clone(),
                           quats=state.orientations[:n].clone(),
                           feats=geo_features[:n].detach().clone(),
                           mlp=([w.detach().clone() for w in geo_mlp["w"]],
                                [b.detach().clone() for b in geo_mlp["b"]]),
                           filter=filter_of(lf, None), lr=(lr_pose, lr_map),
                           eps=adam_eps, window=window, samples=int(scount),
                           sdf=None, step=None)
                o_query = mq.query_decode

                def query(*a, **k):
                    out = o_query(*a, **k)
                    if cap["sdf"] is None:
                        cap["sdf"] = out.sdf.detach().clone()
                    return out

                def hook(opt, args, kwargs):
                    if cap["step"] is not None:
                        return
                    b1 = opt.param_groups[0]["betas"][0]
                    got = {}
                    for group in opt.param_groups:
                        p = group["params"][0]
                        name = "deltas" if p.shape[-1] == 6 else "feats"
                        got[name] = (opt.state[p]["exp_avg"].double()
                                     / (1 - b1), p.detach().clone())
                    cap["step"] = got

                h = register_optimizer_step_post_hook(hook)
                mq.query_decode = query
                try:
                    out = run(state, pool, geo_features, geo_mlp,
                              base_poses, first_opt, generator, lf,
                              draws=draws, info=info)
                finally:
                    h.remove()
                    mq.query_decode = o_query
                cap["loss"] = float(out[2][0])
                keeper.cap = cap
                return out

            return run_kept

        patcher.setattr(ba, "make_ba_loop", make_and_keep)


def compare(cap: dict, st) -> dict:
    """The kept BA run against the reference, in float64 on its device."""
    from slambench.reference import ba as RB
    from slambench.reference import decode as RD
    n = cap["pts"].shape[0]
    f = cap["filter"]
    filt = None if f is None else RD.Filter(
        travel=f["travel"], cur_ts=int(f["cur_ts"]), window=float(f["window"]),
        reboot_ts=int(f["reboot_ts"]), ts=cap["map_ts"])
    quats = cap["quats"]
    if not bool((quats[:, 1:4] != 0).any()):
        quats = None
    lr_pose, lr_map = cap["lr"]
    t0 = time.perf_counter()
    ref = RB.ba_step(cap["world"], cap["ts"], cap["base"], cap["first_opt"],
                     cap["pts"], cap["map_ts"], cap["feats"], cap["mlp"], st,
                     lr_pose=lr_pose, lr_map=lr_map, eps=cap["eps"],
                     quats=quats, filt=filt)
    amb = RB.ambiguous(cap["world"], cap["pts"], cap["map_ts"], st, filt)
    keep = ~amb
    sdf_p = cap["sdf"].double()
    loss_p = float((sdf_p[keep] ** 2).mean())
    loss_r = float((ref.sdf[keep] ** 2).mean())
    g_d, d_after = cap["step"]["deltas"]
    g_f, f_after = cap["step"]["feats"]
    g_f = g_f[:n]
    step_f = f_after[:n].double() - cap["feats"].double()
    gd, out_d = RB.step_gap(d_after, ref.step_deltas, ref.grad_deltas,
                            lr_pose)
    gf, out_f = RB.step_gap(step_f, ref.step_feats, ref.grad_feats, lr_map)
    return {
        "window": cap["window"], "first_opt": cap["first_opt"],
        "samples": cap["samples"], "batch": int(keep.numel()),
        "ambiguous": int(amb.sum()),
        "frames_sampled": sorted(set(cap["ts"].long().tolist())),
        "loss_program": cap["loss"], "loss_rel": abs(loss_p - loss_r)
        / max(abs(loss_r), 1e-300),
        "sdf_gap_m": float((sdf_p - ref.sdf)[keep].abs().max()),
        "grad_rel_deltas": RB.rel_gap(g_d, ref.grad_deltas),
        "grad_rel_feats": RB.rel_gap(g_f, ref.grad_feats),
        "step_gap_deltas": gd, "step_gap_feats": gf,
        "step_left_out": max(out_d, out_f),
        "reference_s": time.perf_counter() - t0,
        "device": str(cap["world"].device),
        "float64_on": str(ref.grad_feats.device)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--ba", type=int, default=0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    from slambench import faults as F
    from slambench import harness as H
    bench = H.load_bench()
    cell = H.cell_of(bench, a.workload)
    keeper = Keeper(a.ba)
    patcher = F.Patcher()
    keeper.install(patcher)
    try:
        r = H.run_cell(bench, cell, a.seed, a.seconds, False, a.device,
                       time.perf_counter(),
                       log=lambda *m: print(*m, file=sys.stderr))
    finally:
        patcher.undo()
    line = {"workload": a.workload, "seed": a.seed, "correct": r["correct"],
            "ba_runs": keeper.seen}
    if keeper.cap is not None:
        from slambench.reference import settings as RS
        spec = H.load_json("configs", cell["config"])
        line.update(compare(keeper.cap, RS.read(spec["yaml"])))
    print(json.dumps(line), flush=True)
    return 0 if keeper.cap is not None else 1


if __name__ == "__main__":
    sys.exit(main())
