"""The port's bundle adjustment (`slam/ba.py`) against the plain float64
reference `slambench/reference/ba.py`: the first step's loss, its
gradient for the pose deltas and the map features, and Adam's first step
of both groups, on a small map with seeded random features and decoder
(run_ncd_128_s.yaml's settings at a cut-down capacity).

Tolerances, each from what float32 can reach against float64:
- loss, relative 1e-5: a mean of squares over 2048 float32 decodes, each
  good to a few float32 ulps (6e-8), summed in float32;
- gradients, relative (norm of the difference over the reference's
  norm) 1e-4: sums over 2048 samples of float32 products through the
  decoder's backward;
- the step: Adam's first step is lr * g / (|g| + eps), lr * sign(g)
  wherever |g| is far above eps (1e-15), so each element is compared to
  1e-3 of its lr; elements whose reference gradient is under 1e-6 of the
  leaf's largest are left out (float32 may flip their sign), and at most
  a thousandth of the elements may be.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from pin_slam_tpu_torch.config import Config
from pin_slam_tpu_torch.models import neural_points as npm
from pin_slam_tpu_torch.models.decoder import init_mlp_params
from pin_slam_tpu_torch.slam import ba
from pin_slam_tpu_torch.slam import map_query as mq
from pin_slam_tpu_torch.slam import mapper as mp
from slambench.reference import ba as RB
from slambench.reference import decode as RD
from slambench.reference import settings as RS

REPO = Path(__file__).resolve().parents[1]
T_FRAMES, WINDOW, BS = 6, 4, 2048


def _yaml():
    y = yaml.safe_load((REPO / "config" / "lidar_slam" /
                        "run_ncd_128_s.yaml").read_text())
    y = copy.deepcopy(y)
    y["tpu"].update(map_capacity=1 << 13, hash_table_size=1 << 14,
                    max_frames=64, probe_mode="cells")
    y["continual"]["pool_capacity"] = 1 << 14
    return y


def _surface(gen, n):
    """Points on a floor, two walls and a pillar of a 4 x 3 m room."""
    u = torch.rand((n, 3), generator=gen, dtype=torch.float64)
    k = torch.randint(0, 4, (n,), generator=gen)
    p = torch.stack([u[:, 0] * 4, u[:, 1] * 3, u[:, 2] * 2.5], -1)
    p[k == 0, 2] = 0.0
    p[k == 1, 0] = 4.0
    p[k == 2, 1] = 3.0
    ang = u[:, 0] * 2 * np.pi
    pil = torch.stack([2.0 + 0.3 * torch.cos(ang), 1.5 + 0.3 * torch.sin(ang),
                       u[:, 2] * 2.5], -1)
    p[k == 3] = pil[k == 3]
    return p


@pytest.fixture(scope="module")
def case():
    torch.set_num_threads(1)
    y = _yaml()
    cfg = Config().load_dict(copy.deepcopy(y))
    cfg.finalize()
    st = RS.read(y)
    qp = mq.make_query_params(cfg)
    gen = torch.Generator().manual_seed(17)
    state = npm.init_map_state(cfg.map_capacity, st.table_size,
                               cfg.feature_dim, with_btable=False)
    travel = torch.zeros(cfg.max_frames)
    travel[:T_FRAMES] = torch.arange(T_FRAMES, dtype=torch.float32) * 0.3
    window_m = 10.0
    for f in range(T_FRAMES):
        pts = _surface(gen, 3000).float()
        state, _ = npm.insert_points(
            state, pts, torch.ones(pts.shape[0], dtype=torch.bool), f,
            travel, resolution=cfg.voxel_size_m, local_window_dist=window_m,
            maintain_btable=False)
    n = int(state.count)
    feats = state.geo_features.clone()
    feats[:n] = torch.randn((n, cfg.feature_dim), generator=gen) * 0.3
    state = state.replace(geo_features=feats)
    mlp = init_mlp_params(gen, cfg.feature_dim + 3, cfg.geo_mlp_hidden_dim,
                          cfg.geo_mlp_level, 1)
    # surface samples a little off the map's points, from every frame
    N = 6000
    world = (_surface(gen, N) + 0.02 * torch.randn((N, 3), generator=gen,
                                                   dtype=torch.float64)
             ).float()
    ts = torch.randint(0, T_FRAMES, (N,), generator=gen)
    pool = mp.init_pool(cfg.pool_capacity, 16)
    pool.coord[:N] = world
    pool.sdf_label[:N] = 0.0
    pool.weight[:N] = 1.0
    pool.ts[:N] = ts.to(pool.ts.dtype)
    pool.count = torch.tensor(N)
    # base poses: a short walk with small turns
    base = np.stack([np.eye(4) for _ in range(T_FRAMES)])
    for i in range(T_FRAMES):
        a = 0.05 * i
        base[i, :3, :3] = [[np.cos(a), -np.sin(a), 0],
                           [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        base[i, :3, 3] = [0.5 + 0.14 * i, 1.0, 1.5]
    base = torch.tensor(base, dtype=torch.float32)
    lf = mq.LocalFilter(travel_dist=travel, cur_ts=T_FRAMES - 1,
                        local_window_dist=window_m, reboot_ts=0)
    filt = RD.Filter(travel=travel, cur_ts=T_FRAMES - 1, window=window_m,
                     reboot_ts=0, ts=state.ts_create[:n])
    pts = state.positions[:n]
    amb = RB.ambiguous(world, pts, state.ts_create[:n], st, filt)
    ok = torch.nonzero(~amb).squeeze(1)
    draws = ok[torch.randint(0, ok.numel(), (1, BS), generator=gen)]
    return dict(cfg=cfg, st=st, qp=qp, state=state, mlp=mlp, pool=pool,
                base=base, lf=lf, filt=filt, draws=draws, n=n, amb=amb)


def _program_step(c, mutate=None):
    """One BA iteration of the port; returns (loss, {leaf: gradient},
    deltas after the step, the features' change)."""
    from torch.optim.optimizer import register_optimizer_step_post_hook
    cfg = c["cfg"]
    got = {}

    def hook(opt, args, kwargs):
        b1 = opt.param_groups[0]["betas"][0]
        for group in opt.param_groups:
            p = group["params"][0]
            name = "deltas" if tuple(p.shape) == (WINDOW, 6) else "feats"
            got[name] = (opt.state[p]["exp_avg"].double() / (1 - b1),
                         p.detach().clone())

    h = register_optimizer_step_post_hook(hook)
    try:
        with mutate() if mutate else _null():
            loop = ba.make_ba_loop(c["qp"], n_iters=1, bs=BS, window=WINDOW,
                                   lr_pose=cfg.lr_pose, lr_map=cfg.lr_ba_map,
                                   adam_eps=cfg.adam_eps)
            feats0 = c["state"].geo_features
            _, feats, losses = loop(
                c["state"], c["pool"], feats0, c["mlp"], c["base"],
                T_FRAMES - WINDOW, None, c["lf"], draws=c["draws"])
    finally:
        h.remove()
    n = c["n"]
    return (float(losses[0]), {k: v[0] for k, v in got.items()},
            got["deltas"][1], (feats - feats0)[:n].double())


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _reference(c):
    cfg, st, pool, n = c["cfg"], c["st"], c["pool"], c["n"]
    rows = c["draws"][0]
    return RB.ba_step(pool.coord[rows], pool.ts[rows], c["base"],
                      T_FRAMES - WINDOW, c["state"].positions[:n],
                      c["state"].ts_create[:n], c["state"].geo_features[:n],
                      (c["mlp"]["w"], c["mlp"]["b"]), st, lr_pose=cfg.lr_pose,
                      lr_map=cfg.lr_ba_map, eps=cfg.adam_eps, filt=c["filt"])


def test_the_case_samples_every_window_frame_and_is_unambiguous(case):
    ts = case["pool"].ts[case["draws"][0]]
    assert set(ts.tolist()) == set(range(T_FRAMES))
    assert not bool(case["amb"][case["draws"][0]].any())
    assert case["n"] > 1000


def test_first_step_matches_the_float64_reference(case):
    loss, grads, deltas, dfeat = _program_step(case)
    ref = _reference(case)
    cfg = case["cfg"]
    assert abs(loss - ref.loss) / ref.loss < 1e-5
    assert RB.rel_gap(grads["deltas"], ref.grad_deltas) < 1e-4
    assert RB.rel_gap(grads["feats"][:case["n"]], ref.grad_feats) < 1e-4
    gap_d, out_d = RB.step_gap(deltas.double(), ref.step_deltas,
                             ref.grad_deltas, cfg.lr_pose)
    gap_f, out_f = RB.step_gap(dfeat, ref.step_feats, ref.grad_feats,
                             cfg.lr_ba_map)
    assert gap_d < 1e-3 and out_d <= 1e-3
    assert gap_f < 1e-3 and out_f <= 1e-3
    # the frames before the window keep their base pose: no delta
    assert deltas.shape == (WINDOW, 6)


def test_pose_deltas_left_unchanged_are_caught(case, monkeypatch):
    """A BA whose optimizer leaves the pose deltas out (the features alone
    step) reads far outside the step's tolerance."""
    real = torch.optim.Adam

    def adam_without_poses(groups, **kw):
        return real([groups[1]] + [dict(groups[0], lr=0.0)], **kw)

    def mutate():
        monkeypatch.setattr(torch.optim, "Adam", adam_without_poses)
        return _null()

    loss, grads, deltas, dfeat = _program_step(case, mutate)
    ref = _reference(case)
    gap_d, _ = RB.step_gap(deltas.double(), ref.step_deltas, ref.grad_deltas,
                         case["cfg"].lr_pose)
    assert gap_d > 0.5


# ------------------------------------------- the BA run's spans, counters

BA_ITERS, BA_BS = 3, 512


def _system(c):
    """A CPU system holding the case's map, pool, decoder and poses."""
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem
    cfg = copy.deepcopy(c["cfg"])
    cfg.ba_iters, cfg.ba_bs = BA_ITERS, BA_BS
    s = PinSLAMSystem(cfg, device="cpu")
    s.state = c["state"].replace(
        geo_features=c["state"].geo_features.clone())
    s.sync_feature_params()
    s.params["geo_mlp"] = c["mlp"]
    s.pool = c["pool"].replace(coord=c["pool"].coord.clone())
    chain = s.pgo_poses if cfg.pgo_on else s.odom_poses
    chain[:T_FRAMES] = c["base"].double().numpy()
    s.travel_dist[:T_FRAMES] = c["lf"].travel_dist[:T_FRAMES].numpy()
    return s


def _ba_draws(c):
    gen = torch.Generator().manual_seed(5)
    ok = torch.nonzero(~c["amb"]).squeeze(1)
    return ok[torch.randint(0, ok.numel(), (BA_ITERS, BA_BS), generator=gen)]


def test_ba_spans_nest_under_the_run_and_the_counters_match(case):
    from pin_slam_tpu_torch.utils import tracing
    s = _system(case)
    tracing.drain()
    tracing.enable()
    try:
        ba.run_bundle_adjustment(s, T_FRAMES - 1, draws=_ba_draws(case))
    finally:
        tracing.disable()
    rec = tracing.drain()
    by_id = {r.id: r for r in rec}
    runs = [r for r in rec if r.name == "ba.run"]
    assert len(runs) == 1
    run = runs[0]
    kids = [r.name for r in rec if r.parent == run.id]
    assert kids == ["ba.collect"] + ["ba.iter"] * BA_ITERS + ["ba.writeback"]
    for it in (r for r in rec if r.name == "ba.iter"):
        assert [r.name for r in rec if r.parent == it.id] == [
            "ba.loss", "ba.backward", "ba.step"]
    for r in rec:
        if r.name != "ba.run":
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    assert s.last_ba_iters == BA_ITERS == s.last_ba_losses.shape[0]
    surf = int((torch.abs(case["pool"].sdf_label[:int(case["pool"].count)])
                < 1e-9).sum())
    assert s.last_ba_samples == surf == 6000


def test_ba_losses_repeat_bit_for_bit_with_the_tracer_off_and_on(case):
    from pin_slam_tpu_torch.utils import tracing
    draws = _ba_draws(case)
    runs = []
    for on in (False, False, True):
        s = _system(case)
        if on:
            tracing.enable()
        try:
            ba.run_bundle_adjustment(s, T_FRAMES - 1, draws=draws)
        finally:
            tracing.disable()
            tracing.drain()
        runs.append((s.last_ba_losses.clone(), s.state.geo_features.clone(),
                     s.pgo_poses[:T_FRAMES].copy()))
    for losses, feats, poses in runs[1:]:
        assert torch.equal(losses, runs[0][0])
        assert torch.equal(feats, runs[0][1])
        assert np.array_equal(poses, runs[0][2])
    assert bool((runs[0][0][1:] != runs[0][0][0]).any())
