"""The benchmark's harness: one run of one cell of BENCHMARK.json.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name: `configs/<name>.json`,
`traffic/<name>.json` and `metrics/<name>.py` under the benchmark's root.
A traffic file's `kind` names the driver that runs it: "frames" (scans
through the dataset layer's per-frame functions and
`PinSLAMSystem.process_frame`, as `pin_slam_tpu_torch/run.py` drives them)
is the one driver so far.

The harness taps the program from outside: it wraps a few of its
functions to keep what the timed path computed (references, and for the
few sampled frames device copies of the map rows and features that their
tracker and training read, and the norms of the first training step's
gradient and change, taken without a device sync), and in a traced run
puts `record_function` ranges round the dataset layer, the tracker, the
mapper and the loop hook and traces a steady stretch with
`torch.profiler`.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pin_slam_tpu")
SAMPLED_FRAMES = 3          # frames whose tracker and training are judged
TRACE_FRAMES = 20           # frames the profiler traces in a frames cell
TRACE_SKIP = 5              # window frames before the traced stretch


# ------------------------------------------------------------------ lookup

def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    """`<root>/<kind>/<name>.json` (kind: configs, traffic)."""
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file named {name!r} ({path})")
    return json.loads(path.read_text())


def load_metric(name: str, root: Path = ROOT):
    """The reader module `<root>/metrics/<name>.py`."""
    path = root / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no metric reader named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"slambench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_of(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")


def metrics_of(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace 0) or per-layer ones (1)."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package (names compared whole: the port's own name only begins with
    the JAX package's)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


def limits(root: Path = ROOT) -> Dict[str, float]:
    return json.loads((root / "reference" / "limits.json").read_text())[
        "limits"]


def set_from(root: Path = ROOT) -> Dict[str, str]:
    """What set each limit's upper reading: "control", or "fault:<name>"
    (`faults.py`), or "exact"."""
    return json.loads((root / "reference" / "limits.json").read_text())[
        "set_from"]


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root.parent / "BENCHMARK.json").read_text())


# -------------------------------------------------------------- the taps

def snapshot(state) -> dict:
    """Copies of the map rows a whole-map query reads, taken on the device
    without a sync (the map is updated in place after the query)."""
    return {"pts": state.positions.detach().clone(),
            "ts": state.ts_create.detach().clone(),
            "quat": state.orientations.detach().clone(),
            "count": state.count.detach().clone()}


def filter_of(lf, anchor) -> Optional[dict]:
    """The travel-window filter a whole-map query ran under, in world
    coordinates."""
    if lf is None:
        return None
    sensor = lf.sensor_pos
    if sensor is not None and anchor is not None:
        sensor = sensor + anchor
    return {"travel": lf.travel_dist.detach().clone(), "cur_ts": lf.cur_ts,
            "window": lf.local_window_dist, "reboot_ts": lf.reboot_ts,
            "sensor": None if sensor is None else sensor.detach(),
            "radius": lf.local_map_radius}


class Taps:
    """Wraps program functions for the run: keeps what the sampled frames'
    tracker and training computed and per-frame counts, and (traced runs)
    puts ranges round the layers."""

    def __init__(self, sample: set, trace: bool):
        self.sample = sample
        self.trace = trace
        self.frame = -1
        self.track: Dict[int, dict] = {}
        self.train: Dict[int, dict] = {}
        self.src_n: Dict[int, object] = {}
        self.train_iters: Dict[int, int] = {}
        self._undo = []
        self._hooks = []
        self._loss_sdf = None   # SDFs of the first loss of a sampled frame
        self._open = set()

    def _patch(self, owner, name, fn):
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, fn)

    def restore(self):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo = []
        for h in self._hooks:
            h.remove()
        self._hooks = []

    def _range(self, name):
        if not self.trace:
            return nullcontext()
        import torch
        return torch.profiler.record_function(name)

    @contextmanager
    def layer(self, name):
        """A traced range that is not opened again inside itself (the
        tracker's chain calls its cached chain)."""
        if name in self._open:
            yield
            return
        self._open.add(name)
        try:
            with self._range(name):
                yield
        finally:
            self._open.discard(name)

    def install_frames(self):
        import torch
        from torch.optim.optimizer import register_optimizer_step_post_hook

        from pin_slam_tpu_torch.slam import map_query as mq
        from pin_slam_tpu_torch.slam import mapper as mp
        from pin_slam_tpu_torch.slam import system as sysm
        taps = self
        S = sysm.PinSLAMSystem
        o_cached, o_train = S.track_chain_cached, S.train
        o_query, o_loss = mq.query_decode, mp.mapping_loss

        def track_chain_cached(self_, feats, src_pts, src_n, *a, **k):
            taps.src_n[taps.frame] = src_n
            with taps.layer("slambench.tracker"):
                return o_cached(self_, feats, src_pts, src_n, *a, **k)

        def train(self_, iters, frame_id, *a, **k):
            taps.train_iters[taps.frame] = int(iters)
            with taps.layer("slambench.mapper"):
                return o_train(self_, iters, frame_id, *a, **k)

        def query_decode(geo_features, geo_mlp, qpts, qp, **kw):
            out = o_query(geo_features, geo_mlp, qpts, qp, **kw)
            if taps._loss_sdf is not None:
                taps._loss_sdf.append(out.sdf.detach().clone())
            f = taps.frame
            if ("slambench.tracker" in taps._open and f in taps.sample
                    and f not in taps.track and kw.get("state") is not None):
                anchor = kw.get("anchor")
                q = qpts.detach()
                q64 = q.double()
                if anchor is not None:
                    q64 = q64 + anchor.double()
                    q = q + anchor
                taps.track[f] = dict(
                    snapshot(kw["state"]), q=q, q64=q64, sdf=out.sdf.detach(),
                    n=taps.src_n[f], feats=geo_features.detach().clone(),
                    mlp=geo_mlp, filter=filter_of(kw.get("lf"), anchor))
            return out

        def mapping_loss(geo_features, geo_mlp, batch, mask, cand, cvalid,
                         lset, qp, **kw):
            f = taps.frame
            first = (f in taps.sample and f not in taps.train
                     and kw.get("state") is not None)
            if first:
                taps._loss_sdf = []
            try:
                total, aux = o_loss(geo_features, geo_mlp, batch, mask, cand,
                                    cvalid, lset, qp, **kw)
            finally:
                loss_sdf, taps._loss_sdf = taps._loss_sdf, None
            if first:
                leaves = {geo_features.data_ptr(): "feats"}
                for key in ("w", "b"):
                    for i, t in enumerate(geo_mlp[key]):
                        leaves[t.data_ptr()] = f"{key}{i}"
                taps.train[f] = dict(
                    snapshot(kw["state"]), frame=f,
                    feats=geo_features.detach().clone(),
                    mlp={key: [t.detach().clone() for t in geo_mlp[key]]
                         for key in ("w", "b")},
                    coord=batch["coord"].detach(),
                    label=batch["sdf_label"].detach(),
                    weight=batch["weight"].detach(), mask=mask.detach(),
                    filter=filter_of(kw.get("lf"), None),
                    loss=total.detach(), loss_sdf=loss_sdf, leaves=leaves,
                    update=None)
            return total, aux

        def after_step(opt, args, kwargs):
            """The first optimizer step of a sampled frame's training:
            per leaf, the norm of the gradient Adam got (its first moment
            over 1 - beta1) and of the change it made (device scalars)."""
            cap = taps.train.get(taps.frame)
            if cap is None or cap["update"] is not None:
                return
            before = {"feats": cap["feats"]}
            for key in ("w", "b"):
                for i, t in enumerate(cap["mlp"][key]):
                    before[f"{key}{i}"] = t
            beta1 = opt.param_groups[0]["betas"][0]
            upd = {}
            for group in opt.param_groups:
                for p in group["params"]:
                    name = cap["leaves"].get(p.data_ptr(),
                                             f"other{len(upd)}")
                    m = opt.state.get(p, {}).get("exp_avg")
                    g = (torch.zeros((), dtype=torch.float64,
                                     device=p.device) if m is None else
                         torch.linalg.vector_norm(m.double()) / (1 - beta1))
                    d = p.detach().double()
                    if name in before:
                        d = d - before[name].double()
                    upd[name] = (g, torch.linalg.vector_norm(d))
            cap["update"] = upd

        self._patch(S, "track_chain_cached", track_chain_cached)
        self._patch(S, "train", train)
        self._patch(mq, "query_decode", query_decode)
        self._patch(mp, "mapping_loss", mapping_loss)
        self._hooks.append(register_optimizer_step_post_hook(after_step))


# ------------------------------------------------------------- the trace

def summarize_trace(prof, n_steps: int) -> dict:
    """Device busy time, window, device operations by name, the layers'
    device time and the longest idle gaps with the benchmark range the host
    was in. The benchmark's `record_function` ranges also appear on the
    device's timeline (as user annotations): they mark each layer's device
    span there and are no device work themselves."""
    from torch.autograd import DeviceType
    ops, dev_ranges, host_ranges, window = [], [], [], None
    for e in prof.events():
        t0, t1 = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith("slambench."):
                dev_ranges.append((t0, t1, e.name))
            elif not getattr(e, "is_user_annotation", False) \
                    and "#" not in e.name:
                ops.append((t0, t1, e.name))
        elif e.name == "slambench.window":
            window = (t0, t1)
        elif e.name.startswith("slambench."):
            host_ranges.append((t0, t1, e.name))
    if window is None or not ops:
        return {"n_kernels": len(ops), "busy_s": 0.0, "window_s": 0.0,
                "steps": n_steps}
    w0, w1 = window
    ops = sorted((max(a, w0), min(b, w1), n) for a, b, n in ops
                 if b > w0 and a < w1)
    merged = _union([(a, b) for a, b, _ in ops])
    by_name: Dict[str, float] = {}
    for a, b, n in ops:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
    gaps = []
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = 0.5 * (a + b)
            inner = [r for r in host_ranges if r[0] <= mid <= r[1]]
            label = min(inner, key=lambda r: r[1] - r[0])[2] if inner \
                else "slambench.other"
            gaps.append((label, (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    layer_dev: Dict[str, float] = {}
    for name in sorted({n for _, _, n in dev_ranges}):
        spans = _union([(a, b) for a, b, n in dev_ranges if n == name])
        layer_dev[name] = 1e-6 * sum(_overlap(merged, a, b)
                                     for a, b in spans)
    return {
        "busy_s": sum(b - a for a, b in merged) * 1e-6,
        "window_s": (w1 - w0) * 1e-6, "n_kernels": len(ops),
        "steps": n_steps, "kernels": by_name, "layers_device_s": layer_dev,
        "gaps": gaps,
    }


def _union(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(merged, a, b) -> float:
    """Length of [a, b] covered by the sorted disjoint spans `merged`."""
    if not merged:
        return 0.0
    m = np.asarray(merged, np.float64)
    i0 = np.searchsorted(m[:, 1], a, side="right")
    i1 = np.searchsorted(m[:, 0], b, side="left")
    if i1 <= i0:
        return 0.0
    seg = m[i0:i1]
    return float(np.clip(np.minimum(seg[:, 1], b) - np.maximum(seg[:, 0], a),
                         0.0, None).sum())


# ------------------------------------------------------------- the runs

class Run:
    """What a run measured, for the metric readers."""

    def __init__(self, kind: str):
        self.kind = kind
        self.frames: List[dict] = []
        self.window_s = 0.0
        self.setup_end = 0.0     # perf_counter() when set-up ended
        self.trace: Optional[dict] = None
        self.settings = None
        self.bs = 0


def make_config(spec: dict, seed: int):
    from pin_slam_tpu_torch.config import Config
    cfg = Config().load_dict(json.loads(json.dumps(spec["yaml"])))
    cfg.seed = int(seed) % (1 << 63)
    cfg.silence = True
    cfg.finalize()
    return cfg


def config_departures(cfg, st) -> List[str]:
    """Where the program's reading of the configuration departs from what
    the configuration states (the reference's reading)."""
    from pin_slam_tpu_torch.slam.map_query import make_query_params
    qp = make_query_params(cfg)
    got = {"voxel_m": qp.resolution, "nn_k": qp.nn_k,
           "weighted_first": qp.weighted_first, "sdf_scale": qp.sdf_scale,
           "cell_dist2": qp.max_dist2, "table_size": cfg.buffer_size,
           "idw_index": qp.idw_index, "feature_dim": cfg.feature_dim,
           "mlp_hidden": cfg.geo_mlp_hidden_dim,
           "mlp_level": cfg.geo_mlp_level,
           "eikonal_on": cfg.ekional_loss_on, "weight_e": cfg.weight_e,
           "grad_decimation": cfg.gradient_decimation,
           "grad_eps": cfg.voxel_size_m * cfg.num_grad_step_ratio,
           "loss_weight_on": cfg.loss_weight_on,
           "bs": cfg.bs, "lr": cfg.lr, "adam_eps": cfg.adam_eps,
           "freeze_after_frame": cfg.freeze_after_frame}
    out = []
    for k, v in got.items():
        want = getattr(st, k)
        if isinstance(want, float) and not math.isclose(v, want,
                                                        rel_tol=1e-6):
            out.append(f"{k}: {v} != {want}")
        elif not isinstance(want, float) and v != want:
            out.append(f"{k}: {v} != {want}")
    if sorted(map(tuple, np.asarray(qp.offsets).tolist())) != sorted(
            map(tuple, st.offsets.tolist())):
        out.append("cell offsets differ")
    return out


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_frames(spec, traffic, seed, seconds, trace, device, taps_out,
               log=print):
    """A frames cell. Returns (Run, judge inputs)."""
    import torch
    from pin_slam_tpu_torch.dataset.slam_dataset import intrinsic_correct
    from pin_slam_tpu_torch.slam.loop import LoopPgoManager
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem
    from slambench.reference import settings as ref_settings
    from slambench.scene.frames import make_frames

    run = Run("frames")
    st = ref_settings.read(spec["yaml"])
    run.settings = st
    cfg = make_config(spec, seed)
    if cfg.deskew:
        raise ValueError("deskew needs per-point times, which no mix's "
                         "sensor hands over yet")
    run.bs = cfg.bs
    warm = int(traffic["warmup_frames"])
    n = warm + int(math.ceil(traffic["frames_per_s_cap"] * seconds))
    frames = make_frames(spec, traffic, seed, n, device)
    rng = np.random.default_rng(int(seed) ^ 0x5EED)
    span = max(SAMPLED_FRAMES, min(n - warm, int(2 * seconds)))
    sample = {warm + int(i) for i in rng.choice(span, SAMPLED_FRAMES,
                                                replace=False)}
    taps = Taps(sample, trace)
    taps_out.append(taps)
    taps.install_frames()

    system = PinSLAMSystem(cfg, device=device)
    system.set_gt_poses(frames.truth)
    loop_mgr = LoopPgoManager(cfg, system) if cfg.pgo_on else None
    ba_freq = cfg.ba_freq_frame if cfg.track_on else 0

    def step(fid):
        taps.frame = fid
        pts = frames.points[fid]
        with taps.layer("slambench.dataset"):
            if cfg.kitti_correction_on:
                pts = intrinsic_correct(pts, cfg.correction_deg)
        hook = None
        if loop_mgr is not None:
            def hook(f, _p=pts):
                with taps.layer("slambench.loop_hook"):
                    loop_mgr.after_frame(f, _p)
        with taps.layer("slambench.frame"):
            system.process_frame(fid, pts, gt_pose=frames.truth[fid],
                                 loop_hook=hook)

    for fid in range(warm):
        step(fid)
    _sync(device)
    run.setup_end = time.perf_counter()

    prof = traced = None
    trace_from = warm + TRACE_SKIP
    t_start = time.perf_counter()
    fid = warm
    while fid < n and time.perf_counter() - t_start < seconds:
        if trace and fid == trace_from:
            _sync(device)
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            win = torch.profiler.record_function("slambench.window")
            win.__enter__()
        t0 = time.perf_counter()
        step(fid)
        t1 = time.perf_counter()
        run.frames.append({
            "fid": fid, "wall_s": t1 - t0,
            "gn_iters": system.last_track_iters,
            "pull_s": system.last_pull_block,
            "ba": ba_freq > 0 and (fid + 1) % ba_freq == 0,
            "lost": bool(system.lose_track)})
        fid += 1
        if prof is not None and fid == trace_from + TRACE_FRAMES:
            _sync(device)
            win.__exit__(None, None, None)
            prof.stop()
            traced = (prof, TRACE_FRAMES)
            prof = None
    _sync(device)
    t_end = time.perf_counter()
    if prof is not None:          # the window closed inside the stretch
        win.__exit__(None, None, None)
        prof.stop()
        traced = (prof, fid - trace_from)
    if traced is not None:        # read after the window, not inside it
        run.trace = summarize_trace(*traced)
    run.window_s = t_end - t_start
    if fid >= n:
        log(f"[slambench] the window used up its {n - warm} frames after "
            f"{run.window_s:.3f} s")
    for f in run.frames:
        f["train_iters"] = taps.train_iters.get(f["fid"], 0)
        s = taps.src_n.get(f["fid"])
        f["src_n"] = int(s) if s is not None else 0
    chain = system.pgo_poses if cfg.pgo_on else system.odom_poses
    judge_in = {"poses": chain[:fid].copy(), "truth": frames.truth[:fid],
                "first": warm, "taps": taps, "system": system,
                "departures": config_departures(cfg, st)}
    return run, judge_in


# ---------------------------------------------------------- the judging

def judge_frames(j: dict, st, control: bool = False, log=print
                 ) -> Dict[str, float]:
    """The frames cell's readings (see reference/judge.py)."""
    import torch
    from slambench.reference import judge as J
    taps = j["taps"]
    tcaps = []
    for f in sorted(taps.track):
        t = dict(taps.track[f])
        t["mask"] = torch.arange(t["q"].shape[0], device=t["q"].device) \
            < int(t["n"])
        tcaps.append(t)
    lcaps = []
    for f in sorted(taps.train):
        c = dict(taps.train[f], loss=float(taps.train[f]["loss"]))
        c["update"] = {k: (float(g), float(d))
                       for k, (g, d) in (c["update"] or {}).items()}
        # the base query's SDFs and, with the eikonal term, the six shifted
        # queries' [6, M]
        sdfs = c["loss_sdf"]
        c["loss_sdf"] = (sdfs[0], sdfs[1].reshape(6, -1)
                         if len(sdfs) > 1 else None)
        lcaps.append(c)
    out = {}
    gap, n_cmp, _ = J.track_sdf_gap(tcaps, st, control=control)
    out["track_sdf_gap_m"] = gap if n_cmp else float("inf")
    train, n_b, n_out = J.train_readings(lcaps, st, control=control)
    if not control:
        log(f"[slambench] training queries left out as ambiguous: {n_out}")
    for k, v in train.items():
        out[k] = v if n_b else float("inf")
    if not control:
        out["train_batch_rows_off"] = (J.batch_rows_off(lcaps, st)
                                       if n_b else float("inf"))
    if not control:
        wt, wr, n_p = J.pose_steps(j["poses"], j["truth"], j["first"])
        out["pose_step_m"] = wt if n_p else float("inf")
        out["pose_step_deg"] = wr if n_p else float("inf")
    return out


# ----------------------------------------------------------- the result

def device_info(device, count: int, run: Run) -> dict:
    import torch
    d = torch.device(device)
    if d.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    if run.trace is not None:
        info["busy_s"] = run.trace["busy_s"]
        info["window_s"] = run.trace["window_s"]
    return info


def breakdown(run: Run) -> Optional[dict]:
    tr = run.trace
    if tr is None or "kernels" not in tr:
        return None
    ops = sorted(tr["kernels"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in tr["gaps"][:10]]}


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device, t_process: float, log=print,
             root: Path = ROOT, control: bool = False) -> dict:
    """One run of `cell`; returns the result dict (the printed line).
    `control=True` (slambench/control.py, the tests) also reads the
    control, the reference in TF32 in the program's place, and returns
    its readings under "control", which the printed line leaves out."""
    import gc

    import torch
    from slambench.reference import judge as J

    spec = load_json("configs", cell["config"], root)
    traffic = load_json("traffic", cell["traffic"], root)
    taps_out: List[Taps] = []
    try:
        if traffic["kind"] != "frames":
            raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
        run, j = run_frames(spec, traffic, seed, seconds, trace, device,
                            taps_out, log=log)
    finally:
        for t in taps_out:
            t.restore()
    run.setup_s = run.setup_end - t_process
    dev = device_info(device, int(cell["chips"]), run)

    # the program's state goes before the reference runs
    j.pop("system")
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    st = run.settings
    readings = judge_frames(j, st, log=log)
    ctrl = judge_frames(j, st, control=True, log=log) if control else None
    attempted = len(run.frames)
    failed = sum(f["lost"] for f in run.frames)
    f, dt, dr = J.worst_step(j["poses"], j["truth"], j["first"])
    log(f"[slambench] widest frame motion error: frame {f}, {dt:.4f} m, "
        f"{dr:.4f} deg")
    ok, checks = J.check(readings, limits(root))
    if j["departures"]:
        ok = False
        log("[slambench] the program departs from the configuration: "
            + "; ".join(j["departures"]))

    metrics = {}
    for m in metrics_of(bench, cell["name"], trace):
        val = load_metric(m["name"], root).read(run)
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    result = {"correct": bool(ok), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        bd = breakdown(run)
        if bd is not None:
            result["breakdown"] = bd
    result["checks"] = checks
    if ctrl is not None:
        result["control"] = ctrl
    for name, c in checks.items():
        log(f"[slambench] check {name}: {c['value']!r} (limit "
            f"{c['limit']!r})")
    return result


def print_result(result: dict) -> None:
    print(json.dumps({k: v for k, v in result.items() if k != "control"}),
          flush=True)
