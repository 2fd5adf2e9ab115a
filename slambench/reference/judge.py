"""The numbers that decide `correct`, each computed from what the timed
path produced, against the float64 reference of `decode.py` or the
scene's ground truth. Every function returns a reading (larger is worse)
and how many items it compared; `control=True` puts the reference itself,
computed in TF32, in the program's place.

The program's outputs held to the reference:

- track_sdf_gap_m: the SDF the tracker decoded at its source points in
  its first Gauss-Newton iteration (the hash-table probe's neighbours
  under the travel window, the map's features, the decoder), widest gap
  over the points;
- train_loss_rel: the mapping loss of a frame's first training iteration
  (the SDF at the batch's samples, the BCE against their labels, the
  eikonal term through six shifted queries) over the samples whose
  neighbours rounding cannot change, relative gap (`train_readings`);
- train_grad_rel: the gradient of that first iteration's loss as the
  program's Adam got it (worked out from its first moment after the step),
  leaf by leaf (the map's features, the decoder's weights and biases where
  it trains), against the reference's float64 gradient: the widest gap
  between the two norms of a leaf, over the reference's norm of that leaf
  or of the median leaf, whichever is larger;
- train_step_rel: the change Adam's first step made to each leaf, against
  the change the reference's Adam step makes from its own gradient, the
  same way (leaves whose reference gradient is under a thousandth of the
  median leaf's, which move by round-off alone, are left out);
- train_batch_rows_off: how many rows a training batch lacks or has over
  the configuration's batch size (exact);
- pose_step_m, pose_step_deg: the system's final pose chain against the
  scene's truth, frame to frame: the widest error of a frame's motion.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from slambench.reference import decode as R
from slambench.reference.settings import Settings


def _params(mlp: dict) -> Tuple[list, list]:
    return list(mlp["w"]), list(mlp["b"])


def _map(c: dict, st: Settings):
    """The map rows of a snapshot {pts, ts, quat, count} and its hash
    table, as the reference works it out."""
    n = int(c["count"])
    pts = c["pts"][:n]
    quat = c["quat"][:n] if c.get("quat") is not None else None
    if quat is not None and not bool((quat[:, 1:4] != 0).any()):
        quat = None
    return pts, quat, R.CellTable(pts, c["ts"][:n], st)


def _filter(c: dict, n: int) -> Optional[R.Filter]:
    f = c.get("filter")
    if f is None:
        return None
    return R.Filter(travel=f["travel"], cur_ts=int(f["cur_ts"]),
                    window=float(f["window"]), reboot_ts=int(f["reboot_ts"]),
                    ts=c["ts"][:n], sensor=f.get("sensor"),
                    radius=float(f.get("radius", 0.0)))


def track_sdf_gap(caps: List[dict], st: Settings, control: bool = False
                  ) -> Tuple[float, int, int]:
    """caps: per sampled frame, the tracker's first decode {q [S, 3] the
    float32 world queries the probe hashes, q64 [S, 3] the same exactly
    (the tracker's anchored points plus the anchor), mask [S], sdf [S]
    program} and the map it queried {pts, ts, quat, count, feats, mlp,
    filter}. Returns (widest |gap| in metres, points compared, points left
    out as ambiguous)."""
    worst, n_cmp, n_amb = 0.0, 0, 0
    for c in caps:
        pts, quat, table = _map(c, st)
        q = c["q64"][c["mask"]]
        nb = R.neighbours(q, pts, table, st, _filter(c, pts.shape[0]),
                          q_cell=c["q"][c["mask"]])
        feats = c["feats"][:pts.shape[0]]
        ref = R.sdf(q, nb, pts, feats, _params(c["mlp"]), st, quats=quat,
                    prec="f64")
        got = (R.sdf(q, nb, pts, feats, _params(c["mlp"]), st, quats=quat,
                     prec="tf32")
               if control else c["sdf"][c["mask"]])
        ok = ~nb.ambiguous
        gap = (got.double() - ref).abs()[ok]
        if gap.numel():
            worst = max(worst, float(gap.max()))
        n_cmp += int(ok.sum())
        n_amb += int((~ok).sum())
    return worst, n_cmp, n_amb


def _masked_mean(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return torch.where(m, x, torch.zeros_like(x)).sum() / \
        m.double().sum().clamp(min=1.0)


def batch_sdf(c: dict, st: Settings, prec: str, feats=None, params=None):
    """The SDF of one training batch, c = {coord [B, 3], label [B], weight
    [B], mask [B]} and the map it trains {pts, ts, quat, count, feats,
    mlp, filter}: at the samples [B], and at the eikonal term's six
    shifted queries (+-eps along x, y, z) of every grad_decimation-th
    sample [6, M] (None without the term), each query with its own
    neighbours; and whether float32 rounding could change a sample's
    neighbours, or any of its shifted queries' ([B], [M]). `feats` [M, F]
    and `params` replace the snapshot's (leaves to differentiate)."""
    pts, quat, table = _map(c, st)
    filt = _filter(c, pts.shape[0])
    if feats is None:
        feats = c["feats"][:pts.shape[0]]
    if params is None:
        params = _params(c["mlp"])

    def sdf_at(q):
        nb = R.neighbours(q, pts, table, st, filt)
        return R.sdf(q, nb, pts, feats, params, st, quats=quat,
                     prec=prec).double(), nb.ambiguous

    s, amb = sdf_at(c["coord"])
    if not (st.eikonal_on and st.weight_e > 0):
        return s, None, amb, None
    base = c["coord"][::st.grad_decimation].float()
    vals, ambs = [], []
    for axis in range(3):
        for sign in (1.0, -1.0):
            sh = torch.zeros(3, dtype=torch.float32, device=base.device)
            sh[axis] = sign * st.grad_eps
            v, a = sdf_at(base + sh)
            vals.append(v)
            ambs.append(a)
    return s, torch.stack(vals), amb, torch.stack(ambs).any(0)


def batch_loss(c: dict, st: Settings, s: torch.Tensor, vals,
               keep=None, keep_e=None) -> torch.Tensor:
    """The mapping loss from a batch's SDFs (`batch_sdf`): the BCE of the
    SDF at the samples against their labels (weighted), and the eikonal
    term of the central-difference gradient at the decimated samples;
    each a mean over the batch's mask and, where given, `keep` [B] /
    `keep_e` [M]."""
    w = c["weight"].double().abs()
    mask = c["mask"] & (w > 0)
    sig = st.bce_sigma
    logits = s.double() / sig
    target = torch.sigmoid(c["label"].double() / sig)
    per = (logits.clamp(min=0.0) - logits * target
           + torch.log1p(torch.exp(-logits.abs())))
    if st.loss_weight_on:
        per = per * w
    total = _masked_mean(per, mask if keep is None else mask & keep)
    if vals is None:
        return total
    v = vals.double()
    g = torch.stack([v[0] - v[1], v[2] - v[3], v[4] - v[5]], -1) \
        / (2 * st.grad_eps)
    gn = torch.sqrt((g * g).sum(-1) + 1e-12)
    me = mask[::st.grad_decimation]
    return total + st.weight_e * _masked_mean(
        (gn - 1.0) ** 2, me if keep_e is None else me & keep_e)


def decoder_trains(frame: int, reboot_ts: int, st: Settings) -> bool:
    """Whether a frame's training updates the decoder: before
    `freeze_after_frame` frames since the map's (re)start."""
    return frame - reboot_ts < st.freeze_after_frame


def first_step(c: dict, st: Settings, prec: str):
    """The reference's first training step of a batch: its loss, per leaf
    (feats, w0, b0, ...) the norm of the loss's gradient and of Adam's
    first step from it ((1 - beta1) g over sqrt((1 - beta2) g^2) with both
    bias corrections: lr g / (|g| + eps)), and the batch's SDFs with their
    ambiguity (`batch_sdf`). In float64, or for the control in float32
    with TF32 products (forward and backward)."""
    dt = torch.float64 if prec == "f64" else torch.float32
    n = int(c["count"])
    feats = c["feats"][:n].to(dt).clone().requires_grad_(True)
    ws, bs = _params(c["mlp"])
    dec = decoder_trains(int(c["frame"]), int(c["filter"]["reboot_ts"])
                         if c.get("filter") else 0, st)
    ws = [w.to(dt).clone().requires_grad_(dec) for w in ws]
    bs = [b.to(dt).clone().requires_grad_(dec) for b in bs]
    leaves = {"feats": feats}
    if dec:
        leaves.update({f"w{i}": w for i, w in enumerate(ws)})
        leaves.update({f"b{i}": b for i, b in enumerate(bs)})
    s, vals, amb, amb_e = batch_sdf(c, st, prec, feats=feats,
                                    params=(ws, bs))
    loss = batch_loss(c, st, s, vals)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    out = {}
    for (name, _), g in zip(leaves.items(), grads):
        g = g.detach()
        step = st.lr * g / (g.abs() + st.adam_eps)
        out[name] = (float(torch.linalg.vector_norm(g.double())),
                     float(torch.linalg.vector_norm(step.double())))
    vals = None if vals is None else vals.detach()
    return float(loss.detach()), out, (s.detach(), vals, amb, amb_e)


def _leaf_gap(got: Dict[str, float], ref: Dict[str, float],
              leave_out=()) -> float:
    """Widest |norm got - norm ref| over max(ref's norm of the leaf, the
    median of ref's leaf norms), over the leaves of either side."""
    if not ref:
        return float("inf")
    med = float(np.median(list(ref.values())))
    worst = 0.0
    for name in set(got) | set(ref):
        if name in leave_out:
            continue
        a, b = got.get(name, 0.0), ref.get(name, 0.0)
        worst = max(worst, abs(a - b) / max(b, med, 1e-300))
    return worst


def train_readings(caps: List[dict], st: Settings, control: bool = False
                   ) -> Tuple[Dict[str, float], int, int]:
    """The sampled frames' first training steps. train_loss_rel: the
    program's loss against the reference's over the samples whose
    neighbours float32 rounding cannot change (the others are left out on
    both sides, as in track_sdf_gap): the program's loss less the same
    formula over the program's own SDFs of every sample (its arithmetic),
    plus that formula over the kept samples, against the reference's
    formula over the reference's SDFs of the kept samples; widest
    relative gap. The widest leaf gaps of the gradient and of the change
    (`_leaf_gap`). Each cap carries the program's loss, its SDFs at the
    batch and the shifted queries ("loss_sdf") and its per-leaf norms
    {leaf: (grad norm, step norm)} ("update"). Returns the readings, the
    frames compared and the samples left out."""
    loss_w, g_worst, s_worst, n_out = 0.0, 0.0, 0.0, 0
    for c in caps:
        _, ref, (rs, rv, amb, amb_e) = first_step(c, st, "f64")
        keep = ~amb
        keep_e = None if amb_e is None else ~amb_e
        n_out += int(amb.sum()) + (0 if amb_e is None
                                   else int(amb_e.sum()))
        if control:
            _, got, (ps, pv, _, _) = first_step(c, st, "tf32")
            arith = 0.0
        else:
            got = c["update"]
            ps, pv = c["loss_sdf"]
            arith = c["loss"] - float(batch_loss(c, st, ps, pv))
        ref_l = float(batch_loss(c, st, rs, rv, keep, keep_e))
        got_l = float(batch_loss(c, st, ps, pv, keep, keep_e)) + arith
        loss_w = max(loss_w, abs(got_l - ref_l) / max(abs(ref_l), 1e-12))
        rg = {k: v[0] for k, v in ref.items()}
        med = float(np.median(list(rg.values())))
        still = {k for k, v in rg.items() if v < 1e-3 * med}
        g_worst = max(g_worst, _leaf_gap({k: v[0] for k, v in got.items()},
                                         rg))
        s_worst = max(s_worst, _leaf_gap(
            {k: v[1] for k, v in got.items()},
            {k: v[1] for k, v in ref.items()}, leave_out=still))
    return {"train_loss_rel": loss_w, "train_grad_rel": g_worst,
            "train_step_rel": s_worst}, len(caps), n_out


def batch_rows_off(caps: List[dict], st: Settings) -> int:
    """The most rows a sampled training batch lacks or has over the
    configuration's batch size."""
    return max((abs(int(c["coord"].shape[0]) - st.bs) for c in caps),
               default=0)


def _rot_deg(R3: np.ndarray) -> float:
    c = (np.trace(R3) - 1.0) / 2.0
    return math.degrees(math.acos(min(1.0, max(-1.0, c))))


def _step_errors(est: np.ndarray, truth: np.ndarray, first: int):
    """(frame, metres, degrees) of each frame's motion error from `first`
    on (each frame's motion from the frame before)."""
    out = []
    for f in range(max(first, 1), est.shape[0]):
        de = np.linalg.inv(est[f - 1]) @ est[f]
        dt = np.linalg.inv(truth[f - 1]) @ truth[f]
        e = np.linalg.inv(dt) @ de
        out.append((f, float(np.linalg.norm(e[:3, 3])), _rot_deg(e[:3, :3])))
    return out


def pose_steps(est: np.ndarray, truth: np.ndarray, first: int
               ) -> Tuple[float, float, int]:
    """Widest frame-to-frame motion error (metres, degrees) of est [F, 4,
    4] against truth over the frames from `first` on."""
    e = _step_errors(est, truth, first)
    return (max((x[1] for x in e), default=0.0),
            max((x[2] for x in e), default=0.0), len(e))


def worst_step(est: np.ndarray, truth: np.ndarray, first: int):
    """The frame with the widest motion error: (frame, metres, degrees)."""
    e = _step_errors(est, truth, first)
    return max(e, key=lambda x: x[1]) if e else (-1, 0.0, 0.0)


def check(readings: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """Each reading beside its limit; correct when every reading is
    finite and within its limit."""
    out, ok = {}, True
    for name, val in readings.items():
        lim = limits[name]
        good = val is not None and math.isfinite(val) and val <= lim
        ok = ok and good
        out[name] = {"value": val, "limit": lim}
    return ok, out
