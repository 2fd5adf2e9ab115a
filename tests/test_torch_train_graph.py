"""The captured whole-map training route (`slam/mapper.py::_WholeMapGraph`)
on the CPU, where it runs its iteration eagerly.

* Its filter reads the frame id and the reboot frame as device scalars:
  the travel window's lower bound, and a whole-map iteration's
  neighbours, loss and feature gradient under the cell and the brick
  probe, are the same bits as with Python ints.
* The probes' constants are uploaded once per device and shared.
* Its buffers, refreshed by copies each frame and stepped by a fresh
  Adam each frame, give the eager loop's features, decoder, certainty,
  update timestamps, losses and poses bit for bit, frame after frame, through
  frame 0's long run, other iteration counts, the decoder freeze and a
  capacity growth, under the cell and the brick probe, and under the cell
  probe with colour, semantics, the consistency loss and the projective
  correction (`train_graph_case.py`; the card test holds the replayed
  graph to the same)."""

import numpy as np
import pytest
import torch

import train_graph_case as case
from pin_slam_tpu_torch.config import Config
from pin_slam_tpu_torch.models import neural_points as npm
from pin_slam_tpu_torch.models.decoder import init_mlp_params
from pin_slam_tpu_torch.ops import hash3d
from pin_slam_tpu_torch.slam import map_query as mq
from pin_slam_tpu_torch.slam import mapper as mp

RES = 0.4
F = 8
TRAVEL = torch.arange(16, dtype=torch.float32) * 3.0
LOSS_KW = dict(sigma_sigmoid_m=0.1, loss_weight_on=True,
               ekional_loss_on=True, weight_e=0.5,
               numerical_grad_eps=RES * 0.2, gradient_decimation=4,
               main_loss_type="bce")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("cur_ts", [0, 3, 9, 15])
def test_travel_window_reads_a_device_scalar_frame(cur_ts, strict):
    """The window's lower bound from an int64 scalar tensor frame id is
    the one from the int."""
    travel = TRAVEL.clone()
    travel[5:] += 0.5               # uneven steps
    for window in (0.0, 4.0, 10.0):
        a = npm._travel_window_ts_lo(travel, cur_ts, window, strict=strict)
        b = npm._travel_window_ts_lo(travel, torch.tensor(cur_ts), window,
                                     strict=strict)
        assert torch.equal(a, b)


def _map(probe):
    """Three overlapping scans of a wavy plane inserted at frames 0, 4
    and 8, with random features."""
    rng = np.random.RandomState(1)
    s = npm.init_map_state(8192, 1 << 14, F,
                           with_btable=probe == "brick")
    for k, shift in enumerate((0.0, 1.3, 2.6)):
        p = np.zeros((4000, 3), np.float32)
        p[:, :2] = rng.rand(4000, 2) * 16 - 8 + shift
        p[:, 2] = 0.3 * np.sin(p[:, 0]) + rng.randn(4000) * 0.02
        s, _ = npm.insert_points(
            s, torch.as_tensor(p), torch.ones(4000, dtype=torch.bool),
            4 * k, TRAVEL, resolution=RES, local_window_dist=100.0)
    s.geo_features.copy_(torch.as_tensor(
        rng.randn(*s.geo_features.shape).astype(np.float32) * 0.1))
    q = np.zeros((1024, 3), np.float32)
    q[:, :2] = rng.rand(1024, 2) * 16 - 6
    q[:, 2] = 0.3 * np.sin(q[:, 0]) + rng.randn(1024) * 0.2
    batch = {"coord": torch.as_tensor(q),
             "sdf_label": torch.as_tensor(0.3 * np.sin(q[:, 0]) - q[:, 2]),
             "weight": torch.ones(1024),
             "ts": torch.full((1024,), 8, dtype=torch.int32)}
    return s, batch


@pytest.mark.parametrize("probe", ["cells", "brick"])
@pytest.mark.parametrize("cur_ts,reboot_ts", [(8, 0), (8, 6), (5, 0)])
def test_whole_map_iteration_reads_device_scalars_as_ints(probe, cur_ts,
                                                          reboot_ts):
    """One whole-map training iteration's loss (with the eikonal term)
    under a travel window that drops some scans: the filter's frame id and
    reboot frame as int64 scalar tensors give the neighbours, the loss and
    the feature gradient of the ints, bit for bit."""
    c = Config()
    c.voxel_size_m, c.probe_mode = RES, probe
    qp = mq.make_query_params(c.finalize())
    s, batch = _map(probe)
    mlp = init_mlp_params(torch.Generator().manual_seed(3), F + 3, 32, 1, 1)
    mask = torch.ones(1024, dtype=torch.bool)
    out = []
    for as_tensor in (False, True):
        lf = mq.LocalFilter(
            travel_dist=TRAVEL, local_window_dist=10.0,
            cur_ts=torch.tensor(cur_ts) if as_tensor else cur_ts,
            reboot_ts=torch.tensor(reboot_ts) if as_tensor else reboot_ts)
        feats = s.geo_features.clone().requires_grad_(True)
        loss, aux = mp.mapping_loss(feats, mlp, batch, mask, None, None,
                                    None, qp, state=s, lf=lf, **LOSS_KW)
        (grad,) = torch.autograd.grad(loss, feats)
        qn = aux["qn"]
        out.append([loss.detach(), qn.idx, qn.dist2, qn.valid, qn.nn_count,
                    aux["w"].detach(), grad])
    for a, b in zip(*out):
        assert torch.equal(a, b)
    # the window and the reboot frame drop neighbours, and some remain
    valid = out[0][3]
    nofilter = npm.query_neighbors(
        s, batch["coord"], offsets=qp.offsets_np, resolution=RES,
        nn_k=qp.nn_k, max_dist2=qp.max_dist2, probe_mode=probe)
    assert 0 < int(valid.sum()) < int(nofilter.valid.sum())
    assert bool((out[0][6] != 0).any())


def test_probe_constants_are_uploaded_once():
    """The cell offsets, the brick probe's ball and the eikonal shifts are
    one tensor per device, shared by every query."""
    offs = hash3d.neighbor_offsets(2, 0.2)
    a = npm.device_constant(offs, torch.int32, "cpu")
    assert a is npm.device_constant(offs.copy(), torch.int32, "cpu")
    assert torch.equal(a, torch.as_tensor(offs))
    assert a is not npm.device_constant(offs, torch.int64, "cpu")
    like = torch.zeros(3)
    assert mq._shifts6(0.08, like) is mq._shifts6(0.08, like)
    assert torch.equal(mq._shifts6(0.08, like), torch.tensor(
        [[0.08, 0, 0], [-0.08, 0, 0], [0, 0.08, 0], [0, -0.08, 0],
         [0, 0, 0.08], [0, 0, -0.08]]))


@pytest.fixture(scope="module", params=case.VARIANTS)
def routes(request):
    seq = case.frames(request.param)
    graphed, a = case.run("cpu", seq, request.param,
                          replay=lambda dev: True)
    eager, b = case.run("cpu", seq, request.param)
    return request.param, graphed, eager, a, b


def test_the_route_buffers_repeat_the_eager_loop(routes):
    """Every frame's features (and colour features), decoders, certainty,
    update timestamps, losses and pose, under the cell and the brick
    probe and with every branch of the iteration on: the route's buffers
    against the eager loop."""
    *_, a, b = routes
    case.assert_bit_equal(a, b)


def test_the_run_takes_every_turn(routes):
    """The case's frames train 60, 3, 5, 3, 3, 3 iterations, the decoder
    freezes and the capacity grows; the route kept one graph, the grown
    map's, and captured nothing off the card; the CPU's default route
    built none. `full` trains the colour features, the colour and the
    semantic decoders and a consistency term; its tracker loses track
    from frame 1 on (the consistency loss does that to this small map,
    under the join probe too), so its frame 5, past the frames that
    always map, does not train."""
    variant, graphed, eager, a, _ = routes
    full = variant == "full"
    assert [bool(f["trained"]) for f in a] == [True] * 5 + [not full]
    assert [len(f["losses"]) for f in a] == [60, 3, 5, 3, 3, 3]
    assert graphed.decoder_freezed
    assert graphed.state.capacity == 2 * (1 << 15)
    (g,) = graphed._train_graph.values()
    assert g.graph is None and g.state.capacity == 2 * (1 << 15)
    assert not eager._train_graph
    assert {"color_features", "color_mlp", "sem_mlp"} <= set(a[0]) \
        if full else not {"color_features", "color_mlp", "sem_mlp"} & set(a[0])
    if full:
        assert g.cfeat is not None and g.cons_u is not None
        assert g.lf.sensor_origins is not None
        assert not torch.equal(a[0]["color_features"], a[1]["color_features"])
