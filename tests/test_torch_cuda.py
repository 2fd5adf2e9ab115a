"""Tests of the port that need the card (marked `cuda`; they skip without
one). This file imports torch and numpy only, so it runs where JAX is not
installed:  python -m pytest tests/test_torch_cuda.py -m cuda"""

import numpy as np
import pytest
import torch

from pin_slam_tpu_torch.ops import fused_decode as tfd
from pin_slam_tpu_torch.ops import knn_join as tkj


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _dense_case(dev, n_q=1024, L=16384, seed=1):
    rng = np.random.RandomState(seed)
    p = np.zeros((L, 3), np.float32)
    p[:, :2] = rng.rand(L, 2) * 60 - 30
    p[:, 2] = 0.2 * np.sin(p[:, 0])
    q = p[rng.randint(0, L, n_q)] + rng.randn(n_q, 3).astype(np.float32) * 0.05
    pt = torch.as_tensor(p, device=dev)
    si = tkj._sort_by_morton(pt, torch.ones(L, dtype=torch.bool, device=dev),
                             1.6)
    lp = torch.cat([pt[si], torch.full(((-L) % tkj.TL, 3), tkj.PAD,
                                       device=dev)])
    qp = torch.cat([torch.as_tensor(q, device=dev),
                    torch.full(((-n_q) % tkj.TQ, 3), tkj.PAD, device=dev)])
    return qp, lp


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 6, 8, 12, 16])
def test_knn_kernel_matches_plain(cuda, k):
    """Kernel vs plain version on the same prepared inputs: idx, d2, cnt
    and the per-tile visit counts are equal."""
    qp, lp = _dense_case(cuda)
    qs, tab, bbd, perm, md2 = tkj.prepare(qp, lp, 1.44, 0.4)
    n0 = tkj.LAUNCHES
    got = tkj._knn_walk_cuda(qs, lp, tab, bbd, perm, k, md2)
    ref = tkj._knn_walk_plain(qs, lp, tab, bbd, perm, k, md2)
    torch.cuda.synchronize()
    assert tkj.LAUNCHES == n0 + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_knn_join_on_cuda_tensor_launches_kernel(cuda):
    qp, lp = _dense_case(cuda, n_q=300)
    n0 = tkj.LAUNCHES
    idx, d2, cnt = tkj.knn_join(qp, lp, k=6, max_dist2=1.44, resolution=0.4)
    torch.cuda.synchronize()
    assert tkj.LAUNCHES == n0 + 1
    assert idx.is_cuda and (idx[:300, 0] >= 0).all()


def _decode_case(dev, n, k, f, h, seed=0, hidden_layers=1):
    rng = np.random.RandomState(seed)
    d = f + 3
    gv = rng.randn(n, k, d).astype(np.float32) * 0.4
    w = rng.rand(n, k).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    dims = [d] + [h] * hidden_layers + [1]
    mlp = {"w": [torch.as_tensor(rng.randn(a, b).astype(np.float32) * 0.3,
                                 device=dev)
                 for a, b in zip(dims[:-1], dims[1:])],
           "b": [torch.as_tensor(rng.randn(b).astype(np.float32) * 0.1,
                                 device=dev) for b in dims[1:]]}
    return torch.as_tensor(gv, device=dev), torch.as_tensor(w, device=dev), mlp


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,f,h", [(524288, 6, 8, 64), (777, 8, 8, 64),
                                     (1, 1, 8, 64), (5000, 5, 13, 37)])
def test_fused_decode_kernel_matches_plain(cuda, n, k, f, h):
    """Kernel vs plain version, 1e-5: float32 sums in another order at
    outputs of O(0.1). One launch, counted."""
    gv, w, mlp = _decode_case(cuda, n, k, f, h)
    args = (gv, w, mlp["w"][0], mlp["b"][0], mlp["w"][1], mlp["b"][1], 0.05)
    n0 = tfd.LAUNCHES
    got = tfd.decode_weighted_sdf(*args)
    torch.cuda.synchronize()
    assert tfd.LAUNCHES == n0 + 1
    ref = tfd.decode_weighted_sdf_reference(*args)
    assert got.shape == (n,) and got.is_cuda
    assert float(ref.abs().max()) > 1e-3
    assert float((got - ref).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_fused_decode_refuses_other_decoders_on_the_card(cuda):
    gv, w, two = _decode_case(cuda, 64, 6, 8, 64, hidden_layers=2)
    n0 = tfd.LAUNCHES
    with pytest.raises(ValueError, match="one-hidden-layer"):
        tfd.decode_weighted_sdf_mlp(gv, w, two, 0.05)
    _, _, one = _decode_case(cuda, 64, 6, 8, 64)
    with pytest.raises(ValueError, match="leaky"):
        tfd.decode_weighted_sdf_mlp(gv, w, one, 0.05, leaky=True)
    with pytest.raises(ValueError, match="float32"):
        tfd.decode_weighted_sdf_mlp(gv.double(), w, one, 0.05)
    assert tfd.LAUNCHES == n0


@pytest.mark.cuda
def test_index_add_exact_is_repeatable_on_the_card(cuda):
    """The fixed-point scatter-add gives the same bits on every call on the
    card, where the additions run as atomics in any order, and the bits of
    the CPU result."""
    from pin_slam_tpu_torch.ops.scatter import index_add_exact

    rng = np.random.RandomState(3)
    m, rows = 400000, 3000
    idx = torch.as_tensor(rng.randint(0, rows, m))
    src = torch.as_tensor((rng.randn(m, 8) * 1e-5).astype(np.float32))
    dst = torch.zeros(rows, 8)
    want = index_add_exact(dst, idx, src)
    for _ in range(3):
        got = index_add_exact(dst.to(cuda), idx.to(cuda), src.to(cuda))
        assert torch.equal(got.cpu(), want)
