"""Tests of the port that need the card (marked `cuda`; they skip without
one). This file imports torch and numpy only, so it runs where JAX is not
installed:  python -m pytest tests/test_torch_cuda.py -m cuda"""

import numpy as np
import pytest
import torch

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
