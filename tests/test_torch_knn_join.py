"""The port's spatial-join k-NN against the JAX package's Pallas kernel (run
in interpret mode on the CPU): idx, d2 and cnt must be EXACTLY equal,
including the dense-map case where the 32-tile budget makes the result
inexact by design. Ports the cases of tests/test_knn_join.py. The CUDA
kernel itself is compared with the plain version on the card in
tests/test_torch_cuda.py."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pin_slam_tpu.ops import knn_join as jk
from pin_slam_tpu_torch.ops import knn_join as tkj

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _sorted_set(lpts, res):
    L = lpts.shape[0]
    si = np.asarray(jk._sort_by_morton(jnp.asarray(lpts),
                                       jnp.ones(L, bool), res * 4.0))
    srt = lpts[si]
    lpad = (-L) % jk.TL
    return np.concatenate([srt, np.full((lpad, 3), 1e9, np.float32)]), si


def _pad_q(q):
    npad = (-q.shape[0]) % jk.TQ
    return np.concatenate([q, np.full((npad, 3), 1e9, np.float32)])


def _both(q, lpts, k, max_d2, res=0.4):
    sp, si = _sorted_set(lpts, res)
    qp = _pad_q(q)
    j = jk.knn_join(jnp.asarray(qp), jnp.asarray(sp), k=k, max_dist2=max_d2,
                    resolution=res)
    t = tkj.knn_join(torch.as_tensor(qp), torch.as_tensor(sp), k=k,
                     max_dist2=max_d2, resolution=res)
    return [np.asarray(a) for a in j], [a.numpy() for a in t], si


def _case_random():
    rng = np.random.RandomState(0)
    p = (rng.rand(4096, 3).astype(np.float32) * 20 - 10)
    q = p[rng.randint(0, len(p), 512)] + \
        rng.randn(512, 3).astype(np.float32) * 0.2
    return q, p


def _case_dense():
    rng = np.random.RandomState(1)
    L = 16384
    p = np.zeros((L, 3), np.float32)
    p[:, :2] = rng.rand(L, 2) * 60 - 30
    p[:, 2] = 0.2 * np.sin(p[:, 0])
    q = p[rng.randint(0, L, 1024)] + \
        rng.randn(1024, 3).astype(np.float32) * 0.05
    return q, p


def _case_ties():
    """Every point of a 0.25 m lattice three times over, shuffled, and
    queries on and between lattice points: the distances are exact binary
    fractions, so equal distances fall across columns, tiles and (in the
    CUDA kernel) its column groups, and only the tie rule orders them."""
    rng = np.random.RandomState(2)
    g = np.stack(np.meshgrid(np.arange(24), np.arange(24), np.arange(4),
                             indexing="ij"), -1).reshape(-1, 3)
    p = np.repeat(g.astype(np.float32) * 0.25, 3, axis=0)
    p = p[rng.permutation(len(p))]
    q = p[rng.randint(0, len(p), 512)] + \
        rng.randint(0, 2, (512, 3)).astype(np.float32) * 0.125
    return q, p


@pytest.mark.parametrize("case,k,max_d2", [
    (_case_random, 6, 1.44), (_case_random, 12, 1.44),
    (_case_random, 8, 0.5), (_case_dense, 6, 1.44), (_case_dense, 12, 1.44),
    (_case_ties, 6, 1.44), (_case_ties, 12, 1.44)])
def test_plain_matches_jax_exactly(case, k, max_d2):
    q, p = case()
    (ji, jd, jc), (ti, td, tc), _ = _both(q, p, k, max_d2)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tc, jc)


def test_dense_map_budget_degrades_gracefully():
    """Every query of the dense sheet sits ~5 cm from a local point: the
    budgeted walk must still find one for all of them."""
    q, p = _case_dense()
    _, (ti, td, _), _ = _both(q, p, 6, 1.44)
    n = q.shape[0]
    assert (ti[:n, 0] >= 0).all()
    assert float(np.sqrt(td[:n, 0]).max()) < 0.5


def test_nearest_matches_brute_force():
    q, p = _case_random()
    _, (ti, td, _), si = _both(q, p, 6, 1.44)
    n = q.shape[0]
    d2 = ((q[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    d2 = np.where(d2 <= 1.44, d2, np.inf)
    best = np.argmin(d2, 1)
    found = np.isfinite(d2.min(1))
    mapped = np.where(ti[:n, 0] >= 0, si[np.clip(ti[:n, 0], 0, None)], -1)
    assert (mapped[found] == best[found]).mean() > 0.999
    np.testing.assert_allclose(td[:n, 0][found], d2.min(1)[found], rtol=1e-4)


def test_qperm_passthrough():
    """A caller-provided query permutation (the tracker sorts once per
    track) gives the same result as JAX with the same permutation."""
    q, p = _case_random()
    sp, _ = _sorted_set(p, 0.4)
    qp = _pad_q(q)
    perm = np.random.RandomState(3).permutation(qp.shape[0]).astype(np.int32)
    j = jk.knn_join(jnp.asarray(qp), jnp.asarray(sp), k=6, max_dist2=1.44,
                    resolution=0.4, qperm=jnp.asarray(perm))
    t = tkj.knn_join(torch.as_tensor(qp), torch.as_tensor(sp), k=6,
                     max_dist2=1.44, resolution=0.4,
                     qperm=torch.as_tensor(perm, dtype=torch.int64))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("case", [_case_random, _case_dense, _case_ties])
def test_chunk_test_keeps_every_in_radius_pair(case):
    """The CUDA kernel skips a (warp, 32-point chunk) pair of a visited
    tile pair when no query of the warp can reach the chunk's bounding box;
    `chip_smoke.chunk_reachable` states that test in plain torch, and
    chip_smoke counts the k-NN bound from it. Every in-radius (query,
    point) pair of the visited tiles must lie in a pair the test keeps, and
    the test must skip some."""
    q, p = case()
    sp, _ = _sorted_set(p, 0.4)
    lp = torch.as_tensor(sp)
    qs, tab, bbd, perm, md2 = tkj.prepare(torch.as_tensor(_pad_q(q)), lp,
                                          1.44, 0.4)
    visits = tkj._knn_walk_plain(qs, lp, tab, bbd, perm, 6, md2)[3]
    steps = torch.arange(tab.shape[1])
    tiles, rows = torch.nonzero(steps[None] < visits[:, None].long(),
                                as_tuple=True)
    ltiles = tab[tiles, rows].long()
    kept = chip_smoke.chunk_reachable(qs, lp, tiles, ltiles, md2)
    w, nc = tkj.TQ // 32, tkj.TL // 32
    assert kept.shape == (len(tiles), w, nc)
    hits = []
    for s in range(0, len(tiles), 8):
        d = (qs.reshape(-1, tkj.TQ, 3)[tiles[s:s + 8], :, None]
             - lp.reshape(-1, tkj.TL, 3)[ltiles[s:s + 8], None])
        dx, dy, dz = d.unbind(-1)
        d2 = tkj._fma(dz, dz, tkj._fma(dx, dx, dy * dy))
        hits.append((d2 <= md2).reshape(-1, w, 32, nc, 32).any(4).any(2))
    hit = torch.cat(hits)
    assert bool(hit.any())
    assert bool((kept | ~hit).all())
    assert not bool(kept.all())
