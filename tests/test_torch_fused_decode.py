"""The port's fused per-neighbour decode (pin_slam_tpu_torch.ops.fused_decode)
against the JAX package's Pallas kernel in interpret mode and its XLA
reference, on numpy-seeded inputs. Tolerance 1e-5 absolute: the three
versions sum the same float32 products in different orders, at outputs of
O(0.1). On the CPU the wrapper runs its plain version and counts no launch;
the CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pin_slam_tpu.ops import pallas_decode as jpd
from pin_slam_tpu_torch.ops import fused_decode as tfd

jax.config.update("jax_default_matmul_precision", "highest")
ATOL = 1e-5
SCALE = 0.044


def _inputs(n, k, d, h, seed=0):
    rng = np.random.RandomState(seed)
    gv = rng.randn(n, k, d).astype(np.float32)
    w = rng.rand(n, k).astype(np.float32)
    w = w / w.sum(1, keepdims=True)
    w0 = (rng.randn(d, h) * 0.3).astype(np.float32)
    b0 = (rng.randn(h) * 0.1).astype(np.float32)
    w1 = (rng.randn(h, 1) * 0.3).astype(np.float32)
    b1 = (rng.randn(1) * 0.1).astype(np.float32)
    return gv, w, w0, b0, w1, b1


def _t(arrs):
    return [torch.as_tensor(a) for a in arrs]


@pytest.mark.parametrize("n,k,d,h", [
    (1, 6, 11, 64), (777, 6, 11, 64), (1024, 8, 11, 64), (300, 1, 11, 64),
    (513, 12, 19, 32), (130, 5, 7, 20)])
def test_matches_jax_kernel_and_reference(n, k, d, h):
    a = _inputs(n, k, d, h, seed=n + k)
    ja = [jnp.asarray(x) for x in a]
    ref = np.asarray(jpd.decode_weighted_sdf_reference(*ja, SCALE))
    pallas = np.asarray(jpd.decode_weighted_sdf(*ja, sdf_scale=SCALE,
                                                interpret=True))
    n0 = tfd.LAUNCHES
    plain = tfd.decode_weighted_sdf_reference(*_t(a), SCALE).numpy()
    wrapped = tfd.decode_weighted_sdf(*_t(a), sdf_scale=SCALE).numpy()
    assert tfd.LAUNCHES == n0          # a CPU tensor launches nothing
    assert plain.shape == (n,)
    np.testing.assert_allclose(plain, ref, atol=ATOL)
    np.testing.assert_allclose(plain, pallas, atol=ATOL)
    np.testing.assert_array_equal(wrapped, plain)


def test_mlp_form_equals_per_neighbour_decode():
    """decode_weighted_sdf_mlp on the port's parameter dict equals the
    plain route of map_query (sdf_apply at every neighbour, then
    weighted_reduce)."""
    from pin_slam_tpu_torch.models.decoder import sdf_apply, weighted_reduce

    gv, w, w0, b0, w1, b1 = _t(_inputs(400, 6, 11, 64, seed=3))
    mlp = {"w": [w0, w1], "b": [b0, b1]}
    got = tfd.decode_weighted_sdf_mlp(gv, w, mlp, SCALE)
    want, _ = weighted_reduce(sdf_apply(mlp, gv, SCALE), w)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


@pytest.mark.parametrize("case", [
    "dtype", "w_shape", "w0_rows", "w1_cols", "b1_shape", "strided", "k",
    "gv_rank", "grad"])
def test_wrapper_raises(case):
    gv, w, w0, b0, w1, b1 = _t(_inputs(64, 6, 11, 64))
    if case == "dtype":
        gv = gv.double()
    elif case == "w_shape":
        w = w[:, :5].contiguous()
    elif case == "w0_rows":
        w0 = w0[:10].contiguous()
    elif case == "w1_cols":            # a second hidden layer's weight
        w1 = torch.zeros(64, 64)
    elif case == "b1_shape":
        b1 = torch.zeros(2)
    elif case == "strided":
        gv = torch.zeros(64, 6, 22)[..., ::2]
    elif case == "k":
        gv = torch.zeros(4, tfd.MAX_K + 1, 11)
        w = torch.zeros(4, tfd.MAX_K + 1)
    elif case == "gv_rank":
        gv = gv.reshape(-1, 11)
    elif case == "grad":
        w0 = w0.requires_grad_(True)
    with pytest.raises(ValueError, match="fused_decode"):
        tfd.decode_weighted_sdf(gv, w, w0, b0, w1, b1, SCALE)


@pytest.mark.parametrize("decoder", ["two_layer", "leaky", "two_outputs"])
def test_unsupported_decoder_raises(decoder):
    gv, w, w0, b0, w1, b1 = _t(_inputs(32, 6, 11, 64))
    mlp = {"w": [w0, w1], "b": [b0, b1]}
    leaky = decoder == "leaky"
    if decoder == "two_layer":
        mlp = {"w": [w0, torch.zeros(64, 64), w1],
               "b": [b0, torch.zeros(64), b1]}
    elif decoder == "two_outputs":
        mlp = {"w": [w0, torch.zeros(64, 2)], "b": [b0, torch.zeros(2)]}
    assert not tfd.supports(mlp, leaky)
    with pytest.raises(ValueError, match="one-hidden-layer"):
        tfd.decode_weighted_sdf_mlp(gv, w, mlp, SCALE, leaky=leaky)


def test_forward_only_under_no_grad():
    """Trainable parameters pass under torch.no_grad(), as the mesher calls
    it."""
    gv, w, w0, b0, w1, b1 = _t(_inputs(32, 6, 11, 64))
    w0.requires_grad_(True)
    with torch.no_grad():
        out = tfd.decode_weighted_sdf(gv, w, w0, b0, w1, b1, SCALE)
    assert not out.requires_grad and torch.isfinite(out).all()
