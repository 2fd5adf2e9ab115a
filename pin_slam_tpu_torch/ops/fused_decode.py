"""Fused per-neighbour SDF decode + IDW reduction. Counterpart of
`pin_slam_tpu/ops/pallas_decode.py`.

In `weighted_first=False` mode every query decodes the MLP at each of its k
neighbours and reduces the k predictions with the IDW weights:

    out[n] = sum_j w[n, j] * sdf_scale
             * (relu(geo_vec[n, j, :] @ w0 + b0) @ w1 + b1)

In eager PyTorch the two products are separate kernels with the [N, k, H]
hidden activations written to and re-read from device memory between them.
`decode_weighted_sdf` computes the same function in ONE hand-written CUDA
kernel (`csrc/fused_decode.cu`) that keeps the hidden layer in registers.
It is forward only: callers that need a gradient use the plain decode of
`slam/map_query.py`.

On a CUDA tensor the wrapper launches the kernel or raises; the plain
version `decode_weighted_sdf_reference` runs only for CPU tensors (and
beside the kernel in tests).
"""

from __future__ import annotations

import ctypes

import torch

MAX_K = 512                # neighbours per query: a tile of the kernel
#                            (ROWS in csrc/fused_decode.cu) holds whole
#                            queries in its 512 rows
SMEM_LIMIT = 48 * 1024     # shared memory of a block without opting in

# number of kernel launches since the last reset (a run reads it to show
# that its path went through the CUDA kernel)
LAUNCHES = 0


def decode_weighted_sdf_reference(geo_vec, w, w0, b0, w1, b1,
                                  sdf_scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version: two matmuls, ReLU, scale, weighted sum."""
    h = torch.relu(geo_vec @ w0 + b0)
    per = (h @ w1 + b1)[..., 0] * sdf_scale
    return torch.sum(per * w, dim=1)


def supports(geo_mlp, leaky: bool = False) -> bool:
    """Whether `geo_mlp` ({'w': [...], 'b': [...]}) is the decoder the
    kernel computes: one hidden layer, ReLU (not leaky), one output."""
    ws = geo_mlp["w"]
    return len(ws) == 2 and not leaky and ws[1].shape[1] == 1


def _check(geo_vec, w, w0, b0, w1, b1):
    if geo_vec.dim() != 3 or w.dim() != 2:
        raise ValueError(
            "fused_decode: geo_vec must be [N, k, D] and w [N, k], got "
            f"{tuple(geo_vec.shape)} and {tuple(w.shape)}")
    n, k, d = geo_vec.shape
    if w0.dim() != 2 or w0.shape[0] != d:
        raise ValueError(f"fused_decode: w0 must be [{d}, H], got "
                         f"{tuple(w0.shape)}")
    hid = w0.shape[1]
    want = {"w": (n, k), "b0": (hid,), "w1": (hid, 1), "b1": (1,)}
    for name, t in (("w", w), ("b0", b0), ("w1", w1), ("b1", b1)):
        if tuple(t.shape) != want[name]:
            raise ValueError(
                f"fused_decode: {name} must be {want[name]}, got "
                f"{tuple(t.shape)} (the kernel decodes a one-hidden-layer "
                "MLP with one output)")
    for name, t in (("geo_vec", geo_vec), ("w", w), ("w0", w0), ("b0", b0),
                    ("w1", w1), ("b1", b1)):
        if t.dtype != torch.float32 or t.device != geo_vec.device \
                or not t.is_contiguous():
            raise ValueError(
                f"fused_decode: {name} must be a contiguous float32 tensor "
                f"on {geo_vec.device}, got {t.dtype} on {t.device}")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError(
                f"fused_decode: {name} requires grad, but the fused decode "
                "is forward only (call it under torch.no_grad())")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"fused_decode: k={k} outside 1..{MAX_K}")
    return n, k, d, hid


def decode_weighted_sdf(
    geo_vec: torch.Tensor,   # [N, k, D] f32
    w: torch.Tensor,         # [N, k] normalized IDW weights
    w0: torch.Tensor,        # [D, H]
    b0: torch.Tensor,        # [H]
    w1: torch.Tensor,        # [H, 1]
    b1: torch.Tensor,        # [1]
    sdf_scale: float = 1.0,
) -> torch.Tensor:
    """Fused per-neighbour SDF decode + weighted mean -> [N]. Launches
    `csrc/fused_decode.cu` on the current stream for CUDA tensors; runs the
    plain version for CPU tensors.

    The kernel takes k <= MAX_K and a first layer whose staging fits a
    block's 48 KB of shared memory beside a 512-row tile: D <= 19 inputs
    at H = 64 hidden units (the shipped decoders have D = F + 3 = 11). It
    raises ValueError for a larger k, and on a CUDA tensor for a wider
    first layer."""
    global LAUNCHES
    n, k, d, hid = _check(geo_vec, w, w0, b0, w1, b1)
    if not geo_vec.is_cuda:
        return decode_weighted_sdf_reference(geo_vec, w, w0, b0, w1, b1,
                                             sdf_scale)
    from pin_slam_tpu_torch.ops import cuda_build

    lib = cuda_build.load("fused_decode")
    fn = lib.fused_decode_launch
    if fn.argtypes is None:     # pointers must not pass as 32-bit ints
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        lib.fused_decode_smem_bytes.restype = ctypes.c_int
        lib.fused_decode_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    smem = lib.fused_decode_smem_bytes(d, hid)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"fused_decode: a [{d}, {hid}] first layer needs {smem} bytes of "
            f"shared memory per block, over the {SMEM_LIMIT} the kernel "
            "uses")
    out = torch.empty(n, dtype=torch.float32, device=geo_vec.device)
    if n == 0:
        return out
    with torch.cuda.device(geo_vec.device):
        err = fn(geo_vec.data_ptr(), w.data_ptr(), w0.data_ptr(),
                 b0.data_ptr(), w1.data_ptr(), b1.data_ptr(), out.data_ptr(),
                 n, k, d, hid, float(sdf_scale),
                 torch.cuda.current_stream(geo_vec.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_decode kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out


def decode_weighted_sdf_mlp(geo_vec, w, geo_mlp, sdf_scale: float = 1.0,
                            leaky: bool = False) -> torch.Tensor:
    """`decode_weighted_sdf` with the decoder given as the port's parameter
    dict. Raises on a decoder the kernel does not compute."""
    if not supports(geo_mlp, leaky):
        raise ValueError(
            "fused_decode: the kernel decodes a one-hidden-layer ReLU MLP "
            f"with one output, got {len(geo_mlp['w']) - 1} hidden layer(s), "
            f"leaky={leaky}")
    return decode_weighted_sdf(
        geo_vec, w, geo_mlp["w"][0], geo_mlp["b"][0], geo_mlp["w"][1],
        geo_mlp["b"][1], sdf_scale)
