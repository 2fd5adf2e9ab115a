// Fused per-neighbour SDF decode + IDW reduction for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel` of
// pin_slam_tpu/ops/pallas_decode.py (wrapper `decode_weighted_sdf`): the
// `weighted_first=False` decode,
//   out[n] = sum_j w[n,j] * sdf_scale * (relu(gv[n,j,:] . W0 + b0) . W1 + b1)
// forward only. Both products, the ReLU, the scale and the weighted sum over
// the k neighbours are in this kernel's body; the [N*k, H] hidden
// activations live in registers and never reach device memory.
//
// Inputs (checked by the Python wrapper, all contiguous f32):
//   gv [N, k, D]  per-neighbour decoder inputs (features | offset vector)
//   w  [N, k]     normalized IDW weights
//   w0 [D, H], b0 [H], w1 [H, 1], b1 [1]   one-hidden-layer ReLU decoder
// Output: out [N] f32.
//
// What bounds it on this card: operations. A row (one neighbour of one
// query) costs 2*D*H + 3*H fp32 operations against (D+1)*4 bytes read, at
// D = 11, H = 64 about 33 operations per byte, above the card's fp32 ridge
// of 67 TFLOP/s / 3.35 TB/s = 20. The products are too small and too
// ragged (D = 11, one output column) for the tensor cores to be worth their
// staging in a first version, so the design aims at the fp32 pipe:
//   * the TPU kernel pads D -> 128 and H -> 128 lanes and N to blocks of
//     1024 in padded copies of every input; none of that is carried over.
//     D, H, k and N are runtime values and the ragged end of N is masked
//     here;
//   * one thread per ROW (query n, neighbour j), not per query: a tile is
//     floor(128 / k) whole queries = up to 128 consecutive rows, which are
//     one contiguous span of gv. The block copies that span into shared
//     memory with coalesced loads (a row is D*4 = 44 bytes, so per-thread
//     row loads straight from device memory would be misaligned and
//     strided) and each thread then reads its row at an odd stride, free
//     of bank conflicts;
//   * W0, b0, W1 are staged in shared memory once per block, H padded with
//     zeros to a multiple of 8, and read as 16-byte warp-wide broadcasts:
//     8 hidden units are accumulated at a time in registers, so 2 shared
//     loads feed 8 fused multiply-adds;
//   * the sum over a query's k rows goes through shared memory, in
//     neighbour order j = 0..k-1;
//   * blocks walk the tiles with a grid stride, so the weights are staged
//     a few times per SM rather than once per tile.
// Rounding: every multiply-add is an explicit fmaf (one rounding), whatever
// contraction flag the file is built with; the hidden sum runs over the
// inputs in order f = 0..D-1 from the bias, the output sum over h = 0..H-1
// from zero. The plain PyTorch version sums in the library's order, so the
// two agree to float32 rounding of the sums (<= 1e-5 at outputs of O(0.1)),
// not bit for bit.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 128;   // rows per tile, one thread each
constexpr int HC = 8;          // hidden units accumulated at a time

// DT > 0: the input width is the compile-time DT and a row sits in
// registers; DT == 0: the width is the runtime d and rows are read from
// shared memory inside the loop.
template <int DT>
__global__ void __launch_bounds__(THREADS)
fused_decode_kernel(const float* __restrict__ gv, const float* __restrict__ w,
                    const float* __restrict__ w0,
                    const float* __restrict__ b0,
                    const float* __restrict__ w1,
                    const float* __restrict__ b1, float* __restrict__ out,
                    int n, int k, int d_rt, int h, int hp, float sdf_scale,
                    int num_tiles) {
  extern __shared__ __align__(16) float smem[];
  const int d = DT > 0 ? DT : d_rt;
  const int ds = d | 1;              // odd row stride: no bank conflicts
  float* W0s = smem;                 // [d][hp]
  float* b0s = W0s + d * hp;         // [hp]
  float* W1s = b0s + hp;             // [hp]
  float* xs = W1s + hp;              // [THREADS][ds]
  float* vs = xs + THREADS * ds;     // [THREADS]
  const int tid = threadIdx.x;

  for (int e = tid; e < d * hp; e += THREADS) {
    const int f = e / hp;
    const int j = e - f * hp;
    W0s[e] = j < h ? w0[f * h + j] : 0.0f;
  }
  for (int j = tid; j < hp; j += THREADS) {
    b0s[j] = j < h ? b0[j] : 0.0f;
    W1s[j] = j < h ? w1[j] : 0.0f;
  }
  const float bias1 = b1[0];
  const int qt = THREADS / k;        // whole queries per tile

  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int q0 = tile * qt;
    const int nq = min(qt, n - q0);
    const int nrows = nq * k;
    const size_t row0 = static_cast<size_t>(q0) * k;
    const float* g = gv + row0 * d;
    for (int e = tid; e < nrows * d; e += THREADS) {
      const int r = e / d;
      xs[r * ds + (e - r * d)] = g[e];
    }
    __syncthreads();   // also orders the weight staging before its first use

    if (tid < nrows) {
      const float* xrow = xs + tid * ds;
      float x[DT > 0 ? DT : 1];
      if (DT > 0) {
#pragma unroll
        for (int f = 0; f < DT; ++f) x[f] = xrow[f];
      }
      float per = 0.0f;
      for (int c = 0; c < hp; c += HC) {
        const float4 ba = *reinterpret_cast<const float4*>(b0s + c);
        const float4 bb = *reinterpret_cast<const float4*>(b0s + c + 4);
        float a0 = ba.x, a1 = ba.y, a2 = ba.z, a3 = ba.w;
        float a4 = bb.x, a5 = bb.y, a6 = bb.z, a7 = bb.w;
#pragma unroll
        for (int f = 0; f < (DT > 0 ? DT : d); ++f) {
          const float xv = DT > 0 ? x[DT > 0 ? f : 0] : xrow[f];
          const float4 wa =
              *reinterpret_cast<const float4*>(W0s + f * hp + c);
          const float4 wb =
              *reinterpret_cast<const float4*>(W0s + f * hp + c + 4);
          a0 = fmaf(xv, wa.x, a0);
          a1 = fmaf(xv, wa.y, a1);
          a2 = fmaf(xv, wa.z, a2);
          a3 = fmaf(xv, wa.w, a3);
          a4 = fmaf(xv, wb.x, a4);
          a5 = fmaf(xv, wb.y, a5);
          a6 = fmaf(xv, wb.z, a6);
          a7 = fmaf(xv, wb.w, a7);
        }
        const float4 va = *reinterpret_cast<const float4*>(W1s + c);
        const float4 vb = *reinterpret_cast<const float4*>(W1s + c + 4);
        per = fmaf(fmaxf(a0, 0.0f), va.x, per);
        per = fmaf(fmaxf(a1, 0.0f), va.y, per);
        per = fmaf(fmaxf(a2, 0.0f), va.z, per);
        per = fmaf(fmaxf(a3, 0.0f), va.w, per);
        per = fmaf(fmaxf(a4, 0.0f), vb.x, per);
        per = fmaf(fmaxf(a5, 0.0f), vb.y, per);
        per = fmaf(fmaxf(a6, 0.0f), vb.z, per);
        per = fmaf(fmaxf(a7, 0.0f), vb.w, per);
      }
      vs[tid] = (per + bias1) * sdf_scale * w[row0 + tid];
    }
    __syncthreads();

    if (tid < nq) {
      float s = 0.0f;
      for (int j = 0; j < k; ++j) s += vs[tid * k + j];
      out[q0 + tid] = s;
    }
    // the next tile's first barrier orders these reads of vs before its
    // writes; nothing reads xs after the barrier above
  }
}

}  // namespace

// Shared memory of one block in bytes (the wrapper checks it against the
// 48 KB a block gets without opting in to more).
extern "C" int fused_decode_smem_bytes(int d, int h) {
  const int hp = (h + HC - 1) / HC * HC;
  return static_cast<int>(sizeof(float)) *
         (d * hp + 2 * hp + THREADS * (d | 1) + THREADS);
}

extern "C" int fused_decode_launch(const void* gv, const void* w,
                                   const void* w0, const void* b0,
                                   const void* w1, const void* b1, void* out,
                                   int n, int k, int d, int h,
                                   float sdf_scale, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > THREADS || d < 1 || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = fused_decode_smem_bytes(d, h);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  static int max_blocks = 0;     // enough blocks to fill every SM
  if (max_blocks == 0) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    max_blocks = sms * 16;
  }
  const int hp = (h + HC - 1) / HC * HC;
  const int qt = THREADS / k;
  const int num_tiles = (n + qt - 1) / qt;
  const int grid = num_tiles < max_blocks ? num_tiles : max_blocks;
  const float* g = static_cast<const float*>(gv);
  const float* ww = static_cast<const float*>(w);
  const float* p0 = static_cast<const float*>(w0);
  const float* q0 = static_cast<const float*>(b0);
  const float* p1 = static_cast<const float*>(w1);
  const float* q1 = static_cast<const float*>(b1);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 11) {
    fused_decode_kernel<11><<<grid, THREADS, smem, s>>>(
        g, ww, p0, q0, p1, q1, o, n, k, d, h, hp, sdf_scale, num_tiles);
  } else {
    fused_decode_kernel<0><<<grid, THREADS, smem, s>>>(
        g, ww, p0, q0, p1, q1, o, n, k, d, h, hp, sdf_scale, num_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
