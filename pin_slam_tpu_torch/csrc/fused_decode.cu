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
// ragged (D = 11, one output column) for the tensor cores, whose TF32
// rounding would change the result besides, so the design aims at the fp32
// pipe. A first version with one row per thread issued two 16-byte
// shared-memory loads of W0 for every 8 fused multiply-adds, so the
// shared-memory load pipe, not the fp32 pipe, set its pace (2.9x the bound).
// This one:
//   * register tiling: each thread decodes R = 4 rows, so each pair of
//     16-byte W0 broadcasts feeds 8 * R = 32 fused multiply-adds, from 8
//     hidden units of R rows accumulated at a time in 32 registers;
//   * a tile is floor(R * 128 / k) whole queries = up to 512 consecutive
//     rows, one contiguous span of gv. The block copies that span into
//     shared memory with coalesced loads (a row is D*4 = 44 bytes, so
//     per-thread row loads from device memory would be misaligned and
//     strided); thread t takes rows t, t + 128, t + 256, t + 384 and reads
//     each at an odd stride, free of bank conflicts;
//   * W0, b0, W1 are staged in shared memory once per block, H padded with
//     zeros to a multiple of 8, and read as 16-byte warp-wide broadcasts;
//   * the sum over a query's k rows goes through shared memory, in
//     neighbour order j = 0..k-1;
//   * blocks walk the tiles with a grid stride, so the weights are staged
//     a few times per SM rather than once per tile; several blocks on an SM
//     overlap one block's staging with another's arithmetic.
// The ragged end of N is masked here; D, H, k and N are runtime values.
// Rounding: every multiply-add is an explicit fmaf (one rounding), whatever
// contraction flag the file is built with; in each row the hidden sum runs
// over the inputs in order f = 0..D-1 from the bias, the output sum over
// h = 0..H-1 from zero, then bias, scale and weight, then the k-sum over
// j = 0..k-1 from zero: the operations and their order of the one-row
// version, so the output has the same bits. The plain PyTorch version sums
// in the library's order, so the two agree to float32 rounding of the sums
// (<= 1e-5 at outputs of O(0.1)), not bit for bit.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 128;
constexpr int R = 4;               // rows per thread
constexpr int ROWS = R * THREADS;  // rows per tile
constexpr int HC = 8;              // hidden units accumulated at a time

// DT > 0: the input width is the compile-time DT and the rows sit in
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
  float* xs = W1s + hp;              // [ROWS][ds]
  float* vs = xs + ROWS * ds;        // [ROWS]
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
  const int qt = ROWS / k;           // whole queries per tile

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

    // this thread's rows tid + i * THREADS; a row past the tile's end is
    // computed from stale shared memory and never stored
    float x[R][DT > 0 ? DT : 1];
    if (DT > 0) {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int f = 0; f < (DT > 0 ? DT : 1); ++f)
          x[i][f] = xs[(tid + i * THREADS) * ds + f];
    }
    float per[R];
#pragma unroll
    for (int i = 0; i < R; ++i) per[i] = 0.0f;
    for (int c = 0; c < hp; c += HC) {
      const float4 ba = *reinterpret_cast<const float4*>(b0s + c);
      const float4 bb = *reinterpret_cast<const float4*>(b0s + c + 4);
      float a[R][HC];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        a[i][0] = ba.x; a[i][1] = ba.y; a[i][2] = ba.z; a[i][3] = ba.w;
        a[i][4] = bb.x; a[i][5] = bb.y; a[i][6] = bb.z; a[i][7] = bb.w;
      }
#pragma unroll
      for (int f = 0; f < (DT > 0 ? DT : d); ++f) {
        const float4 wa = *reinterpret_cast<const float4*>(W0s + f * hp + c);
        const float4 wb =
            *reinterpret_cast<const float4*>(W0s + f * hp + c + 4);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float xv =
              DT > 0 ? x[i][DT > 0 ? f : 0] : xs[(tid + i * THREADS) * ds + f];
          a[i][0] = fmaf(xv, wa.x, a[i][0]);
          a[i][1] = fmaf(xv, wa.y, a[i][1]);
          a[i][2] = fmaf(xv, wa.z, a[i][2]);
          a[i][3] = fmaf(xv, wa.w, a[i][3]);
          a[i][4] = fmaf(xv, wb.x, a[i][4]);
          a[i][5] = fmaf(xv, wb.y, a[i][5]);
          a[i][6] = fmaf(xv, wb.z, a[i][6]);
          a[i][7] = fmaf(xv, wb.w, a[i][7]);
        }
      }
      const float4 va = *reinterpret_cast<const float4*>(W1s + c);
      const float4 vb = *reinterpret_cast<const float4*>(W1s + c + 4);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        per[i] = fmaf(fmaxf(a[i][0], 0.0f), va.x, per[i]);
        per[i] = fmaf(fmaxf(a[i][1], 0.0f), va.y, per[i]);
        per[i] = fmaf(fmaxf(a[i][2], 0.0f), va.z, per[i]);
        per[i] = fmaf(fmaxf(a[i][3], 0.0f), va.w, per[i]);
        per[i] = fmaf(fmaxf(a[i][4], 0.0f), vb.x, per[i]);
        per[i] = fmaf(fmaxf(a[i][5], 0.0f), vb.y, per[i]);
        per[i] = fmaf(fmaxf(a[i][6], 0.0f), vb.z, per[i]);
        per[i] = fmaf(fmaxf(a[i][7], 0.0f), vb.w, per[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = tid + i * THREADS;
      if (row < nrows) vs[row] = (per[i] + bias1) * sdf_scale * w[row0 + row];
    }
    __syncthreads();

    for (int qq = tid; qq < nq; qq += THREADS) {
      float s = 0.0f;
      for (int j = 0; j < k; ++j) s += vs[qq * k + j];
      out[q0 + qq] = s;
    }
    // the next tile's first barrier orders these reads of vs before its
    // writes; every read of xs came before the barrier above
  }
}

}  // namespace

// Shared memory of one block in bytes (the wrapper checks it against the
// 48 KB a block gets without opting in to more).
extern "C" int fused_decode_smem_bytes(int d, int h) {
  const int hp = (h + HC - 1) / HC * HC;
  return static_cast<int>(sizeof(float)) *
         (d * hp + 2 * hp + ROWS * (d | 1) + ROWS);
}

extern "C" int fused_decode_launch(const void* gv, const void* w,
                                   const void* w0, const void* b0,
                                   const void* w1, const void* b1, void* out,
                                   int n, int k, int d, int h,
                                   float sdf_scale, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > ROWS || d < 1 || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = fused_decode_smem_bytes(d, h);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = d == 11 ? fused_decode_kernel<11>
                              : fused_decode_kernel<0>;
  // as many blocks as are resident at once, so that every block walks
  // about the same number of tiles
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int max_blocks = sms * (per_sm > 0 ? per_sm : 1);
  const int hp = (h + HC - 1) / HC * HC;
  const int qt = ROWS / k;
  const int num_tiles = (n + qt - 1) / qt;
  const int grid = num_tiles < max_blocks ? num_tiles : max_blocks;
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gv), static_cast<const float*>(w),
      static_cast<const float*>(w0), static_cast<const float*>(b0),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<float*>(out), n, k, d, h, hp, sdf_scale, num_tiles);
  return static_cast<int>(cudaGetLastError());
}
