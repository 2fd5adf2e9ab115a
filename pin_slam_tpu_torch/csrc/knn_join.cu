// Exact radius-bounded k-NN spatial join for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_knn_kernel` of
// pin_slam_tpu/ops/knn_join.py (wrapper `knn_join`). Same function, same
// tie rules, same early exit, so idx/d2/cnt agree bit for bit with the
// plain PyTorch version in pin_slam_tpu_torch/ops/knn_join.py.
//
// Inputs (prepared by the Python wrapper):
//   qs   [N, 3] f32  queries, Morton-sorted, N = 128 * n_tiles (pad 1e9)
//   lp   [L, 3] f32  Morton-sorted local set, L = 512 * n_ltiles (pad 1e9)
//   tab  [n_tiles, R] i32  candidate local tiles per query tile,
//        nearest first by bounding-box distance (-1 = none)
//   bbd  [n_tiles, R] f32  the matching bounding-box distances (BIG = none)
//   perm [N] i64  original row of each sorted query
// Outputs (row perm[q]): idx [N, K] i32 (-1 = none), d2 [N, K] f32
//   (BIG = none), cnt [N] i32 in-radius candidates seen, visits [n_tiles]
//   i32 local tiles visited by each query tile.
//
// What bounds it on this card: arithmetic, not bytes. Each visited
// (query tile, local tile) pair costs 128 x 512 distance evaluations
// (8 fp32 operations each plus a compare) against 6 KB of staged points;
// the inputs and outputs of a whole call are a few MB. The design:
//   * one block per 128-query tile, one thread per query, the running
//     top-K in registers (K <= 16, fully unrolled insertion, no local
//     memory);
//   * each visited 512-point local tile staged once in shared memory as
//     three SoA arrays, so the inner loop's loads are warp-wide broadcasts;
//   * the block reads its own row of the tile table (no scalar prefetch on
//     this card) and stops as the TPU kernel does: once the next tile's
//     bounding-box distance is not below the worst kept distance of every
//     query in the block. The loop over tiles replaces the TPU grid's
//     sequential walk; the blocks run in parallel over the 132 SMs.
// The distance is rounded exactly as XLA's CPU backend rounds the JAX
// kernel's dx*dx + dy*dy + dz*dz, fma(dz, dz, fma(dx, dx, dy*dy)), spelled
// with explicit __fmaf_rn/__fmul_rn so the compiler contracts nothing else;
// the plain version computes the same roundings, so d2 agrees bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 128;
constexpr int TL = 512;
constexpr float BIG = 9e3f;

template <int K>
__global__ void __launch_bounds__(TQ)
knn_join_kernel(const float* __restrict__ qs, const float* __restrict__ lp,
                const int* __restrict__ tab, const float* __restrict__ bbd,
                const int64_t* __restrict__ perm, int row_cap,
                float max_dist2, int* __restrict__ out_idx,
                float* __restrict__ out_d2, int* __restrict__ out_cnt,
                int* __restrict__ out_visits) {
  __shared__ float sx[TL];
  __shared__ float sy[TL];
  __shared__ float sz[TL];
  __shared__ float warp_worst[TQ / 32];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t q = (int64_t)tile * TQ + t;
  const float qx = qs[3 * q + 0];
  const float qy = qs[3 * q + 1];
  const float qz = qs[3 * q + 2];

  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = BIG;
    bi[j] = -1;
  }
  int cnt = 0;
  int r = 0;
  for (; r < row_cap; ++r) {
    // block-wide maximum of the worst kept distance
    float w = bd[K - 1];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, off));
    if (lane == 0) warp_worst[warp] = w;
    __syncthreads();
    float worst = warp_worst[0];
#pragma unroll
    for (int i = 1; i < TQ / 32; ++i) worst = fmaxf(worst, warp_worst[i]);
    const float bb = bbd[(int64_t)tile * row_cap + r];
    if (!(bb < worst)) break;  // uniform over the block

    const int pid = tab[(int64_t)tile * row_cap + r];
    const float* src = lp + (int64_t)pid * TL * 3;
    for (int e = t; e < TL * 3; e += TQ) {
      const float v = src[e];
      const int p = e / 3;
      const int c = e - 3 * p;
      if (c == 0) sx[p] = v;
      else if (c == 1) sy[p] = v;
      else sz[p] = v;
    }
    __syncthreads();

    const int base = pid * TL;
    for (int j = 0; j < TL; ++j) {
      const float dx = __fsub_rn(qx, sx[j]);
      const float dy = __fsub_rn(qy, sy[j]);
      const float dz = __fsub_rn(qz, sz[j]);
      const float d2 = __fmaf_rn(dz, dz,
                                 __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
      if (d2 <= max_dist2) {
        ++cnt;
        if (d2 < bd[K - 1]) {
          // stable insertion: the candidate goes after every kept entry of
          // equal distance (kept entries and lower columns win ties); the
          // walk runs downward so each bd[s - 1] read is still unshifted
          const int ci = base + j;
#pragma unroll
          for (int s = K - 1; s > 0; --s) {
            if (d2 < bd[s - 1]) {
              bd[s] = bd[s - 1];
              bi[s] = bi[s - 1];
            } else if (d2 < bd[s]) {
              bd[s] = d2;
              bi[s] = ci;
            }
          }
          if (d2 < bd[0]) {
            bd[0] = d2;
            bi[0] = ci;
          }
        }
      }
    }
    __syncthreads();  // the next tile overwrites sx/sy/sz and warp_worst
  }

  const int64_t row = perm[q];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    out_idx[row * K + j] = bi[j];
    out_d2[row * K + j] = bd[j];
  }
  out_cnt[row] = cnt;
  if (t == 0) out_visits[tile] = r;
}

template <int K>
cudaError_t launch(const float* qs, const float* lp, const int* tab,
                   const float* bbd, const int64_t* perm, int n_tiles,
                   int row_cap, float max_dist2, int* out_idx, float* out_d2,
                   int* out_cnt, int* out_visits, cudaStream_t stream) {
  knn_join_kernel<K><<<n_tiles, TQ, 0, stream>>>(
      qs, lp, tab, bbd, perm, row_cap, max_dist2, out_idx, out_d2, out_cnt,
      out_visits);
  return cudaGetLastError();
}

}  // namespace

extern "C" int knn_join_launch(const void* qs, const void* lp,
                               const void* tab, const void* bbd,
                               const void* perm, int n_tiles, int row_cap,
                               int k, float max_dist2, void* out_idx,
                               void* out_d2, void* out_cnt, void* out_visits,
                               void* stream) {
  if (n_tiles == 0) return 0;
  const float* q = static_cast<const float*>(qs);
  const float* l = static_cast<const float*>(lp);
  const int* tb = static_cast<const int*>(tab);
  const float* bb = static_cast<const float*>(bbd);
  const int64_t* pm = static_cast<const int64_t*>(perm);
  int* oi = static_cast<int*>(out_idx);
  float* od = static_cast<float*>(out_d2);
  int* oc = static_cast<int*>(out_cnt);
  int* ov = static_cast<int*>(out_visits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define PIN_KNN_CASE(KK) \
  case KK:               \
    return (int)launch<KK>(q, l, tb, bb, pm, n_tiles, row_cap, max_dist2, oi, od, oc, ov, s);
    PIN_KNN_CASE(1) PIN_KNN_CASE(2) PIN_KNN_CASE(3) PIN_KNN_CASE(4)
    PIN_KNN_CASE(5) PIN_KNN_CASE(6) PIN_KNN_CASE(7) PIN_KNN_CASE(8)
    PIN_KNN_CASE(9) PIN_KNN_CASE(10) PIN_KNN_CASE(11) PIN_KNN_CASE(12)
    PIN_KNN_CASE(13) PIN_KNN_CASE(14) PIN_KNN_CASE(15) PIN_KNN_CASE(16)
#undef PIN_KNN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
