// Exact radius-bounded k-NN spatial join for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_knn_kernel` of
// pin_slam_tpu/ops/knn_join.py (wrapper `knn_join`). Same function, same
// tie rules, same early exit, so idx/d2/cnt/visits agree bit for bit with
// the plain PyTorch version `_knn_walk_plain` of
// pin_slam_tpu_torch/ops/knn_join.py.
//
// Inputs (prepared by the Python wrapper):
//   qs   [N, 3] f32  queries, Morton-sorted, N = 128 * n_tiles (pad 1e9)
//   lp   [L, 3] f32  Morton-sorted local set, L = 512 * n_ltiles (pad 1e9),
//        16-byte aligned
//   tab  [n_tiles, R] i32  candidate local tiles per query tile,
//        nearest first by bounding-box distance (-1 = none)
//   bbd  [n_tiles, R] f32  the matching bounding-box distances (BIG = none)
//   perm [N] i64  original row of each sorted query
// Outputs (row perm[q]): idx [N, K] i32 (-1 = none), d2 [N, K] f32
//   (BIG = none), cnt [N] i32 in-radius candidates seen, visits [n_tiles]
//   i32 local tiles visited by each query tile.
//
// What bounds it on this card. The operations the data needs are few: a
// warp's 32 Morton-sorted queries reach few of a visited tile's 32-point
// chunks (12.5 % at the tracker's probe), and the longest row of that probe
// (28 tiles) needs 120832 distance evaluations, about 10k cycles of issue on
// one SM. But the walk of one query tile is sequential (the exact early
// exit after each tile depends on the merged top-K), so the time is set by
// the longest row's chain of per-tile steps: the threshold and its
// block-wide maximum, a barrier, the exit test, the chunk tests (warp
// reductions), the scan of the warp with the most reachable chunks, the
// merge and its barriers. The other warps wait for that scan at the merge
// barrier. Splitting a row's columns over a thread-block cluster of 2 or 4
// CTAs (a cluster barrier and merges through distributed shared memory
// each tile) made every shape slower: the scans it splits are a small part
// of a tile's steps.
//
// The design:
//   * a block of S x 128 = 512 threads serves one 128-query tile: S = 4
//     groups of 128 threads, group g scans columns [128 g, 128 g + 128) of
//     every visited local tile. Against 2 and 8 groups, 4 was as fast as 8
//     on the tracker's 128-tile probe and close to 2 on the training
//     probe's 606 tiles;
//   * most columns cannot be in radius of any query of a warp (a warp's 32
//     Morton-sorted queries sit close together): a warp skips a 32-column
//     chunk when no query of it can reach the chunk's bounding box. The
//     test is exact: the gap distance is rounded the way d2 is, and each of
//     those roundings is monotone, so the gap is <= every point's d2;
//   * a chunk is scanned in two passes: its 32 distances first, four
//     points an iteration from three 16-byte broadcast loads, without a
//     branch; then the insertions of the few columns that can enter, in
//     column order, so the insertion's branches no longer chain the
//     distances of the warp whose scan the others wait for;
//   * each thread keeps a partial top-K of its query over its own columns in
//     registers. Group 0's list IS the query's running top-K; the other
//     groups start every tile from K copies of (T, -1), T the query's K-th
//     kept distance, so they keep only d2 < T. That drops nothing: a new
//     entry needs d2 < T to enter, since kept entries win ties;
//   * after each tile the S lists are merged in log2(S) rounds through
//     shared memory, group g taking in group g + step's list (skipped when
//     no group past the first kept anything). Insertion is stable
//     (strictly-less) and the inserted list always holds the higher
//     columns, so the merged list orders by (d2, kept before new, lower
//     column first): exactly the order of the sequential insertion and of
//     the plain version's stable sort. cnt is the sum over the groups;
//   * the exit test is the TPU kernel's, once per tile: stop when the next
//     tile's bounding-box distance is not below the largest K-th distance
//     of the 128 queries;
//   * the local tiles are double-buffered in shared memory: tile r + 1 is
//     copied with 16-byte cp.async while tile r is scanned and merged (its
//     id is already in the block's row of `tab`).
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

constexpr int S = 4;              // groups of 128 threads in a block
constexpr int NT = S * TQ;
constexpr int CPG = TL / S;       // columns of a tile per group

template <int K>
constexpr int smem_bytes() {
  return 4 * (2 * TL * 3            // two local tiles, AoS
              + 2 * (S - 1) * K * TQ  // merge slots: d2 and idx
              + TQ + TQ / 32          // per-query threshold, warp maxima
              + (S - 1) * TQ);        // per-group counts
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// copy one 512-point local tile (6 KB, 16-byte aligned) into shared
// memory, asynchronously
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int tid) {
  for (int e = tid; e < TL * 3 / 4; e += NT)
    cp_async16(dst + 4 * e, src + 4 * e);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// stable insertion of (d, i), d < bd[K-1]: the entry goes after every entry
// of equal distance; the walk runs downward so each bd[s - 1] read is still
// unshifted
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d,
                                       int i) {
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (d < bd[s - 1]) {
      bd[s] = bd[s - 1];
      bi[s] = bi[s - 1];
    } else if (d < bd[s]) {
      bd[s] = d;
      bi[s] = i;
    }
  }
  if (d < bd[0]) {
    bd[0] = d;
    bi[0] = i;
  }
}

// insert the entries of a sorted list (stride TQ) that beat bd[K-1]
template <int K>
__device__ __forceinline__ void take_in(float (&bd)[K], int (&bi)[K],
                                        const float* sd, const int* si) {
  for (int j = 0; j < K; ++j) {
    const float d = sd[j * TQ];
    if (!(d < bd[K - 1])) break;  // the list is sorted: none later
    insert<K>(bd, bi, d, si[j * TQ]);
  }
}

// the squared distance, rounded as the plain version rounds it
__device__ __forceinline__ float dist2(float qx, float qy, float qz,
                                       float px, float py, float pz) {
  const float dx = __fsub_rn(qx, px);
  const float dy = __fsub_rn(qy, py);
  const float dz = __fsub_rn(qz, pz);
  return __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
}

// Scan the 32 points of one chunk (AoS, 16-byte aligned in shared memory)
// for the thread's query, columns col0..col0 + 31. d2 < lim is
// d2 <= max_dist2 and d2 < bd[K-1] in one test: lim = min(bd[K-1], the
// float after max_dist2). Pass 1 computes the 32 distances without a
// branch: it counts the in-radius ones and marks the columns below lim.
// Pass 2 takes the marked columns in order and inserts each that is still
// below lim (an insertion lowers it). lim only falls, so an unmarked
// column would have failed the test too: the insertions are those of one
// sequential pass.
template <int K>
__device__ __forceinline__ void scan_chunk(const float* C, int col0,
                                           float qx, float qy, float qz,
                                           float max_dist2, float md2_up,
                                           int& cnt, float& lim,
                                           float (&bd)[K], int (&bi)[K]) {
  unsigned enter = 0;
#pragma unroll
  for (int c = 0; c < 32; c += 4) {
    const float4 a = *reinterpret_cast<const float4*>(C + 3 * c);
    const float4 b = *reinterpret_cast<const float4*>(C + 3 * c + 4);
    const float4 e = *reinterpret_cast<const float4*>(C + 3 * c + 8);
    const float d0 = dist2(qx, qy, qz, a.x, a.y, a.z);
    const float d1 = dist2(qx, qy, qz, a.w, b.x, b.y);
    const float d2 = dist2(qx, qy, qz, b.z, b.w, e.x);
    const float d3 = dist2(qx, qy, qz, e.y, e.z, e.w);
    cnt += (d0 <= max_dist2) + (d1 <= max_dist2) + (d2 <= max_dist2) +
           (d3 <= max_dist2);
    enter |= static_cast<unsigned>((d0 < lim) | (d1 < lim) << 1 |
                                   (d2 < lim) << 2 | (d3 < lim) << 3)
             << c;
  }
  while (enter) {
    const int c = __ffs(enter) - 1;
    enter &= enter - 1;
    const float d = dist2(qx, qy, qz, C[3 * c], C[3 * c + 1], C[3 * c + 2]);
    if (d < lim) {
      insert<K>(bd, bi, d, col0 + c);
      lim = fminf(bd[K - 1], md2_up);
    }
  }
}

// a float's bits as an int that orders as the float does (no NaN)
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float from_ordered(int i) {
  return __int_as_float(i ^ ((i >> 31) & 0x7fffffff));
}

// Gap along one axis between q and the bounding box of the warp's 32
// points p (one a lane), rounded as the distance rounds. Subtraction and
// the max are monotone under round-to-nearest, so |fl(q - p)| >= the gap
// for every point.
__device__ __forceinline__ float axis_gap(float p, float q) {
  const int o = ordered(p);
  const float lo = from_ordered(__reduce_min_sync(0xffffffffu, o));
  const float hi = from_ordered(__reduce_max_sync(0xffffffffu, o));
  return fmaxf(fmaxf(__fsub_rn(lo, q), __fsub_rn(q, hi)), 0.0f);
}


// Up to k = 8 the kernel fits 64 registers a thread, so two blocks share an
// SM (the training probe's 606 query tiles fill the card in half as many
// waves); a larger k takes what it needs, one block an SM.
template <int K>
__global__ void __launch_bounds__(NT, K <= 8 ? 2 : 1)
knn_join_kernel(const float* __restrict__ qs, const float* __restrict__ lp,
                const int* __restrict__ tab, const float* __restrict__ bbd,
                const int64_t* __restrict__ perm, int row_cap,
                float max_dist2, int* __restrict__ out_idx,
                float* __restrict__ out_d2, int* __restrict__ out_cnt,
                int* __restrict__ out_visits) {
  extern __shared__ __align__(16) float smem[];
  float* pts = smem;                               // [2][TL * 3]
  float* slot_d = pts + 2 * TL * 3;                // [S-1][K][TQ]
  int* slot_i = reinterpret_cast<int*>(slot_d + (S - 1) * K * TQ);
  float* thr = reinterpret_cast<float*>(slot_i + (S - 1) * K * TQ);  // [TQ]
  float* warp_worst = thr + TQ;                    // [TQ / 32]
  int* grp_cnt = reinterpret_cast<int*>(warp_worst + TQ / 32);  // [S-1][TQ]

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int g = tid / TQ;           // column group
  const int t = tid - g * TQ;       // query within the tile
  const int lane = tid & 31;
  const float md2_up = nextafterf(max_dist2, __int_as_float(0x7f800000));
  const int64_t q = (int64_t)tile * TQ + t;
  const float qx = qs[3 * q + 0];
  const float qy = qs[3 * q + 1];
  const float qz = qs[3 * q + 2];
  const int* trow = tab + (int64_t)tile * row_cap;
  const float* brow = bbd + (int64_t)tile * row_cap;

  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = BIG;
    bi[j] = -1;
  }
  int cnt = 0;
  if (row_cap > 0 && trow[0] >= 0)
    stage_tile(pts, lp + (int64_t)trow[0] * TL * 3, tid);

  int r = 0;
  for (; r < row_cap; ++r) {
    if (g == 0) {
      // the query's K-th kept distance, and its block-wide maximum
      float w = bd[K - 1];
      thr[t] = w;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, off));
      if ((t & 31) == 0) warp_worst[t >> 5] = w;
    }
    cp_async_wait_all();   // tile r has landed (this thread's part)
    __syncthreads();       // ... every thread's part, thr and warp_worst
    float worst = warp_worst[0];
#pragma unroll
    for (int i = 1; i < TQ / 32; ++i) worst = fmaxf(worst, warp_worst[i]);
    if (!(brow[r] < worst)) break;  // uniform over the block

    // prefetch tile r + 1 into the other buffer: its last reader was the
    // scan of tile r - 1, which every thread finished before the barrier
    if (r + 1 < row_cap) {
      const int nxt = trow[r + 1];
      if (nxt >= 0)
        stage_tile(pts + ((r + 1) & 1) * TL * 3,
                   lp + (int64_t)nxt * TL * 3, tid);
    }
    if (g != 0) {
      const float T = thr[t];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        bd[j] = T;
        bi[j] = -1;
      }
    }

    const float* P = pts + (r & 1) * TL * 3 + g * CPG * 3;
    const int base = trow[r] * TL + g * CPG;
    float lim = fminf(bd[K - 1], md2_up);
    // the 32-column chunks that some query of this warp can reach: the gap
    // distance, rounded as d2 rounds (fma and the products are monotone
    // too), is <= the d2 of every point of the chunk, so a gap past
    // max_dist2 means no point of it is in radius. All chunks are tested
    // first, so their reductions overlap.
    unsigned need = 0;
#pragma unroll
    for (int ch = 0; ch < CPG / 32; ++ch) {
      const float* pl = P + 3 * (ch * 32 + lane);
      const float gx = axis_gap(pl[0], qx);
      const float gy = axis_gap(pl[1], qy);
      const float gz = axis_gap(pl[2], qz);
      const float gap2 =
          __fmaf_rn(gz, gz, __fmaf_rn(gx, gx, __fmul_rn(gy, gy)));
      if (__any_sync(0xffffffffu, gap2 <= max_dist2)) need |= 1u << ch;
    }
    while (need) {      // the chunks in column order, as the tie rule needs
      const int c0 = 32 * (__ffs(need) - 1);
      need &= need - 1;
      scan_chunk<K>(P + 3 * c0, base + c0, qx, qy, qz, max_dist2, md2_up, cnt,
                    lim, bd, bi);
    }

    // merge: group g takes in group g + step, whose columns are all higher;
    // skipped when no group past the first kept anything (most tiles after
    // the first few). An empty list is its first entry, (T, -1), which stops
    // the reader at once.
    if (__syncthreads_or(g != 0 && bi[0] >= 0)) {
#pragma unroll
      for (int step = 1; step < S; step <<= 1) {
        if ((g & (2 * step - 1)) == step) {
          float* sd = slot_d + (g - 1) * K * TQ + t;
          int* si = slot_i + (g - 1) * K * TQ + t;
          sd[0] = bd[0];
          if (bi[0] >= 0) {
#pragma unroll
            for (int j = 0; j < K; ++j) {
              sd[j * TQ] = bd[j];
              si[j * TQ] = bi[j];
            }
          }
        }
        __syncthreads();
        if ((g & (2 * step - 1)) == 0)
          take_in<K>(bd, bi, slot_d + (g + step - 1) * K * TQ + t,
                     slot_i + (g + step - 1) * K * TQ + t);
      }
    }
  }

  // every thread left the loop at the same r (the exit test is uniform)
  if (g != 0) grp_cnt[(g - 1) * TQ + t] = cnt;
  __syncthreads();
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < S - 1; ++i) cnt += grp_cnt[i * TQ + t];
    const int64_t row = perm[q];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      out_idx[row * K + j] = bi[j];
      out_d2[row * K + j] = bd[j];
    }
    out_cnt[row] = cnt;
    if (t == 0) out_visits[tile] = r;
  }
}

template <int K>
cudaError_t launch(const float* qs, const float* lp, const int* tab,
                   const float* bbd, const int64_t* perm, int n_tiles,
                   int row_cap, float max_dist2, int* out_idx, float* out_d2,
                   int* out_cnt, int* out_visits, cudaStream_t stream) {
  constexpr int smem = smem_bytes<K>();
  static bool configured = false;   // opt in to > 48 KB once per K
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        knn_join_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  knn_join_kernel<K><<<n_tiles, NT, smem, stream>>>(
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
  if ((reinterpret_cast<uintptr_t>(lp) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
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
