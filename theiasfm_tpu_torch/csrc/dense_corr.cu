// The dense Schur solver's correction blocks, for Hopper (sm_90a). Built with
// a plain C interface and loaded through ctypes (theiasfm_tpu_torch/
// _kernels.py); the wrapper (corr), its plain PyTorch version (corr_plain)
// and the solve-start layout it reads (pair_layout) are in
// sfm/ba/dense_corr.py.
//
// For every ordered pair (k, l) of observations of one point (k == l
// included), with U = Jcᵀ Jp (6x3), Ug = Jiᵀ Jp (Px3), T = U Hpp⁻¹[pt],
// Tg = Ug Hpp⁻¹[pt]:
//   corr_cc[cam k, cam l]   += T_k U_lᵀ    (6x6)
//   corr_cg[cam k, grp l]   += T_k Ug_lᵀ   (6xP)
//   corr_gg[grp k, grp l]   += Tg_k Ug_lᵀ  (PxP)
// and Hcg[cam, grp] = Σ Jcᵀ Ji over each camera's valid observations.
//
// It replaces no TPU kernel. The JAX package forms these blocks with XLA
// on the TPU, through scatter-free camera-pair gather tables (in
// theiasfm_tpu/sfm/ba/bundle_adjustment.py, a workaround for the TPU's
// slow scatters); the port's plain build, _dense_schur_corr, gathers the
// blocks of all pairs, forms them by batched 6x3·3x6 cuBLAS products that
// waste almost all of each launch, and index_add_s them onto Nc² rows.
//
// What bounds it on this card: bytes. At BAL Dubrovnik-356 (1.26M
// observations, 7.75M pairs, 356 cameras and groups, P = 3) the least
// traffic is the jacobians, ids and Hpp⁻¹ in and the four tables out, some
// 185 MB, 0.055 ms at 3.35 TB/s, against 2.9 GFLOP (0.044 ms at 67 TFLOP/s
// f32). The design moves more bytes than that and keeps every pair block
// out of device memory:
//
// * dense_corr_obs_kernel, one observation a thread: the rows [T | Tg] and
//   [U | Ug] (18 + 3P values, padded to 4) into two (M, W) tables, 2 x 112
//   B an observation at P = 3 (282 MB written at Dubrovnik), staged in
//   shared memory so that a warp writes whole lines.
// * dense_corr_hcg_kernel, one block a camera: Jcᵀ Ji summed over the
//   camera's valid observations (the layout's camera order), a butterfly a
//   warp and the warps in order; the camera's row of Hcg is written whole,
//   zero outside its group.
// * dense_corr_pairs_kernel, one warp a chunk of at most 256 pairs of one
//   camera-pair segment (dense_corr.CHUNK): each lane sums the three blocks
//   of its pairs in registers (36 + 6P + P² values), then a reduce-scatter
//   butterfly over the warp leaves each lane R = N / 32 of the N (padded)
//   sums, which it stores once: one partial row a chunk, never a pair
//   block. Per pair a lane reads two ids and two table rows, 232 B (1.8 GB
//   at Dubrovnik, much of it from L2: ordering the segments in tiles of
//   8 to 128 cameras a side moved the build by at most 7%).
// * dense_corr_sum_kernel, one warp an output row, lanes over its columns:
//   corr_cc as each segment's chunk partials summed in chunk order; then
//   corr_cg and, for corr_gg, its blocks summed over b, as the partials of
//   the segments (a, b) summed over the cameras b of each group in group
//   order.
// * dense_corr_gg_kernel, one warp an output row: corr_gg as those rows
//   summed over the cameras a of each group in group order.
//
// Every sum is taken in a fixed order in f32 from f32 products, with no
// atomics, so two launches on the same inputs give the same bits. The
// kernels allocate nothing: the wrapper hands in the layout, the outputs
// (each written whole), the scratch (the two tables, the chunk partials,
// the camera-group rows of corr_gg) and the stream, and the entry point
// returns cudaGetLastError() for the wrapper to check.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxP = 10;
constexpr int kObsThreads = 128;  // observations per block of the tables
constexpr int kHcgThreads = 256;
constexpr int kPairWarps = 4;  // chunks per block of the pair kernel
constexpr int kSumWarps = 8;   // output rows per block of the sums
constexpr int kMaxCols = 5;    // columns a lane of the sums takes
static_assert(6 * kMaxP + kMaxP * kMaxP <= 32 * kMaxCols,
              "a row of corr_cg and corr_gg's blocks fits a warp's columns");

// values in a row of the per-observation tables, and in a chunk partial
__host__ __device__ constexpr int row_width(int P) {
  return (18 + 3 * P + 3) / 4 * 4;
}
__host__ __device__ constexpr int part_width(int P) {
  return (36 + 6 * P + P * P + 31) / 32 * 32;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Reduce-scatter over a warp of N values a lane (N a multiple of 32): at
// each step a lane keeps half its values, adds its partner's copy of that
// half and hands over the other. After the five steps lane L holds the
// warp's sums of the values [R·L, R·L + R), R = N / 32, in v[0, R).
template <int N, int kOff>
struct Butterfly {
  __device__ __forceinline__ static void run(float* v, int lane) {
    constexpr int n = N / 2;
    const bool upper = lane & kOff;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = upper ? v[i] : v[i + n];
      const float keep = upper ? v[i + n] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, kOff);
    }
    Butterfly<n, kOff / 2>::run(v, lane);
  }
};
template <int N>
struct Butterfly<N, 0> {
  __device__ __forceinline__ static void run(float*, int) {}
};

// Stores the block's rows (n of them, W values each, row i at s_row[i * (W +
// 1)]) to out, whose rows are contiguous: thread j stores the values j, j +
// kObsThreads, ... of the block's n W values, so a warp stores 128
// consecutive bytes.
template <int W>
__device__ __forceinline__ void store_rows(const float* s_row, float* out,
                                           int n) {
  for (int i = threadIdx.x; i < n * W; i += kObsThreads)
    out[i] = s_row[(i / W) * (W + 1) + i % W];
}

// [T | Tg] into tk and [U | Ug] into ul, one observation a thread, a block
// of kObsThreads consecutive observations: each thread's rows go through
// shared memory, so that the tables are written in whole lines.
template <int P>
__global__ void __launch_bounds__(kObsThreads)
dense_corr_obs_kernel(const float* __restrict__ jc,
                      const float* __restrict__ ji,
                      const float* __restrict__ jp,
                      const float* __restrict__ hinv,
                      const int* __restrict__ obs_pt, float* __restrict__ tk,
                      float* __restrict__ ul, long long M) {
  constexpr int W = row_width(P);
  __shared__ float s_row[kObsThreads * (W + 1)];
  const long long m0 = (long long)blockIdx.x * kObsThreads;
  const long long m = m0 + threadIdx.x;
  const int n = (int)(M - m0 < kObsThreads ? M - m0 : kObsThreads);
  float u[W], t[W];
#pragma unroll
  for (int f = 0; f < W; ++f) u[f] = t[f] = 0.f;
  if (m < M) {
    float c[12], g[2 * P], q[6], h[9];
#pragma unroll
    for (int f = 0; f < 12; ++f) c[f] = jc[m * 12 + f];
#pragma unroll
    for (int f = 0; f < 2 * P; ++f) g[f] = ji[m * 2 * P + f];
#pragma unroll
    for (int f = 0; f < 6; ++f) q[f] = jp[m * 6 + f];
    const long long pt = obs_pt[m];
#pragma unroll
    for (int f = 0; f < 9; ++f) h[f] = hinv[pt * 9 + f];
    // U's 6 rows then Ug's P rows, each a sum over the two residual rows
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int e = 0; e < 3; ++e)
        u[a * 3 + e] = c[a] * q[e] + c[6 + a] * q[3 + e];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int e = 0; e < 3; ++e)
        u[18 + p * 3 + e] = g[p] * q[e] + g[P + p] * q[3 + e];
#pragma unroll
    for (int r = 0; r < 6 + P; ++r)
#pragma unroll
      for (int e = 0; e < 3; ++e)
        t[r * 3 + e] = u[r * 3] * h[e] + u[r * 3 + 1] * h[3 + e] +
                       u[r * 3 + 2] * h[6 + e];
  }
  float* mine = s_row + threadIdx.x * (W + 1);
#pragma unroll
  for (int f = 0; f < W; ++f) mine[f] = t[f];
  __syncthreads();
  store_rows<W>(s_row, tk + m0 * W, n);
  __syncthreads();
#pragma unroll
  for (int f = 0; f < W; ++f) mine[f] = u[f];
  __syncthreads();
  store_rows<W>(s_row, ul + m0 * W, n);
}

// Hcg, one block a camera: its valid observations cam_order[cam_start[a],
// cam_start[a + 1]) strided over the threads, a butterfly a warp, the warps
// summed in order. The row a of Hcg (Ng x 6P) is written whole.
template <int P>
__global__ void __launch_bounds__(kHcgThreads)
dense_corr_hcg_kernel(const float* __restrict__ jc,
                      const float* __restrict__ ji,
                      const int* __restrict__ cam_order,
                      const int* __restrict__ cam_start,
                      const int* __restrict__ cam_group,
                      float* __restrict__ hcg, int Ng) {
  constexpr int F = 6 * P;
  constexpr int kWarps = kHcgThreads / 32;
  __shared__ float s_warp[kWarps][F];
  const int a = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s[F];
#pragma unroll
  for (int f = 0; f < F; ++f) s[f] = 0.f;
  const int hi = cam_start[a + 1];
  for (int i = cam_start[a] + threadIdx.x; i < hi; i += kHcgThreads) {
    const long long m = cam_order[i];
    float c[12], g[2 * P];
#pragma unroll
    for (int f = 0; f < 12; ++f) c[f] = jc[m * 12 + f];
#pragma unroll
    for (int f = 0; f < 2 * P; ++f) g[f] = ji[m * 2 * P + f];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int p = 0; p < P; ++p)
        s[r * P + p] += c[r] * g[p] + c[6 + r] * g[P + p];
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float v = warp_sum(s[f]);
    if (lane == 0) s_warp[warp][f] = v;
  }
  __syncthreads();
  const int grp = cam_group[a];
  float* row = hcg + (long long)a * Ng * F;
  for (int f = threadIdx.x; f < Ng * F; f += kHcgThreads) {
    float v = 0.f;
    if (f / F == grp)
      for (int w = 0; w < kWarps; ++w) v += s_warp[w][f % F];
    row[f] = v;
  }
}

// One warp a chunk, the pairs [chunk_lo[c], chunk_lo[c + 1]): their three
// blocks summed in registers (a lane takes every 32nd pair), the butterfly,
// one partial row of N values stored (zeros for an empty chunk).
template <int P>
__global__ void __launch_bounds__(kPairWarps * 32)
dense_corr_pairs_kernel(const float* __restrict__ tk,
                        const float* __restrict__ ul,
                        const int* __restrict__ pk, const int* __restrict__ pl,
                        const int* __restrict__ chunk_lo,
                        float* __restrict__ part, int C) {
  constexpr int W = row_width(P), N = part_width(P), R = N / 32;
  constexpr int kCG = 36, kGG = 36 + 6 * P;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kPairWarps + (threadIdx.x >> 5);
  if (c >= C) return;
  const int lo = chunk_lo[c], hi = chunk_lo[c + 1];
  float v[N];
#pragma unroll
  for (int f = 0; f < N; ++f) v[f] = 0.f;
  for (int i = lo + lane; i < hi; i += 32) {
    const float4* trow =
        reinterpret_cast<const float4*>(tk + (long long)pk[i] * W);
    const float4* urow =
        reinterpret_cast<const float4*>(ul + (long long)pl[i] * W);
    float t[W], u[W];
#pragma unroll
    for (int f = 0; f < W / 4; ++f) {
      const float4 a = trow[f], b = urow[f];
      t[4 * f] = a.x;
      t[4 * f + 1] = a.y;
      t[4 * f + 2] = a.z;
      t[4 * f + 3] = a.w;
      u[4 * f] = b.x;
      u[4 * f + 1] = b.y;
      u[4 * f + 2] = b.z;
      u[4 * f + 3] = b.w;
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        float& x = v[a * 6 + b];
        x = fmaf(t[a * 3], u[b * 3], x);
        x = fmaf(t[a * 3 + 1], u[b * 3 + 1], x);
        x = fmaf(t[a * 3 + 2], u[b * 3 + 2], x);
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float& x = v[kCG + a * P + p];
        x = fmaf(t[a * 3], u[18 + p * 3], x);
        x = fmaf(t[a * 3 + 1], u[18 + p * 3 + 1], x);
        x = fmaf(t[a * 3 + 2], u[18 + p * 3 + 2], x);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float& x = v[kGG + p * P + q];
        x = fmaf(t[18 + p * 3], u[18 + q * 3], x);
        x = fmaf(t[18 + p * 3 + 1], u[18 + q * 3 + 1], x);
        x = fmaf(t[18 + p * 3 + 2], u[18 + q * 3 + 2], x);
      }
  }
  Butterfly<N, 16>::run(v, lane);
  float* row = part + (long long)c * N + R * lane;
#pragma unroll
  for (int r = 0; r < R; ++r) row[r] = v[r];
}

// One warp an output row r = x·Y + y, lanes over its F columns: the chunk
// partials' columns [col0, col0 + F) summed over the segments x·Nc + b, b =
// order[j] for j in [start[y], start[y + 1]) (b = y alone where order is
// null), each segment's chunks in order. Columns [0, F1) go to out1 (rows
// of F1), the rest to out2 (rows of F - F1).
__global__ void __launch_bounds__(kSumWarps * 32)
dense_corr_sum_kernel(const float* __restrict__ part, int N, int col0, int F,
                      int F1, const int* __restrict__ order,
                      const int* __restrict__ start,
                      const int* __restrict__ chunk_start,
                      float* __restrict__ out1, float* __restrict__ out2,
                      int X, int Y, int Nc) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  if (r >= (long long)X * Y) return;
  const int x = (int)(r / Y), y = (int)(r % Y);
  const int j0 = order ? start[y] : y, j1 = order ? start[y + 1] : y + 1;
  float acc[kMaxCols];
#pragma unroll
  for (int q = 0; q < kMaxCols; ++q) acc[q] = 0.f;
  for (int j = j0; j < j1; ++j) {
    const int s = x * Nc + (order ? order[j] : j);
    const int c1 = chunk_start[s + 1];
    for (int c = chunk_start[s]; c < c1; ++c) {
      const float* row = part + (long long)c * N + col0;
#pragma unroll
      for (int q = 0; q < kMaxCols; ++q)
        if (lane + 32 * q < F) acc[q] += row[lane + 32 * q];
    }
  }
#pragma unroll
  for (int q = 0; q < kMaxCols; ++q) {
    const int f = lane + 32 * q;
    if (f < F1)
      out1[r * F1 + f] = acc[q];
    else if (f < F)
      out2[r * (F - F1) + f - F1] = acc[q];
  }
}

// One warp an output row (g1, g2) of corr_gg (F = P² columns): the rows
// (a, g2) of ygg summed over a = order[i], i in [start[g1], start[g1 + 1]).
__global__ void __launch_bounds__(kSumWarps * 32)
dense_corr_gg_kernel(const float* __restrict__ ygg,
                     const int* __restrict__ order,
                     const int* __restrict__ start, float* __restrict__ gg,
                     int Ng, int F) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  if (r >= (long long)Ng * Ng) return;
  const int g1 = (int)(r / Ng), g2 = (int)(r % Ng);
  float acc[kMaxCols];
#pragma unroll
  for (int q = 0; q < kMaxCols; ++q) acc[q] = 0.f;
  const int i1 = start[g1 + 1];
  for (int i = start[g1]; i < i1; ++i) {
    const float* row = ygg + ((long long)order[i] * Ng + g2) * F;
#pragma unroll
    for (int q = 0; q < kMaxCols; ++q)
      if (lane + 32 * q < F) acc[q] += row[lane + 32 * q];
  }
#pragma unroll
  for (int q = 0; q < kMaxCols; ++q)
    if (lane + 32 * q < F) gg[r * F + lane + 32 * q] = acc[q];
}

unsigned blocks_for(long long n, int per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}

template <int P>
int launch(const float* jc, const float* ji, const float* jp,
           const float* hinv, const int* obs_pt, const int* pk, const int* pl,
           const int* chunk_start, const int* chunk_lo, const int* cam_order,
           const int* cam_start, const int* cam_group, const int* grp_order,
           const int* grp_start, float* tk, float* ul, float* part,
           float* ygg, float* corr_cc, float* corr_cg, float* corr_gg,
           float* hcg, long long M, int Nc, int Ng, int C, cudaStream_t s) {
  constexpr int N = part_width(P);
  cudaError_t err;
  if (M > 0) {
    dense_corr_obs_kernel<P><<<blocks_for(M, kObsThreads), kObsThreads, 0,
                               s>>>(jc, ji, jp, hinv, obs_pt, tk, ul, M);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  dense_corr_hcg_kernel<P><<<Nc, kHcgThreads, 0, s>>>(
      jc, ji, cam_order, cam_start, cam_group, hcg, Ng);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dense_corr_pairs_kernel<P><<<blocks_for(C, kPairWarps), kPairWarps * 32, 0,
                               s>>>(tk, ul, pk, pl, chunk_lo, part, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dense_corr_sum_kernel<<<blocks_for((long long)Nc * Nc, kSumWarps),
                          kSumWarps * 32, 0, s>>>(
      part, N, 0, 36, 36, nullptr, nullptr, chunk_start, corr_cc, nullptr,
      Nc, Nc, Nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dense_corr_sum_kernel<<<blocks_for((long long)Nc * Ng, kSumWarps),
                          kSumWarps * 32, 0, s>>>(
      part, N, 36, 6 * P + P * P, 6 * P, grp_order, grp_start, chunk_start,
      corr_cg, ygg, Nc, Ng, Nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dense_corr_gg_kernel<<<blocks_for((long long)Ng * Ng, kSumWarps),
                         kSumWarps * 32, 0, s>>>(ygg, grp_order, grp_start,
                                                 corr_gg, Ng, P * P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dense_corr_f32(const float* jc, const float* ji, const float* jp,
                   const float* hinv, const int* obs_pt, const int* pk,
                   const int* pl, const int* chunk_start, const int* chunk_lo,
                   const int* cam_order, const int* cam_start,
                   const int* cam_group, const int* grp_order,
                   const int* grp_start, float* tk, float* ul, float* part,
                   float* ygg, float* corr_cc, float* corr_cg, float* corr_gg,
                   float* hcg, long long M, int P, int Nc, int Ng, int C,
                   void* stream) {
  if (Nc < 1 || Ng < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(PP)                                                         \
  case PP:                                                                 \
    return launch<PP>(jc, ji, jp, hinv, obs_pt, pk, pl, chunk_start,       \
                      chunk_lo, cam_order, cam_start, cam_group,           \
                      grp_order, grp_start, tk, ul, part, ygg, corr_cc,    \
                      corr_cg, corr_gg, hcg, M, Nc, Ng, C, s);
  switch (P) {
    LAUNCH(1) LAUNCH(2) LAUNCH(3) LAUNCH(4) LAUNCH(5)
    LAUNCH(6) LAUNCH(7) LAUNCH(8) LAUNCH(9) LAUNCH(10)
  }
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
