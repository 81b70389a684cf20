// The correction blocks of the bundle adjuster's SCHUR_JACOBI
// preconditioner, for Hopper (sm_90a). Built with a plain C interface and
// loaded through ctypes (theiasfm_tpu_torch/_kernels.py); the wrapper
// (corr) and its plain PyTorch version (corr_plain) are in
// sfm/ba/schur_precond.py.
//
// Per observation m, with the jacobians Jc (2x6), Ji (2xP), Jp (2x3) read
// from (F, M) rows of the matvec type and H = Hpp⁻¹[pt_m] (3x3):
//   V = [Jc | Ji]ᵀ Jp   ((6+P)x3: U = Jcᵀ Jp above, Ug = Jiᵀ Jp below)
//   T = V H
//   corr_cc[cam_m]   += T_U Uᵀ    (6x6)
//   corr_gg[group_m] += T_Ug Ugᵀ  (PxP)
// The solver then forms Scc = Hcc + λ·diag(Hcc) − corr_cc + 1e-10·I (and
// Sgg likewise) and inverts it: the exact diagonal blocks of the reduced
// camera system S.
//
// It replaces no TPU kernel: the JAX package builds these blocks with XLA
// (theiasfm_tpu/sfm/ba/bundle_adjustment.py, the preconditioner of its
// solve), and so did the port, as per-observation einsums that ran as
// batched cuBLAS GEMV and GEMM on 3x3 and 6x3 matrices and float atomics
// (index_add_) into the cameras: 438 ms an LM iteration at BAL Final's
// 29M observations, 66 ms at Venice's 5.0M, on the H100.
//
// What bounds it on this card: bytes. Read once, the inputs are 24 bf16
// jacobian values (48 bytes at P = 3) and 8 bytes of ids an observation,
// 36 bytes of Hpp⁻¹ a point, and the outputs 288 bytes a camera: 1.79 GB
// at Final, 0.53 ms at 3.35 TB/s, against some 460 operations an
// observation (13.3 GFLOP, 0.2 ms at 67 TFLOP/s). The camera sums need the
// observations in camera order, but gathering one observation's 24 values
// from the (F, M) rows by camera touches 24 separate 32-byte sectors. So
// the design is two launches over a row workspace, as pass 2 of the Schur
// product (csrc/schur_matvec.cu, csrc/schur_groups.cu) is:
//
// * Stage A (precond_obs_kernel), one observation a thread in storage
//   order, reading the rows coalesced along M (and Hpp⁻¹ nearly in order:
//   the solver's observations are sorted by point): V, T and the 21
//   upper-triangle values of T_U Uᵀ, written as one 96-byte row (padded
//   from 84) of an (M, 24) workspace. With several groups it also writes
//   the P(P+1)/2 upper values of T_Ug Ugᵀ as a row of an (M, 4⌈P(P+1)/8⌉)
//   workspace (32 bytes at P = 3); with one group they add up per block:
//   a butterfly per warp, the warps in warp order, one partial row per
//   block. Each warp stores its 32 rows through shared memory as
//   contiguous 512-byte stores: with each lane storing its own row (six
//   16-byte stores 96 bytes apart) and a grid-stride loop over 2048
//   blocks, this stage took 5.39 ms at Final's shapes on the H100, 1.86
//   ms so. About 58 bytes read and 128 written an observation at Final
//   (96 at Venice).
// * Stage B (precond_sum_kernel), one grid: 1-8 warps per camera segment
//   of the camera index (cam_order, cam_start) gather the camera's rows
//   (three full sectors each) and sum them lane by lane, then by a
//   butterfly and across the segment's warps in warp order; the group
//   segments of the group index likewise, in blocks of their own; with one
//   group, the last block adds stage A's partials in block order. Each
//   block is stored once, mirrored. About 136 bytes an observation at
//   Final (100 at Venice), gathered by random rows: 2.7 ms at Final,
//   some 1.4 TB/s. In all some 9.3 GB at Final, 4.7 ms on the H100
//   against the bound's 0.53.
//
// No atomics: every sum runs in a fixed order (the grid of stage A is
// fixed by M), so two launches on the same inputs give the same bits.
//
// Rounding follows the plain build of bundle_adjustment.py: Hpp⁻¹[pt], V
// and T are rounded to the matvec type, as the plain build rounds H9, U
// and T (Ug and Tg with one group, Wg = Ugᵀ and HWg = (Tg)ᵀ with groups,
// the same values for a symmetric Hpp⁻¹); products and sums stay in f32.
// Only the upper triangle is summed and stored mirrored: the plain
// build's two halves differ by T's rounding.
//
// The kernels allocate nothing: the wrapper hands in the indices, the
// workspaces, the outputs (each written whole) and the stream, and the
// entry point returns cudaGetLastError() for the wrapper to check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // threads per block of stage A
constexpr int kSegWarps = 8;       // warps per block of stage B
constexpr int kCamVals = 21;       // upper triangle of a 6x6 block
constexpr int kCamRow = 24;        // its row in the workspace, 96 bytes
constexpr int kMaxP = 10;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

// round an f32 value to the matvec type and back
template <typename T>
__device__ __forceinline__ float round_mv(float x);
template <>
__device__ __forceinline__ float round_mv<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_mv<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// the place of (r, c), r <= c, in an S x S upper triangle stored row by row
__host__ __device__ constexpr int upper_index(int r, int c, int S) {
  return r * S - r * (r - 1) / 2 + c - r;
}

// values of the P x P upper triangle, and their row in the group workspace
template <int P>
struct Grp {
  static constexpr int vals = P * (P + 1) / 2;
  static constexpr int row = (vals + 3) & ~3;
};

// A warp's 32 rows of R floats (R a multiple of 4), one a lane, stored as
// contiguous 16-byte stores through the warp's shared buffer: rows
// [m0, m0 + n) of out.
template <int R>
__device__ __forceinline__ void store_rows(const float* r, float4* buf,
                                           float* __restrict__ out,
                                           long long m0, int n) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
    buf[lane * (R / 4) + j] =
        make_float4(r[4 * j], r[4 * j + 1], r[4 * j + 2], r[4 * j + 3]);
  __syncwarp();
  float4* dst = reinterpret_cast<float4*>(out + m0 * R);
  for (int j = lane; j < n * (R / 4); j += 32) dst[j] = buf[j];
  __syncwarp();
}

// Stage A, one observation a thread. cam_rows (M, 24): the upper triangle
// of T_U Uᵀ, row by row, then 3 zeros. With one group, g_part (gridDim.x,
// P(P+1)/2): each block's sum of T_Ug Ugᵀ's upper triangle; else grp_rows
// (M, Grp<P>::row): the observation's upper triangle, then zeros. Each
// warp stores its rows through shared memory, 512 contiguous bytes a
// store (the group rows too where they fit the buffer, P <= 6).
template <typename T, int P, bool kOneGroup>
__global__ void __launch_bounds__(kThreads)
precond_obs_kernel(const T* __restrict__ jc, const T* __restrict__ ji,
                   const T* __restrict__ jp, long long jc_sf,
                   long long jc_sm, long long ji_sf, long long ji_sm,
                   long long jp_sf, long long jp_sm,
                   const int* __restrict__ obs_pt,
                   const float* __restrict__ hinv,
                   float* __restrict__ cam_rows,
                   float* __restrict__ grp_rows,
                   float* __restrict__ g_part, long long M) {
  constexpr int A = 6 + P;
  constexpr int G = Grp<P>::vals;
  constexpr int GR = Grp<P>::row;
  constexpr int kWarps = kThreads / 32;
  __shared__ float4 buf_s[kWarps][32 * kCamRow / 4];
  __shared__ float g_warp[kOneGroup ? kWarps : 1][G];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long m0 = (long long)blockIdx.x * kThreads + warp * 32;
  const long long m = m0 + lane;
  const int n = (int)(M - m0 < 32 ? M - m0 : 32);  // this warp's rows
  // a lane past the last observation computes the last one's values and
  // drops them
  const long long mm = m < M ? m : M - 1;
  float x[2][A], q[2][3];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int a = 0; a < 6; ++a)
      x[k][a] = load(jc, (k * 6 + a) * jc_sf + mm * jc_sm);
#pragma unroll
    for (int p = 0; p < P; ++p)
      x[k][6 + p] = load(ji, (k * P + p) * ji_sf + mm * ji_sm);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      q[k][c] = load(jp, (k * 3 + c) * jp_sf + mm * jp_sm);
  }
  const float* hp = hinv + (long long)obs_pt[mm] * 9;
  float h[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) h[i] = round_mv<T>(hp[i]);
  float v[A][3], t[A][3];
#pragma unroll
  for (int a = 0; a < A; ++a) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      v[a][c] = round_mv<T>(x[0][a] * q[0][c] + x[1][a] * q[1][c]);
  }
#pragma unroll
  for (int a = 0; a < A; ++a) {
#pragma unroll
    for (int e = 0; e < 3; ++e)
      t[a][e] = round_mv<T>(v[a][0] * h[e] + v[a][1] * h[3 + e] +
                            v[a][2] * h[6 + e]);
  }
  float d[kCamRow];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = a; b < 6; ++b)
      d[upper_index(a, b, 6)] =
          t[a][0] * v[b][0] + t[a][1] * v[b][1] + t[a][2] * v[b][2];
  }
#pragma unroll
  for (int i = kCamVals; i < kCamRow; ++i) d[i] = 0.f;
  store_rows<kCamRow>(d, buf_s[warp], cam_rows, m0, n);
  float g[GR];
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int r = p; r < P; ++r)
      g[upper_index(p, r, P)] = m < M ? t[6 + p][0] * v[6 + r][0] +
                                            t[6 + p][1] * v[6 + r][1] +
                                            t[6 + p][2] * v[6 + r][2]
                                      : 0.f;
  }
#pragma unroll
  for (int i = G; i < GR; ++i) g[i] = 0.f;
  if (!kOneGroup) {
    if (GR <= kCamRow) {
      store_rows<GR>(g, buf_s[warp], grp_rows, m0, n);
    } else if (m < M) {
      float4* grow = reinterpret_cast<float4*>(grp_rows + m * GR);
#pragma unroll
      for (int i = 0; i < GR / 4; ++i)
        grow[i] =
            make_float4(g[4 * i], g[4 * i + 1], g[4 * i + 2], g[4 * i + 3]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const float s = warp_sum(g[i]);
    if (lane == 0) g_warp[warp][i] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += g_warp[w][i];
    g_part[(long long)blockIdx.x * G + i] = s;
  }
}

// the row and column of value k of an S x S upper triangle stored row by row
__device__ __forceinline__ void upper_rc(int k, int S, int& r, int& c) {
  r = 0;
  while (k >= S - r) {
    k -= S - r;
    ++r;
  }
  c = r + k;
}

// Segment sums of F values from rows of R floats (R a multiple of 4):
// out[s] (S x S, mirrored) = Σ rows[order[i]] over i in [start[s],
// start[s + 1]). W warps per segment (W = 1, 2, 4 or 8): lane l of warp w
// takes positions l + 32w, l + 32(w + W), ...; then a butterfly per warp
// and the W warp sums in warp order. `blk` is this block's place among the
// blocks that sum these segments.
template <int F, int R, int S>
__device__ __forceinline__ void sum_segments(
    const float* __restrict__ rows, const int* __restrict__ order,
    const int* __restrict__ start, int n, int W, int blk,
    float* __restrict__ out, float (*s_warp)[F]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = warp % W;
  const int seg = blk * (kSegWarps / W) + warp / W;
  float s[F];
#pragma unroll
  for (int f = 0; f < F; ++f) s[f] = 0.f;
  if (seg < n) {
    const int lo = start[seg], hi = start[seg + 1];
#pragma unroll 4
    for (int i = lo + 32 * sub + lane; i < hi; i += 32 * W) {
      const float4* row =
          reinterpret_cast<const float4*>(rows + (long long)order[i] * R);
#pragma unroll
      for (int j = 0; j < R / 4; ++j) {
        const float4 r4 = row[j];
        const float vals[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (4 * j + c < F) s[4 * j + c] += vals[c];
      }
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float v = warp_sum(s[f]);
    if (lane == 0) s_warp[warp][f] = v;
  }
  __syncthreads();
  if (sub != 0 || seg >= n) return;
  for (int f = lane; f < F; f += 32) {
    float v = 0.f;
    for (int w = 0; w < W; ++w) v += s_warp[warp + w][f];
    int r, c;
    upper_rc(f, S, r, c);
    out[(long long)seg * S * S + r * S + c] = v;
    out[(long long)seg * S * S + c * S + r] = v;
  }
}

// Stage B: blocks [0, cam_blocks) sum the camera segments into corr_cc
// (Nc, 6, 6); the blocks after them the group segments into corr_gg
// (Ng, P, P), or, with one group, one block adds stage A's n_part
// partials in block order, one warp per value, into corr_gg (1, P, P).
template <int P, bool kOneGroup>
__global__ void __launch_bounds__(kSegWarps * 32)
precond_sum_kernel(const float* __restrict__ cam_rows,
                   const int* __restrict__ cam_order,
                   const int* __restrict__ cam_start, int Nc, int Wc,
                   int cam_blocks, const float* __restrict__ grp_rows,
                   const int* __restrict__ grp_order,
                   const int* __restrict__ grp_start, int Ng, int Wg,
                   const float* __restrict__ g_part, int n_part,
                   float* __restrict__ corr_cc, float* __restrict__ corr_gg) {
  constexpr int G = Grp<P>::vals;
  constexpr int F = G > kCamVals ? G : kCamVals;
  __shared__ float s_warp[kSegWarps][F];
  if ((int)blockIdx.x < cam_blocks) {
    sum_segments<kCamVals, kCamRow, 6>(
        cam_rows, cam_order, cam_start, Nc, Wc, blockIdx.x, corr_cc,
        reinterpret_cast<float(*)[kCamVals]>(&s_warp[0][0]));
    return;
  }
  if (!kOneGroup) {
    sum_segments<G, Grp<P>::row, P>(
        grp_rows, grp_order, grp_start, Ng, Wg, blockIdx.x - cam_blocks,
        corr_gg, reinterpret_cast<float(*)[G]>(&s_warp[0][0]));
    return;
  }
  // thread j adds the partial rows j, j + 256, ...; then a butterfly per
  // warp and the warps in warp order
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s[G];
#pragma unroll
  for (int v = 0; v < G; ++v) s[v] = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < n_part; i += kSegWarps * 32) {
#pragma unroll
    for (int v = 0; v < G; ++v) s[v] += g_part[(long long)i * G + v];
  }
#pragma unroll
  for (int v = 0; v < G; ++v) {
    const float w = warp_sum(s[v]);
    if (lane == 0) s_warp[warp][v] = w;
  }
  __syncthreads();
  for (int v = threadIdx.x; v < G; v += kSegWarps * 32) {
    float w = 0.f;
    for (int k = 0; k < kSegWarps; ++k) w += s_warp[k][v];
    int r, c;
    upper_rc(v, P, r, c);
    corr_gg[r * P + c] = w;
    corr_gg[c * P + r] = w;
  }
}

// warps per segment: enough that a lane sums about 4 rows on average
int seg_warps(int n, long long M) {
  int W = 1;
  while (W < kSegWarps && 32LL * 4 * W * n < M) W *= 2;
  return W;
}

template <typename T, int P>
int launch(const void* jc, const void* ji, const void* jp, long long jc_sf,
           long long jc_sm, long long ji_sf, long long ji_sm, long long jp_sf,
           long long jp_sm, const int* obs_pt, const float* hinv,
           const int* cam_order, const int* cam_start, const int* grp_order,
           const int* grp_start, float* cam_rows, float* grp_rows,
           float* g_part, float* corr_cc, float* corr_gg, long long M,
           int Nc, int Ng, cudaStream_t s) {
  const bool one = Ng == 1;
  const int blocks = (int)((M + kThreads - 1) / kThreads);
  if (blocks > 0) {
    if (one)
      precond_obs_kernel<T, P, true><<<blocks, kThreads, 0, s>>>(
          (const T*)jc, (const T*)ji, (const T*)jp, jc_sf, jc_sm, ji_sf,
          ji_sm, jp_sf, jp_sm, obs_pt, hinv, cam_rows, grp_rows, g_part, M);
    else
      precond_obs_kernel<T, P, false><<<blocks, kThreads, 0, s>>>(
          (const T*)jc, (const T*)ji, (const T*)jp, jc_sf, jc_sm, ji_sf,
          ji_sm, jp_sf, jp_sm, obs_pt, hinv, cam_rows, grp_rows, g_part, M);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int Wc = seg_warps(Nc, M);
  const int cam_blocks = (Nc + kSegWarps / Wc - 1) / (kSegWarps / Wc);
  const int Wg = one ? 1 : seg_warps(Ng, M);
  const int grp_blocks = one ? 1 : (Ng + kSegWarps / Wg - 1) / (kSegWarps / Wg);
  const unsigned grid = (unsigned)(cam_blocks + grp_blocks);
  if (one)
    precond_sum_kernel<P, true><<<grid, kSegWarps * 32, 0, s>>>(
        cam_rows, cam_order, cam_start, Nc, Wc, cam_blocks, grp_rows,
        grp_order, grp_start, Ng, Wg, g_part, blocks, corr_cc, corr_gg);
  else
    precond_sum_kernel<P, false><<<grid, kSegWarps * 32, 0, s>>>(
        cam_rows, cam_order, cam_start, Nc, Wc, cam_blocks, grp_rows,
        grp_order, grp_start, Ng, Wg, g_part, blocks, corr_cc, corr_gg);
  return (int)cudaGetLastError();
}

// cam_rows: M x 24 floats. With one group (Ng == 1) g_part holds at least
// ⌈M/256⌉ rows of P(P+1)/2 floats and grp_order, grp_start and
// grp_rows are not read; else grp_rows holds M rows of 4⌈P(P+1)/8⌉ floats.
template <typename T>
int dispatch(const void* jc, const void* ji, const void* jp, long long jc_sf,
             long long jc_sm, long long ji_sf, long long ji_sm,
             long long jp_sf, long long jp_sm, const int* obs_pt,
             const float* hinv, const int* cam_order, const int* cam_start,
             const int* grp_order, const int* grp_start, float* cam_rows,
             float* grp_rows, float* g_part, float* corr_cc, float* corr_gg,
             long long M, int P, int Nc, int Ng, void* stream) {
  if (P < 1 || P > kMaxP || Ng < 1 || Nc < 0 || M < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define PRECOND(PP)                                                          \
  case PP:                                                                   \
    return launch<T, PP>(jc, ji, jp, jc_sf, jc_sm, ji_sf, ji_sm, jp_sf,      \
                         jp_sm, obs_pt, hinv, cam_order, cam_start,          \
                         grp_order, grp_start, cam_rows, grp_rows, g_part,   \
                         corr_cc, corr_gg, M, Nc, Ng, s);
  switch (P) {
    PRECOND(1) PRECOND(2) PRECOND(3) PRECOND(4) PRECOND(5)
    PRECOND(6) PRECOND(7) PRECOND(8) PRECOND(9) PRECOND(10)
  }
#undef PRECOND
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int schur_precond_f32(const void* jc, const void* ji, const void* jp,
                      long long jc_sf, long long jc_sm, long long ji_sf,
                      long long ji_sm, long long jp_sf, long long jp_sm,
                      const int* obs_pt, const float* hinv,
                      const int* cam_order, const int* cam_start,
                      const int* grp_order, const int* grp_start,
                      float* cam_rows, float* grp_rows, float* g_part,
                      float* corr_cc, float* corr_gg, long long M, int P,
                      int Nc, int Ng, void* stream) {
  return dispatch<float>(jc, ji, jp, jc_sf, jc_sm, ji_sf, ji_sm, jp_sf,
                         jp_sm, obs_pt, hinv, cam_order, cam_start,
                         grp_order, grp_start, cam_rows, grp_rows, g_part,
                         corr_cc, corr_gg, M, P, Nc, Ng, stream);
}

int schur_precond_bf16(const void* jc, const void* ji, const void* jp,
                       long long jc_sf, long long jc_sm, long long ji_sf,
                       long long ji_sm, long long jp_sf, long long jp_sm,
                       const int* obs_pt, const float* hinv,
                       const int* cam_order, const int* cam_start,
                       const int* grp_order, const int* grp_start,
                       float* cam_rows, float* grp_rows, float* g_part,
                       float* corr_cc, float* corr_gg, long long M, int P,
                       int Nc, int Ng, void* stream) {
  return dispatch<__nv_bfloat16>(jc, ji, jp, jc_sf, jc_sm, ji_sf, ji_sm,
                                 jp_sf, jp_sm, obs_pt, hinv, cam_order,
                                 cam_start, grp_order, grp_start, cam_rows,
                                 grp_rows, g_part, corr_cc, corr_gg, M, P,
                                 Nc, Ng, stream);
}

}  // extern "C"
