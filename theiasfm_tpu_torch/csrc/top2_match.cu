// Fused brute-force descriptor matching for Hopper (sm_90a): for every
// query row, a running top-2 of the squared distance to the keys, without
// materialising the distance matrix. Built with a plain C interface and
// loaded through ctypes (theiasfm_tpu_torch/_kernels.py); the wrapper and
// its plain PyTorch version are in matching/fused_matcher.py.
//
//   dist[b, m, n] = n2[b, n] − 2·d1[b, m, :]·d2[b, n, :]
//   best[b, m]    = min_n dist,   idx[b, m] = the lowest n attaining it
//   second[b, m]  = the second smallest value of the multiset over n
//
// (‖a‖² is added back by the wrapper, outside the kernel, as on the TPU.)
//
// top2_match replaces both Pallas kernels of
// theiasfm_tpu/matching/pallas_matcher.py: _match_kernel (:30, called by
// _pallas_top2 at :82) and _match_kernel_batched (:120, called by
// _pallas_top2_batched at :159). It takes (B, M, D) queries, (B, N, D)
// keys and (B, N) key norms; the unbatched matcher is B = 1.
//
// What bounds it on this card: operations. It does 2·B·M·N·D float32
// operations (one FMA per product term) and must move only the
// descriptors in and three (B, M) arrays out. At the front end's shape
// (B = 28 pairs, M = N = 2048, D = 128) that is 30.1 GFLOP, 0.449 ms at
// the H100 SXM's published 67 TFLOP/s of float32 outside the tensor
// cores, against 58.7 MB, 17.5 µs at 3.35 TB/s. The ratio test needs
// the same distances as the CPU reference, so products and sums are
// float32 FFMA, not TF32 tensor-core work.
//
// Design (simple and right first; wgmma/TMA schemes that keep float32
// answers are later work):
// * The TPU kernel carries the running top-2 in VMEM scratch across a
//   sequential grid axis over key tiles. Here one block owns 64 query
//   rows of one pair and loops over all key tiles itself, so nothing is
//   carried between blocks and no second pass is needed.
// * Per 128-key tile the block stages 32-deep slices of the query and
//   key tiles in shared memory (transposed, so a thread reads 4 queries
//   and 2×4 keys as float4) and each of its 256 threads accumulates a
//   4×8 register tile of dot products in FFMA: 32 FMAs per 3 shared
//   loads. Ragged M, N and D are loaded as zeros.
// * Each thread then folds its 4×8 candidates into a running (best,
//   second, idx) per query. Its keys arrive in increasing index order,
//   so a strict < keeps the lowest index among equal distances, and a
//   duplicate of the best becomes the second. Keys past N are never
//   candidates.
// * At the end the 16 threads that share a query row merge their
//   partials with warp shuffles: (best, idx) lexicographically, so the
//   lowest index wins a tie across threads too, and
//   second = min(max(b1, b2), min(s1, s2)), the TPU's rule (:67-68).
//
// The kernel allocates nothing: the wrapper hands in the outputs and the
// stream (PyTorch's current stream), and the entry point returns
// cudaGetLastError() for the wrapper to check. B is the grid's y
// dimension, so at most 65,535 pairs per launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;    // query rows per block
constexpr int kBN = 128;   // keys per tile
constexpr int kBK = 32;    // depth per shared-memory stage
constexpr int kLdA = kBM + 4;   // padded rows keep float4 alignment
constexpr int kLdB = kBN + 4;
constexpr unsigned kFull = 0xffffffffu;

struct Top2 {
  float best, second;
  int idx;
};

// One candidate; candidates come in increasing key order.
__device__ __forceinline__ void push(Top2& t, float d, int j) {
  if (d < t.best) {
    t.second = t.best;
    t.best = d;
    t.idx = j;
  } else if (d < t.second) {
    t.second = d;
  }
}

// Another partial over a disjoint set of keys.
__device__ __forceinline__ void merge(Top2& t, float b, float s, int i) {
  t.second = fminf(fmaxf(t.best, b), fminf(t.second, s));
  if (b < t.best || (b == t.best && i < t.idx)) {
    t.best = b;
    t.idx = i;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
top2_match_kernel(const float* __restrict__ d1, const float* __restrict__ d2,
                  const float* __restrict__ n2, float* __restrict__ best,
                  float* __restrict__ second, int* __restrict__ idx, int M,
                  int N, int D) {
  __shared__ __align__(16) float As[kBK][kLdA];
  __shared__ __align__(16) float Bs[kBK][kLdB];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // key group: keys 4tx..4tx+3 and 64+4tx..+3
  const int ty = tid / 16;  // query group: rows 4ty..4ty+3
  const int m0 = blockIdx.x * kBM;
  const long long b = blockIdx.y;
  const float* A = d1 + b * M * D;
  const float* K = d2 + b * N * D;
  const float* nk = n2 + b * N;

  Top2 top[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) top[i] = {__int_as_float(0x7f800000),
                                        __int_as_float(0x7f800000), 0};

  for (int n0 = 0; n0 < N; n0 += kBN) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += kBK) {
      // a warp reads kBK consecutive floats of one row (coalesced) and
      // stores them down a column of the transposed tile
#pragma unroll
      for (int e = 0; e < kBM * kBK / kThreads; ++e) {
        const int f = tid + e * kThreads;
        const int r = f / kBK, c = f % kBK;
        const int m = m0 + r, k = k0 + c;
        As[c][r] = (m < M && k < D) ? A[(long long)m * D + k] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < kBN * kBK / kThreads; ++e) {
        const int f = tid + e * kThreads;
        const int r = f / kBK, c = f % kBK;
        const int n = n0 + r, k = k0 + c;
        Bs[c][r] = (n < N && k < D) ? K[(long long)n * D + k] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 p = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float4 q =
            *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (key < N) {
        const float nn = nk[key];
#pragma unroll
        for (int i = 0; i < 4; ++i) push(top[i], nn - 2.f * acc[i][j], key);
      }
    }
  }

  // the 16 lanes of a half-warp share ty: butterfly within the half
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(kFull, top[i].best, off);
      const float os = __shfl_xor_sync(kFull, top[i].second, off);
      const int oi = __shfl_xor_sync(kFull, top[i].idx, off);
      merge(top[i], ob, os, oi);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m < M) {
        const long long o = b * M + m;
        best[o] = top[i].best;
        second[o] = top[i].second;
        idx[o] = top[i].idx;
      }
    }
  }
}

}  // namespace

extern "C" {

// d1 (B, M, D), d2 (B, N, D), n2 (B, N) contiguous float32; best,
// second (B, M) float32 and idx (B, M) int32 out.
int top2_match_f32(const float* d1, const float* d2, const float* n2,
                   float* best, float* second, int* idx, int B, int M, int N,
                   int D, void* stream) {
  if (B <= 0 || M <= 0) return 0;
  const dim3 grid((M + kBM - 1) / kBM, B);
  top2_match_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      d1, d2, n2, best, second, idx, M, N, D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
