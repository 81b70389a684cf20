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
// Precision: split TF32 on the tensor cores. Each float32 operand x is
// split into hi = tf32(x), rounded to nearest, and lo = x − hi (exact),
// and a·b ≈ hi·hi + hi·lo + lo·hi with float32 accumulation; the dropped
// lo·lo term and the bits of lo below TF32's (the tensor core truncates
// them) leave about 2^-21 of each product. One TF32 product (about
// 2^-11) errs by some 3e-4 in best/second on unit-norm SIFT rows, beyond
// the matcher's 1e-5 of the largest entry; the split stays near 2e-6 in
// a CPU emulation (tests/test_torch_matcher.py shows both) and near 4e-6
// on the H100, whose own float32 accumulation adds the rest. Clearing
// hi's low bits instead of rounding, or leaving hi to the tensor core's
// truncation, measured 7e-6 there (1.2e-5 at D = 256): too close.
//
// What bounds it on this card: operations, for the tensor cores. The
// three products are 3·2·B·M·N·D TF32 operations; at the front end's
// shape (B = 28 pairs, M = N = 2048, D = 128) that is 90.2 GFLOP, 0.182
// ms at the H100 SXM's published 495 TFLOP/s of dense TF32, against
// 58.7 MB of descriptors in and three (B, M) arrays out, 17.5 µs at
// 3.35 TB/s. The kernel is far from that bound: what holds it back (from
// variants timed on the card) is the staging, not the tensor cores.
// Every CTA copies and splits its query rows again for every key tile
// and its key rows again for every query block, about 0.9 GB from L2 at
// the front end's shape; in an earlier version, dropping the copies or
// the split each saved a third of the time, dropping the wgmmas a tenth.
//
// Design:
// * A CTA is two warpgroups (256 threads), each owning 64 query rows of
//   one pair, so the running top-2 never leaves registers (the TPU
//   carried it in VMEM across a sequential grid axis); they share each
//   staged key tile. The two CTAs of a cluster share a block of 128
//   query rows and take half the key tiles (128 keys each) each; rank 1
//   hands its rows' top-2 to rank 0 through distributed shared memory,
//   and rank 0 merges and stores them. (One warpgroup per CTA, or no
//   cluster, measured slower at both the front end's shape and 8192².)
// * The (key tile, 16-deep chunk) sequence streams through a ring of
//   kStages shared-memory stages. cp.async copies the raw float32 query
//   and key rows of a chunk straight into wgmma's no-swizzle K-major
//   layout (8-row core matrices of 16 bytes per row), kStages − 2 chunks
//   ahead of the one being multiplied; ragged M, N and D are zero-filled
//   by the copy itself (src-size 0).
// * When a chunk has landed, each thread splits the quads it copied, in
//   place: hi over the raw value, lo into the stage's second half; a
//   proxy fence and one barrier then hand the stage to the tensor cores.
// * wgmma.m64n128k8 (TF32, both operands from shared memory) runs the
//   three products of each k-step into one float32 accumulator; one
//   group of wgmmas stays in flight across the next chunk's split.
// * After a tile's last chunk the accumulator fragments are folded
//   straight into the running (best, second, idx), the key norms having
//   been loaded while the last wgmmas ran. A tile whose least distance
//   is not below a row's running second is skipped for that row;
//   otherwise each thread's keys go in increasing index order, so a
//   strict < keeps the lowest index among equal distances and a
//   duplicate of the best becomes the second; keys past N are never
//   candidates. At the end the 4 lanes that share a row merge (best,
//   idx) lexicographically, so the lowest index wins a tie across lanes
//   too, and second = min(max(b1, b2), min(s1, s2)), the TPU's rule
//   (:67-68).
// * D % 4 == 0 with 16-byte aligned bases takes 16-byte copies; any
//   other D (7, say) takes 4-byte copies into the same layout.
//
// The kernel allocates nothing: the wrapper hands in the outputs and the
// stream (PyTorch's current stream), and the entry point returns
// cudaGetLastError() for the wrapper to check. B is the grid's y
// dimension, so at most 65,535 pairs per launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 128;                         // keys per tile
constexpr int kKC = 16;                          // depth per chunk
constexpr int kStages = 4;                       // ring depth
constexpr int kQuads = kKC / 4;                  // 16-byte quads per row
constexpr int kCoreBytes = 128;                  // 8 rows × 16 bytes
constexpr int kGroupBytes = kQuads * kCoreBytes; // one 8-row group
constexpr int kSplit = 2;                        // CTAs per cluster
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// A CTA is two warpgroups, each owning 64 query rows; they share the key
// tile of every chunk.
constexpr int kThreads = 256;
constexpr int kBM = 128;                         // query rows per CTA
constexpr int kRows = kBM + kBN;                 // rows staged per chunk
constexpr int kHiBytes = kRows * kKC * 4;        // hi half of a stage
constexpr int kStageBytes = 2 * kHiBytes;        // hi, then lo
constexpr int kSmemBytes = kStages * kStageBytes;
constexpr int kQuadsPerThread = kRows * kQuads / kThreads;
constexpr int kRowStep = kThreads / kQuads;      // a thread's rows apart

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

// Byte offset of row r, quad q (k = 4q..4q+3) in a stage's hi half:
// 8-row groups kGroupBytes apart (wgmma's stride offset), quads of one
// group 128 bytes apart (its leading offset), rows 16 bytes apart.
__device__ __forceinline__ uint32_t smem_off(int r, int q) {
  return (r >> 3) * kGroupBytes + q * kCoreBytes + (r & 7) * 16;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The e-th 16-byte quad a thread copies and splits in a stage: row
// r0 + e·kRowStep, quad q, with r0 = 8·(t / (8·kQuads)) + t % 8 and
// q = (t / 8) % kQuads, so a warp reads whole 64-byte row segments from
// device memory and every 8 lanes touch 8 distinct 16-byte bank groups
// in shared memory.
__device__ __forceinline__ int quad_row0() {
  return 8 * (threadIdx.x / (8 * kQuads)) + threadIdx.x % 8;
}
__device__ __forceinline__ int quad_q() {
  return (threadIdx.x / 8) % kQuads;
}

// Copy chunk (rows m0.. of A and n0.. of K, depth k0..k0+15) into the
// stage at shared address `hi`; out-of-range elements are zero-filled.
template <bool kVec>
__device__ __forceinline__ void load_chunk(uint32_t hi, const float* A,
                                           const float* K, int m0, int n0,
                                           int k0, int M, int N, int D) {
  if (kVec) {
    const int r0 = quad_row0(), q = quad_q(), k = k0 + 4 * q;
#pragma unroll
    for (int e = 0; e < kQuadsPerThread; ++e) {
      const int r = r0 + e * kRowStep;
      const bool is_a = r < kBM;
      const int row = is_a ? m0 + r : n0 + r - kBM;
      const bool ok = k < D && row < (is_a ? M : N);
      const float* src = (is_a ? A : K) + (long long)row * D + k;
      cp_async16(hi + smem_off(r, q), ok ? src : A, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int e = 0; e < kRows * kKC / kThreads; ++e) {
      const int i = threadIdx.x + e * kThreads;
      const int r = i / kKC, c = i % kKC, k = k0 + c;
      const bool is_a = r < kBM;
      const int row = is_a ? m0 + r : n0 + r - kBM;
      const bool ok = k < D && row < (is_a ? M : N);
      const float* src = (is_a ? A : K) + (long long)row * D + k;
      cp_async4(hi + smem_off(r, c >> 2) + (c & 3) * 4, ok ? src : A,
                ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// One quad in place: hi = tf32(x), rounded to nearest, over x; lo =
// x − hi (exact in float32) at the same offset in the stage's lo half.
// The tensor core reads the TF32 bits of lo and drops the rest.
__device__ __forceinline__ void split_quad(unsigned char* p, int lo_off) {
  float4* hp = reinterpret_cast<float4*>(p);
  const float4 x = *hp;
  const float4 h = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                               tf32_rna(x.w));
  *reinterpret_cast<float4*>(p + lo_off) =
      make_float4(x.x - h.x, x.y - h.y, x.z - h.z, x.w - h.w);
  *hp = h;
}

// Split a landed stage. With 16-byte copies a thread splits the quads it
// copied itself, so its own cp.async wait suffices; with 4-byte copies
// it splits quads filled by other threads, after a barrier.
template <bool kVec>
__device__ __forceinline__ void split_stage(unsigned char* stage) {
  if (kVec) {
    const int r0 = quad_row0(), q = quad_q();
#pragma unroll
    for (int e = 0; e < kQuadsPerThread; ++e)
      split_quad(stage + smem_off(r0 + e * kRowStep, q),
                 kHiBytes);
  } else {
#pragma unroll
    for (int e = 0; e < kHiBytes / 16 / kThreads; ++e)
      split_quad(stage + (threadIdx.x + e * kThreads) * 16, kHiBytes);
  }
}

// wgmma shared-memory descriptor, no swizzle: start address, leading
// byte offset (next core matrix along K) and stride byte offset (next
// 8-row group), each in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(kCoreBytes >> 4) << 16) |
         ((uint64_t)(kGroupBytes >> 4) << 32);
}

__device__ __forceinline__ void fence_operand(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64×128 f32, the warpgroup's accumulator fragments) += A·Bᵀ over 8
// of depth, A (64×8) and B (128×8) TF32 in shared memory; scale_d = 0
// overwrites d instead.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The kSplit CTAs of one cluster share a query block: CTA rank r walks
// the r-th share of the key tiles, and rank 0 merges the others' top-2.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
top2_match_kernel(const float* __restrict__ d1, const float* __restrict__ d2,
                  const float* __restrict__ n2, float* __restrict__ best,
                  float* __restrict__ second, int* __restrict__ idx, int M,
                  int N, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int warp = threadIdx.x >> 5;  // rows 16·warp.. of the CTA's block
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;           // this warpgroup's 64 rows
  const int rank = blockIdx.x % kSplit;
  const int m0 = blockIdx.x / kSplit * kBM;
  const long long b = blockIdx.y;
  const float* A = d1 + b * M * D;
  const float* K = d2 + b * N * D;
  const float* nk = n2 + b * N;
  const int nK = D > kKC ? (D + kKC - 1) / kKC : 1;
  const int tiles = (N + kBN - 1) / kBN;
  const int share = (tiles + kSplit - 1) / kSplit;
  const int t0 = min(tiles, rank * share);
  const int t1 = min(tiles, t0 + share);
  const int total = nK * (t1 - t0);

  Top2 top[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    top[h] = {__int_as_float(0x7f800000), __int_as_float(0x7f800000), 0};
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int c = 0; c < kStages - 2; ++c) {
    if (c < total)
      load_chunk<kVec>(sbase + c * kStageBytes, A, K, m0,
                            (t0 + c / nK) * kBN, (c % nK) * kKC, M, N, D);
    cp_async_commit();
  }
  int c = 0;  // chunk counter over all (key tile, depth chunk) pairs
  for (int n0 = t0 * kBN; n0 < t1 * kBN; n0 += kBN) {
    for (int kc = 0; kc < nK; ++kc, ++c) {
      // this thread's copies of chunk c have landed (with 4-byte copies,
      // a barrier makes everyone's visible before the split)
      cp_async_wait<kStages - 3>();
      if (!kVec) __syncthreads();
      const int s = c % kStages;
      split_stage<kVec>(smem + s * kStageBytes);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      // every warpgroup has waited for its wgmmas up to chunk c − 2 (below,
      // before this barrier), so that chunk's stage is free for the copy
      // kStages − 2 chunks ahead
      const int cn = c + kStages - 2;
      if (cn < total)
        load_chunk<kVec>(sbase + (cn % kStages) * kStageBytes, A,
                              K, m0, (t0 + cn / nK) * kBN,
                              (cn % nK) * kKC, M, N, D);
      cp_async_commit();

      const uint32_t a_hi =
          sbase + s * kStageBytes + wg * 8 * kGroupBytes;
      const uint32_t b_hi =
          sbase + s * kStageBytes + (kBM / 8) * kGroupBytes;
      fence_operand(acc);
      wgmma_fence();
#pragma unroll
      for (int k8 = 0; k8 < kKC / 8; ++k8) {
        const uint32_t o = k8 * 2 * kCoreBytes;
        const uint64_t ah = desc(a_hi + o);
        const uint64_t al = desc(a_hi + kHiBytes + o);
        const uint64_t bh = desc(b_hi + o);
        const uint64_t bl = desc(b_hi + kHiBytes + o);
        wgmma_tf32(acc, ah, bh, (kc == 0 && k8 == 0) ? 0 : 1);
        wgmma_tf32(acc, ah, bl, 1);
        wgmma_tf32(acc, al, bh, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    // fragment layout: warp w of a warpgroup holds its rows 16w..16w+15;
    // lane l holds rows l/4 and l/4 + 8 of them, columns 8j + 2(l % 4) +
    // {0, 1} in acc[4j + {0, 1}] and acc[4j + {2, 3}]. The key norms are
    // loaded while the last wgmma group runs, unconditionally (clamped),
    // so the 32 loads issue together.
    const int nl = n0 + 2 * (lane & 3);
    float nn[kBN / 4];
#pragma unroll
    for (int j = 0; j < kBN / 4; ++j)
      nn[j] = __ldg(nk + min(nl + 8 * (j / 2) + j % 2, N - 1));
    wgmma_wait<0>();
    fence_operand(acc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // most tiles hold no key below the row's running second: skip
      // the ordered pushes unless the tile's least distance is below it
      float least = __int_as_float(0x7f800000);
#pragma unroll
      for (int j = 0; j < kBN / 4; ++j) {
        const int key = nl + 8 * (j / 2) + j % 2;
        const float d = nn[j] - 2.f * acc[4 * (j / 2) + 2 * h + j % 2];
        least = fminf(least, key < N ? d : __int_as_float(0x7f800000));
      }
      if (least < top[h].second) {
#pragma unroll
        for (int j = 0; j < kBN / 4; ++j) {
          const int key = nl + 8 * (j / 2) + j % 2;
          if (key < N)
            push(top[h], nn[j] - 2.f * acc[4 * (j / 2) + 2 * h + j % 2],
                 key);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ob = __shfl_xor_sync(kFull, top[h].best, off);
      const float os = __shfl_xor_sync(kFull, top[h].second, off);
      const int oi = __shfl_xor_sync(kFull, top[h].idx, off);
      merge(top[h], ob, os, oi);
    }
  }
  {
    // ranks 1.. store their rows' partials into rank 0's shared memory
    // (distributed shared memory); rank 0 merges them in rank order
    __shared__ float x_best[kSplit][kBM], x_second[kSplit][kBM];
    __shared__ int x_idx[kSplit][kBM];
    cooperative_groups::cluster_group cluster =
        cooperative_groups::this_cluster();
    if (rank > 0 && (lane & 3) == 0) {
      float* pb = cluster.map_shared_rank(&x_best[rank][0], 0);
      float* ps = cluster.map_shared_rank(&x_second[rank][0], 0);
      int* pi = cluster.map_shared_rank(&x_idx[rank][0], 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + (lane >> 2) + 8 * h;
        pb[r] = top[h].best;
        ps[r] = top[h].second;
        pi[r] = top[h].idx;
      }
    }
    cluster.sync();
    if (rank > 0) return;
    if ((lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + (lane >> 2) + 8 * h;
        for (int k = 1; k < kSplit; ++k)
          merge(top[h], x_best[k][r], x_second[k][r], x_idx[k][r]);
      }
    }
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 16 * warp + (lane >> 2) + 8 * h;
      if (m < M) {
        const long long o = b * M + m;
        best[o] = top[h].best;
        second[o] = top[h].second;
        idx[o] = top[h].idx;
      }
    }
  }
}

// The dynamic shared-memory opt-in, once per (device, variant).
template <bool kVec>
int prepare(int dev) {
  static bool done[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        top2_match_kernel<kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    done[dev] = true;
  }
  return 0;
}

template <bool kVec>
int launch(const float* d1, const float* d2, const float* n2, float* best,
           float* second, int* idx, int B, int M, int N, int D,
           cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int rc = prepare<kVec>(dev);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSplit * ((M + kBM - 1) / kBM), B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, top2_match_kernel<kVec>, d1, d2, n2,
                           best, second, idx, M, N, D);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// d1 (B, M, D), d2 (B, N, D), n2 (B, N) contiguous float32; best,
// second (B, M) float32 and idx (B, M) int32 out.
int top2_match_f32(const float* d1, const float* d2, const float* n2,
                   float* best, float* second, int* idx, int B, int M, int N,
                   int D, void* stream) {
  if (B <= 0 || M <= 0) return 0;
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(d1) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(d2) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(d1, d2, n2, best, second, idx, B, M, N, D, s)
             : launch<false>(d1, d2, n2, best, second, idx, B, M, N, D, s);
}

}  // extern "C"
