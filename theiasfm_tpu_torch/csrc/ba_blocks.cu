// Undamped normal-equation blocks of the bundle adjuster in one sweep over
// the observations, for Hopper (sm_90a). Built with a plain C interface and
// loaded through ctypes (theiasfm_tpu_torch/_kernels.py); the wrapper and
// its plain PyTorch version are sfm/ba/fused_matvec.py blocks and
// blocks_plain.
//
// Per observation m, with the weighted jacobians Jc (2x6), Ji (2xP),
// Jp (2x3) and residual r (2,), each stored flat as a row of (M, F):
//   pt[pt_m]   += [Jpᵀ Jp (9, row-major) | Jpᵀ r (3)]      (Np, 12)
//   cam[cam_m] += [Jcᵀ Jc (36, row-major) | Jcᵀ r (6)]     (Nc, 42)
//   X          += Jiᵀ Ji  over the flat (2P,) rows         (2P, 2P)
//   Y          += Jiᵀ r                                    (2P, 2)
//
// ba_blocks replaces theiasfm_tpu/sfm/ba/pallas_matvec.py _blocks_kernel
// (:644, launched by FusedBlocks.__call__ at :751).
//
// What bounds it on this card: bytes. Each observation reads Jc, Ji, Jp
// and r (20 + 2P f32 values: 88 bytes at P = 1) and two int32 ids, so 96
// bytes, and does about 250 operations: about 2.6 operations per byte,
// far below the H100's ~20 f32 operations per byte of device memory. At
// 560,128 observations that is 54 MB, about 16 µs at the H100 SXM's
// published 3.35 TB/s.
//
// The TPU kernel relies on the sequential TPU grid: it adds its point sums
// into overlapping point windows with an unguarded read-modify-write and
// carries the camera sums and X, Y in VMEM scratch across the grid. Blocks
// here run concurrently and in no order, so every sum is taken over a
// segment of an index built once per solve, in a fixed order, and stored
// once. There are no atomics, two launches on the same inputs give the
// same bits, and one code path serves every camera count. One grid
// (ba_blocks_sweep_kernel) runs two kinds of blocks side by side:
//
// * Point blocks, over the point index (pt_start, each point's segment;
//   the observations in pt_order, or in storage order when they are
//   sorted by point, the solver's case): a block owns 256 points; its
//   threads write the 9 point values of consecutive observations (Jpᵀ Jp's
//   upper triangle and Jpᵀ r) into shared memory, then thread j sums point
//   j's slots in order and stores its row of 12, the triangle mirrored. A
//   point with hundreds of observations costs its thread shared-memory
//   reads, not device-memory round trips: with one thread walking its
//   point's rows in device memory the kernel took 0.16 ms on the H100 at
//   Notre-Dame (0.07 with the tiles), whose last point holds the 128
//   padding observations. The group products of the same observations,
//   the upper triangle of Jiᵀ Ji and Jiᵀ r, add up in registers
//   (templated on P); each warp reduces them by a butterfly, the block
//   adds its warps in warp order and stores one partial row. About 40
//   bytes per observation (Jp, r, Ji), read in point order.
// * Camera blocks: 1-8 warps per camera (about 4 rows per lane on
//   average) gather the camera's Jc and r rows in the order of the camera
//   index (cam_order, cam_start) and sum the 21 upper-triangle values of
//   Jcᵀ Jc and the 6 of Jcᵀ r, 27 sums instead of 42; then a butterfly
//   per warp and the warps in warp order. The camera's row of 42 is stored
//   once, the triangle mirrored. A 4-byte index and a gathered 56-byte
//   row (some 96 bytes of 32-byte sectors) per observation.
//
// A second launch of one block (ba_blocks_group_kernel) sums the point
// blocks' group partials in block order into X (mirrored) and Y.
//
// Everything is f32, as on the TPU (FusedBlocks forces f32): products and
// sums in f32. Inputs are strided (M, F) views; when every row is
// contiguous and aligned (kRows, chosen by the wrapper) they are read with
// 16- and 8-byte loads, which measured 3-11% faster than one value per
// load on the H100 (on the bench problem's jacobians).
//
// The kernels allocate nothing: the wrapper hands in the indices, the
// outputs (each written whole), the group partials' workspace (one row
// per point block) and the stream (PyTorch's current stream). The entry
// point returns cudaGetLastError() for the wrapper to check.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // points per block of the point sweep
constexpr int kPtTile = 4 * kThreads;  // positions per tile of it
constexpr int kCamRowsPerLane = 4;
constexpr int kMaxP = 10;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// (row, column) strides of jc, ji, jp and r
struct Strides {
  long long v[8];
};

// F values of row m of an (M, F) view with strides (sm, sf). kRows: sf is
// 1 and each row starts aligned, so it is read in 16-byte pieces when F is
// a multiple of 4, else in 8-byte ones.
template <int F, bool kRows>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         long long sm, long long sf,
                                         long long m, float* o) {
  if (kRows) {
    const float* q = p + m * sm;
    if (F % 4 == 0) {
#pragma unroll
      for (int f = 0; f < F; f += 4) {
        const float4 v = *reinterpret_cast<const float4*>(q + f);
        o[f] = v.x;
        o[f + 1] = v.y;
        o[f + 2] = v.z;
        o[f + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int f = 0; f < F; f += 2) {
        const float2 v = *reinterpret_cast<const float2*>(q + f);
        o[f] = v.x;
        o[f + 1] = v.y;
      }
    }
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = p[m * sm + f * sf];
  }
}

__device__ __forceinline__ int tile_slot(int i) { return i + (i >> 5); }

// (k)-th entry of the row-major upper triangle of an n x n matrix -> (a, b)
__device__ __forceinline__ void triangle_entry(int k, int n, int* a, int* b) {
  int i = 0;
  while (k >= n - i) {
    k -= n - i;
    ++i;
  }
  *a = i;
  *b = i + k;
}

// The point sweep of block b: it owns points [256b, 256b + 256), whose
// observations are the positions [lo, hi) = [pt_start[256b],
// pt_start[256b + 256]) of the point order. It walks them in tiles of 1024
// positions, four per thread (adjacent lanes on adjacent positions): each
// thread writes the 9 point values of its positions (the upper triangle
// of Jpᵀ Jp, then Jpᵀ r) into shared memory and adds their group products
// in registers; then thread j adds the slots of point 256b + j in
// position order and stores the point's row of 12 once, the triangle
// mirrored. One group partial per block: [upper triangle of X
// (row-major) | Y (2P, 2) row-major].
template <int P, bool kRows>
__device__ __forceinline__ void point_sweep(
    int b, const float* __restrict__ ji, const float* __restrict__ jp,
    const float* __restrict__ r, const long long* st,
    const int* __restrict__ pt_order, const int* __restrict__ pt_start,
    float* __restrict__ pt_out, float* __restrict__ g_part, int Np) {
  constexpr int P2 = 2 * P;
  constexpr int GX = P2 * (P2 + 1) / 2;
  constexpr int G = GX + 2 * P2;
  constexpr int kWarps = kThreads / 32;
  __shared__ float t_s[9][kPtTile + kPtTile / 32];
  __shared__ float g_warp[kWarps][G];
  float g[G];
#pragma unroll
  for (int k = 0; k < G; ++k) g[k] = 0.f;
  const int tid = threadIdx.x;
  const int p0 = b * kThreads;
  const int p = p0 + tid;
  const int lo = pt_start[p0], hi = pt_start[min(p0 + kThreads, Np)];
  int s = 0, e = 0;
  if (p < Np) {
    s = pt_start[p];
    e = pt_start[p + 1];
  }
  float acc[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) acc[c] = 0.f;
  for (int tb = lo; tb < hi; tb += kPtTile) {
#pragma unroll
    for (int k = 0; k < kPtTile / kThreads; ++k) {
      const int slot = tid + kThreads * k;
      const int i = tb + slot;
      float t[9];
#pragma unroll
      for (int c = 0; c < 9; ++c) t[c] = 0.f;
      if (i < hi) {
        const long long m = pt_order ? pt_order[i] : i;
        float q[6], rr[2], j[P2];
        load_row<6, kRows>(jp, st[4], st[5], m, q);
        load_row<2, kRows>(r, st[6], st[7], m, rr);
        load_row<P2, kRows>(ji, st[2], st[3], m, j);
        int n = 0;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
          for (int c = a; c < 3; ++c)
            t[n++] = q[a] * q[c] + q[3 + a] * q[3 + c];
        }
#pragma unroll
        for (int a = 0; a < 3; ++a)
          t[6 + a] = q[a] * rr[0] + q[3 + a] * rr[1];
        n = 0;
#pragma unroll
        for (int f = 0; f < P2; ++f) {
#pragma unroll
          for (int h = f; h < P2; ++h) g[n++] += j[f] * j[h];
        }
#pragma unroll
        for (int f = 0; f < P2; ++f) {
          g[GX + 2 * f] += j[f] * rr[0];
          g[GX + 2 * f + 1] += j[f] * rr[1];
        }
      }
#pragma unroll
      for (int c = 0; c < 9; ++c) t_s[c][tile_slot(slot)] = t[c];
    }
    __syncthreads();
    const int a = s > tb ? s : tb;
    const int z = e < tb + kPtTile ? e : tb + kPtTile;
    for (int i = a; i < z; ++i) {
      const int slot = tile_slot(i - tb);
#pragma unroll
      for (int c = 0; c < 9; ++c) acc[c] += t_s[c][slot];
    }
    __syncthreads();
  }
  if (p < Np) {
    // [H00 H01 H02 H11 H12 H22 | g0 g1 g2] -> [H (3x3) | g]
    float4* dst = reinterpret_cast<float4*>(pt_out + (long long)p * 12);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[1]);
    dst[1] = make_float4(acc[3], acc[4], acc[2], acc[4]);
    dst[2] = make_float4(acc[5], acc[6], acc[7], acc[8]);
  }
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const float v = warp_sum(g[k]);
    if (lane == 0) g_warp[warp][k] = v;
  }
  __syncthreads();
  for (int k = tid; k < G; k += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += g_warp[w][k];
    g_part[(long long)b * G + k] = v;
  }
}

// The camera sweep of block b: W warps per camera sum its rows in
// cam_order (lane l of warp w takes rows l + 32w, l + 32(w + W), ...),
// then a butterfly per warp and the W warp sums in warp order; the
// camera's row of 42 is stored once, the triangle mirrored.
template <bool kRows>
__device__ __forceinline__ void camera_sweep(
    int b, const float* __restrict__ jc, const float* __restrict__ r,
    const long long* st, const int* __restrict__ cam_order,
    const int* __restrict__ cam_start, float* __restrict__ cam_out, int Nc,
    int W) {
  constexpr int kTri = 21;  // upper triangle of the 6x6 Jcᵀ Jc
  __shared__ float s_warp[kThreads / 32][kTri + 6];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = warp % W;
  const int cam = b * (kThreads / 32 / W) + warp / W;
  float s[kTri + 6];
#pragma unroll
  for (int k = 0; k < kTri + 6; ++k) s[k] = 0.f;
  if (cam < Nc) {
    const int lo = cam_start[cam], hi = cam_start[cam + 1];
#pragma unroll 2
    for (int i = lo + 32 * sub + lane; i < hi; i += 32 * W) {
      const long long m = cam_order[i];
      float c[12], rr[2];
      load_row<12, kRows>(jc, st[0], st[1], m, c);
      load_row<2, kRows>(r, st[6], st[7], m, rr);
      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int d = a; d < 6; ++d)
          s[k++] += c[a] * c[d] + c[6 + a] * c[6 + d];
      }
#pragma unroll
      for (int a = 0; a < 6; ++a)
        s[kTri + a] += c[a] * rr[0] + c[6 + a] * rr[1];
    }
  }
#pragma unroll
  for (int k = 0; k < kTri + 6; ++k) {
    const float v = warp_sum(s[k]);
    if (lane == 0) s_warp[warp][k] = v;
  }
  __syncthreads();
  if (sub == 0 && cam < Nc && lane < kTri + 6) {
    float v = 0.f;
    for (int w = 0; w < W; ++w) v += s_warp[warp + w][lane];
    float* dst = cam_out + (long long)cam * 42;
    if (lane < kTri) {
      int a, d;
      triangle_entry(lane, 6, &a, &d);
      dst[6 * a + d] = v;
      dst[6 * d + a] = v;
    } else {
      dst[36 + lane - kTri] = v;
    }
  }
}

// Both sweeps in one grid, so that the two overlap: blocks below
// pt_blocks sweep points, the rest cameras.
template <int P, bool kRows>
__global__ void __launch_bounds__(kThreads)
ba_blocks_sweep_kernel(const float* __restrict__ jc,
                       const float* __restrict__ ji,
                       const float* __restrict__ jp,
                       const float* __restrict__ r, Strides strides,
                       const int* __restrict__ pt_order,
                       const int* __restrict__ pt_start,
                       const int* __restrict__ cam_order,
                       const int* __restrict__ cam_start,
                       float* __restrict__ pt_out, float* __restrict__ g_part,
                       float* __restrict__ cam_out, int Np, int Nc,
                       int pt_blocks, int W) {
  if ((int)blockIdx.x < pt_blocks)
    point_sweep<P, kRows>(blockIdx.x, ji, jp, r, strides.v, pt_order,
                          pt_start, pt_out, g_part, Np);
  else
    camera_sweep<kRows>(blockIdx.x - pt_blocks, jc, r, strides.v, cam_order,
                        cam_start, cam_out, Nc, W);
}

// The point sweep's n_part group partials summed in block order, one warp
// per value, into X (mirrored) and Y.
__global__ void __launch_bounds__(kThreads)
ba_blocks_group_kernel(const float* __restrict__ g_part, int n_part, int P,
                       float* __restrict__ x_out, float* __restrict__ y_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int P2 = 2 * P, GX = P2 * (P2 + 1) / 2, G = GX + 2 * P2;
  for (int v = warp; v < G; v += kThreads / 32) {
    float s = 0.f;
    for (int i = lane; i < n_part; i += 32) s += g_part[(long long)i * G + v];
    s = warp_sum(s);
    if (lane == 0) {
      if (v < GX) {
        int f, h;
        triangle_entry(v, P2, &f, &h);
        x_out[f * P2 + h] = s;
        x_out[h * P2 + f] = s;
      } else {
        y_out[v - GX] = s;
      }
    }
  }
}

template <int P, bool kRows>
void launch_sweep(unsigned blocks, cudaStream_t stream, const float* jc,
                  const float* ji, const float* jp, const float* r,
                  const Strides& st, const int* pt_order, const int* pt_start,
                  const int* cam_order, const int* cam_start, float* pt_out,
                  float* g_part, float* cam_out, int Np, int Nc,
                  int pt_blocks, int W) {
  ba_blocks_sweep_kernel<P, kRows><<<blocks, kThreads, 0, stream>>>(
      jc, ji, jp, r, st, pt_order, pt_start, cam_order, cam_start, pt_out,
      g_part, cam_out, Np, Nc, pt_blocks, W);
}

template <bool kRows>
int launch(const float* jc, const float* ji, const float* jp, const float* r,
           const Strides& st, const int* pt_order, const int* pt_start,
           const int* cam_order, const int* cam_start, float* g_work,
           float* pt_out, float* cam_out, float* x_out, float* y_out,
           long long M, int P, int Np, int Nc, cudaStream_t s) {
  const int pt_blocks = (Np + kThreads - 1) / kThreads;
  // warps per camera: enough that a lane sums about kCamRowsPerLane rows
  int W = 1;
  while (W < kThreads / 32 && 32LL * kCamRowsPerLane * W * Nc < M) W *= 2;
  const int cams_per_block = kThreads / 32 / W;
  const unsigned blocks =
      pt_blocks + (Nc + cams_per_block - 1) / cams_per_block;
  if (blocks > 0) {
#define SWEEP(PP)                                                          \
  case PP:                                                                 \
    launch_sweep<PP, kRows>(blocks, s, jc, ji, jp, r, st, pt_order,        \
                            pt_start, cam_order, cam_start, pt_out, g_work, \
                            cam_out, Np, Nc, pt_blocks, W);                \
    break;
    switch (P) {
      SWEEP(1) SWEEP(2) SWEEP(3) SWEEP(4) SWEEP(5)
      SWEEP(6) SWEEP(7) SWEEP(8) SWEEP(9) SWEEP(10)
    }
#undef SWEEP
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  ba_blocks_group_kernel<<<1, kThreads, 0, s>>>(g_work, pt_blocks, P, x_out,
                                                y_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// jc (M, 12), ji (M, 2P), jp (M, 6), r (M, 2): f32 with the given strides
// (row, column) each; rows: 1 when every input's rows are contiguous and
// aligned for 16-byte (jc) and 8-byte (ji, jp, r) loads. The point index
// (pt_order (M,) int32, or null when the observations are sorted by point;
// pt_start (Np + 1,)) and the camera index (cam_order (M,), cam_start
// (Nc + 1,)). g_work: at least ceil(Np / 256) rows of 2P(2P + 1)/2 + 4P
// floats. Outputs, each written whole: pt_out (Np, 12), cam_out (Nc, 42),
// x_out (2P, 2P), y_out (2P, 2).
int ba_blocks_f32(const float* jc, const float* ji, const float* jp,
                  const float* r, long long jc_sm, long long jc_sf,
                  long long ji_sm, long long ji_sf, long long jp_sm,
                  long long jp_sf, long long r_sm, long long r_sf, int rows,
                  const int* pt_order, const int* pt_start,
                  const int* cam_order, const int* cam_start, float* g_work,
                  float* pt_out, float* cam_out, float* x_out, float* y_out,
                  long long M, int P, int Np, int Nc, void* stream) {
  if (P < 1 || P > kMaxP) return (int)cudaErrorInvalidValue;
  const Strides st = {{jc_sm, jc_sf, ji_sm, ji_sf, jp_sm, jp_sf, r_sm, r_sf}};
  const cudaStream_t s = (cudaStream_t)stream;
  if (rows)
    return launch<true>(jc, ji, jp, r, st, pt_order, pt_start, cam_order,
                        cam_start, g_work, pt_out, cam_out, x_out, y_out, M,
                        P, Np, Nc, s);
  return launch<false>(jc, ji, jp, r, st, pt_order, pt_start, cam_order,
                       cam_start, g_work, pt_out, cam_out, x_out, y_out, M, P,
                       Np, Nc, s);
}

}  // extern "C"
