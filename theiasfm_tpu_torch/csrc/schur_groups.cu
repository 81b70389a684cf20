// Schur-complement matvec observation sweeps for observations that carry
// more than one intrinsics group (BAL's own parameterisation: a group per
// camera), for Hopper (sm_90a). Built with a plain C interface and loaded
// through ctypes (theiasfm_tpu_torch/_kernels.py); the wrappers
// (pass1_groups, pass2_groups) and their plain PyTorch versions are in
// sfm/ba/fused_matvec.py.
//
// One matrix-free product S·v of the reduced camera system is
//   pass 1:  u  = Jc·vc[cam] + Ji·vg[group]     per observation (2,)
//            wp[pt] += Jpᵀu                      per point       (3,)
//   glue:    zp = Hpp⁻¹ wp                       (torch, between passes)
//   pass 2:  d  = u − Jp·zp[pt]
//            yc[cam]   += Jcᵀd                   per camera      (6,)
//            yg[group] += Jiᵀd                   per group       (P,)
//
// It replaces no TPU kernel: theiasfm_tpu/sfm/ba/pallas_matvec.py takes one
// shared group only, and so does csrc/schur_matvec.cu, whose pass 1 keeps
// the one vg in shared memory and whose pass 2 reduces the group products
// to one (2P, 2) block partial. Here vg is an (Ng, P) table read by each
// observation's group id (13,682 × 3 floats at BAL Final: it lives in L2),
// and the group products are segment sums of their own.
//
// What bounds them on this card: bytes, as for the one-group kernels. Per
// observation in bf16 at P = 3 each pass reads 48 bytes of jacobians, 8 of
// ids and 4 of group id, and pass 1 writes (pass 2 reads) 8 of u: about 2 GB
// a pass at 29M observations, 0.6 ms at 3.35 TB/s, against 45–60
// operations per observation. The design reads every jacobian element once,
// coalesced along M in the transposed layout, and takes no atomics, so two
// launches on the same inputs give the same bits:
//
// * Pass 1 (schur_groups_pass1_kernel) is schur_pass1_kernel with the group
//   term read per observation: block b owns 256 points and the run of
//   observations the point index gives them; each thread computes u and
//   Jpᵀ round(u) for four observations into shared memory, then thread j
//   adds point j's slots in observation order and stores wp once.
// * Pass 2, stage A (schur_groups_pass2_obs_kernel), per observation in
//   storage order: d and the rows Jcᵀd, written to an (M, 6) workspace, and
//   Jiᵀd, written to an (M, P) one.
// * Pass 2, stage B (schur_groups_segsum_kernel, launched twice): the rows
//   of each workspace summed over the segments of an index (cam_order /
//   cam_start for yc, grp_order / grp_start for yg: stable argsorts of
//   obs_cam and obs_group and their segment starts, built once per solve),
//   1–8 warps per segment, lane by lane, then by a butterfly and across the
//   segment's warps in warp order; each output row is stored once. A
//   segment as long as a few percent of M (a handful of groups) is summed
//   by at most 256 threads: right, but slow.
//
// Rounding follows the plain S_matvec of bundle_adjustment.py and
// pass1_plain / pass2_plain: vc[cam] and vg[group] are rounded to the
// matvec type, u is rounded before forming Jpᵀu, zp[pt] and d are rounded
// before their products; products are formed in f32 from the (possibly
// bf16) inputs and every sum accumulates in f32 in a fixed order.
//
// The kernels allocate nothing: the wrapper hands in the indices, the
// outputs (each written whole), pass 2's workspaces (allocated once per
// solve with the camera and group indices) and the stream, and each entry
// point returns cudaGetLastError() for the wrapper to check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // points per block of pass 1
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

// four values of type T at p (aligned to 4 values)
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

// Pass 1's input layouts, chosen by the wrapper. kColumns: each (F, M)
// jacobian row is contiguous along M and aligned to 4 values, obs_cam and
// obs_group aligned to 16 bytes: a thread reads its four observations of a
// row with one load. kAnyStrides: one value per load at any strides, and the
// observations in the point order when they are not sorted by point.
constexpr int kAnyStrides = 0;
constexpr int kColumns = 1;
constexpr int kTile = 4 * kThreads;  // positions per tile

__device__ __forceinline__ int tile_slot(int i) { return i + (i >> 5); }

// u and Jpᵀ round(u) of the four observations at positions i0 + step·k
// (k < 4) of the point order: step 1 in kColumns, else 32 (adjacent lanes on
// adjacent observations); positions outside [lo, hi) belong to another block
// and are neither computed nor written (their t stays 0).
template <typename T, int kLayout>
__device__ __forceinline__ void pass1_quad(
    const T* __restrict__ jc, const T* __restrict__ ji,
    const T* __restrict__ jp, long long jc_sf, long long jc_sm,
    long long ji_sf, long long ji_sm, long long jp_sf, long long jp_sm,
    const int* __restrict__ obs_cam, const int* __restrict__ obs_group,
    const int* __restrict__ pt_order, const float* __restrict__ vc,
    const float* __restrict__ vg, float* __restrict__ u, long long M, int P,
    long long i0, long long lo, long long hi, float t[3][4]) {
  constexpr int step = kLayout == kColumns ? 1 : 32;
  bool valid[4];
  bool any = false, all = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    valid[k] = i0 + step * k >= lo && i0 + step * k < hi;
    any |= valid[k];
    all &= valid[k];
#pragma unroll
    for (int c = 0; c < 3; ++c) t[c][k] = 0.f;
  }
  if (!any) return;
  long long m[4];
  int cam[4], grp[4];
  if (kLayout == kColumns) {
    const int4 c4 = *reinterpret_cast<const int4*>(obs_cam + i0);
    const int4 g4 = *reinterpret_cast<const int4*>(obs_group + i0);
    cam[0] = c4.x;
    cam[1] = c4.y;
    cam[2] = c4.z;
    cam[3] = c4.w;
    grp[0] = g4.x;
    grp[1] = g4.y;
    grp[2] = g4.z;
    grp[3] = g4.w;
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = i0 + k;
  } else {
    // a position outside [lo, hi) reads the nearest one inside, so that
    // every load is made unconditionally; its results are not written
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long i = min(max(i0 + step * k, lo), hi - 1);
      m[k] = pt_order ? pt_order[i] : i;
      cam[k] = obs_cam[m[k]];
      grp[k] = obs_group[m[k]];
    }
  }
  float u0[4], u1[4], q[6][4];
  if (kLayout == kColumns) {
    float a[4], b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) u0[k] = u1[k] = 0.f;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      load4(jc + i * jc_sf + i0, a);
      load4(jc + (6 + i) * jc_sf + i0, b);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float v = round_mv<T>(vc[(long long)cam[k] * 6 + i]);
        u0[k] += a[k] * v;
        u1[k] += b[k] * v;
      }
    }
    float g0[4] = {0.f, 0.f, 0.f, 0.f}, g1[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p = 0; p < P; ++p) {
      load4(ji + p * ji_sf + i0, a);
      load4(ji + (P + p) * ji_sf + i0, b);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float v = round_mv<T>(vg[(long long)grp[k] * P + p]);
        g0[k] += a[k] * v;
        g1[k] += b[k] * v;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      u0[k] += g0[k];
      u1[k] += g1[k];
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) load4(jp + c * jp_sf + i0, q[c]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      u0[k] = u1[k] = 0.f;
      float c[12], w[6];
#pragma unroll
      for (int f = 0; f < 12; ++f) c[f] = load(jc, f * jc_sf + m[k] * jc_sm);
#pragma unroll
      for (int f = 0; f < 6; ++f) w[f] = load(jp, f * jp_sf + m[k] * jp_sm);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float v = round_mv<T>(vc[(long long)cam[k] * 6 + i]);
        u0[k] += c[i] * v;
        u1[k] += c[6 + i] * v;
      }
      float g0 = 0.f, g1 = 0.f;
      for (int p = 0; p < P; ++p) {
        const float v = round_mv<T>(vg[(long long)grp[k] * P + p]);
        g0 += load(ji, p * ji_sf + m[k] * ji_sm) * v;
        g1 += load(ji, (P + p) * ji_sf + m[k] * ji_sm) * v;
      }
      u0[k] += g0;
      u1[k] += g1;
#pragma unroll
      for (int i = 0; i < 6; ++i) q[i][k] = w[i];
    }
  }
  if (kLayout == kColumns && all) {
    *reinterpret_cast<float4*>(u + i0) =
        make_float4(u0[0], u0[1], u0[2], u0[3]);
    *reinterpret_cast<float4*>(u + M + i0) =
        make_float4(u1[0], u1[1], u1[2], u1[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!valid[k]) continue;
      u[m[k]] = u0[k];
      u[M + m[k]] = u1[k];
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!valid[k]) continue;
    const float a = round_mv<T>(u0[k]);
    const float b = round_mv<T>(u1[k]);
    t[0][k] = q[0][k] * a + q[3][k] * b;
    t[1][k] = q[1][k] * a + q[4][k] * b;
    t[2][k] = q[2][k] * a + q[5][k] * b;
  }
}

// Pass 1: block b owns points [256b, 256b + 256), whose observations are the
// positions [lo, hi) = [pt_start[256b], pt_start[256b + 256]) of the point
// order. It walks them in tiles of 1024 positions from lo rounded down to a
// multiple of 4: each thread computes u and t = Jpᵀ round(u) for four
// positions of the tile into shared memory, then thread j adds the slots of
// point 256b + j in position order. wp is stored once per point.
template <typename T, int kLayout>
__global__ void __launch_bounds__(kThreads)
schur_groups_pass1_kernel(
    const T* __restrict__ jc, const T* __restrict__ ji,
    const T* __restrict__ jp, long long jc_sf, long long jc_sm,
    long long ji_sf, long long ji_sm, long long jp_sf, long long jp_sm,
    const int* __restrict__ obs_cam, const int* __restrict__ obs_group,
    const int* __restrict__ pt_order, const int* __restrict__ pt_start,
    const float* __restrict__ vc, const float* __restrict__ vg,
    float* __restrict__ u, float* __restrict__ wp, long long M, int P,
    int Np) {
  __shared__ float t_s[3][kTile + kTile / 32];
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kThreads;
  const int p = p0 + tid;
  const int p_end = min(p0 + kThreads, Np);
  const long long lo = pt_start[p0], hi = pt_start[p_end];
  long long s = 0, e = 0;
  if (p < Np) {
    s = pt_start[p];
    e = pt_start[p + 1];
  }
  float w0 = 0.f, w1 = 0.f, w2 = 0.f;
  // this thread's first slot of a tile and the step between its four
  const int slot0 = kLayout == kColumns ? 4 * tid
                                         : 128 * (tid >> 5) + (tid & 31);
  const int step = kLayout == kColumns ? 1 : 32;
  for (long long tb = lo & ~3LL; tb < hi; tb += kTile) {
    float t[3][4];
    pass1_quad<T, kLayout>(jc, ji, jp, jc_sf, jc_sm, ji_sf, ji_sm, jp_sf,
                           jp_sm, obs_cam, obs_group, pt_order, vc, vg, u, M,
                           P, tb + slot0, lo, hi, t);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = tile_slot(slot0 + step * k);
      t_s[0][j] = t[0][k];
      t_s[1][j] = t[1][k];
      t_s[2][j] = t[2][k];
    }
    __syncthreads();
    const long long a = s > tb ? s : tb;
    const long long b = e < tb + kTile ? e : tb + kTile;
    for (long long i = a; i < b; ++i) {
      const int j = tile_slot((int)(i - tb));
      w0 += t_s[0][j];
      w1 += t_s[1][j];
      w2 += t_s[2][j];
    }
    __syncthreads();
  }
  if (p < Np) {
    wp[3LL * p + 0] = w0;
    wp[3LL * p + 1] = w1;
    wp[3LL * p + 2] = w2;
  }
}

// Stage A of pass 2, one observation per thread of a grid-stride loop:
// d = round(u − Jp·round(zp[pt])), then the row Jcᵀd into y (M, 6) and the
// row Jiᵀd into g (M, P).
template <typename T>
__global__ void __launch_bounds__(kThreads)
schur_groups_pass2_obs_kernel(
    const T* __restrict__ jc, const T* __restrict__ ji,
    const T* __restrict__ jp, long long jc_sf, long long jc_sm,
    long long ji_sf, long long ji_sm, long long jp_sf, long long jp_sm,
    const int* __restrict__ obs_pt, const float* __restrict__ u,
    const float* __restrict__ zp, float* __restrict__ y,
    float* __restrict__ g, long long M, int P) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x; m < M;
       m += stride) {
    const long long pt = obs_pt[m];
    const float z0 = round_mv<T>(zp[pt * 3 + 0]);
    const float z1 = round_mv<T>(zp[pt * 3 + 1]);
    const float z2 = round_mv<T>(zp[pt * 3 + 2]);
    const long long jp_m = m * jp_sm;
    const float u20 = load(jp, 0 * jp_sf + jp_m) * z0 +
                      load(jp, 1 * jp_sf + jp_m) * z1 +
                      load(jp, 2 * jp_sf + jp_m) * z2;
    const float u21 = load(jp, 3 * jp_sf + jp_m) * z0 +
                      load(jp, 4 * jp_sf + jp_m) * z1 +
                      load(jp, 5 * jp_sf + jp_m) * z2;
    const float a = round_mv<T>(u[m] - u20);
    const float b = round_mv<T>(u[M + m] - u21);
    const long long jc_m = m * jc_sm;
    float yv[6];
#pragma unroll
    for (int i = 0; i < 6; ++i)
      yv[i] = load(jc, i * jc_sf + jc_m) * a +
              load(jc, (6 + i) * jc_sf + jc_m) * b;
    float2* row = reinterpret_cast<float2*>(y + m * 6);
    row[0] = make_float2(yv[0], yv[1]);
    row[1] = make_float2(yv[2], yv[3]);
    row[2] = make_float2(yv[4], yv[5]);
    const long long ji_m = m * ji_sm;
    for (int p = 0; p < P; ++p)
      g[m * P + p] = load(ji, p * ji_sf + ji_m) * a +
                     load(ji, (P + p) * ji_sf + ji_m) * b;
  }
}

constexpr int kSegWarps = 8;  // warps per block of stage B

// Stage B of pass 2: the (n, F) segment sums out[s] = Σ rows[order[i]] over
// i in [start[s], start[s + 1]). W warps per segment (W = 1, 2, 4 or 8, from
// the mean segment length): lane l of warp w takes positions l + 32w,
// l + 32(w + W), ...; then a butterfly per warp and the W warp sums in warp
// order; each output row is stored once.
template <int F>
__global__ void __launch_bounds__(kSegWarps * 32)
schur_groups_segsum_kernel(const float* __restrict__ rows,
                           const int* __restrict__ order,
                           const int* __restrict__ start,
                           float* __restrict__ out, int n, int W) {
  __shared__ float s_warp[kSegWarps][F];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = warp % W;
  const int seg = blockIdx.x * (kSegWarps / W) + warp / W;
  float s[F];
#pragma unroll
  for (int f = 0; f < F; ++f) s[f] = 0.f;
  if (seg < n) {
    const int lo = start[seg], hi = start[seg + 1];
#pragma unroll 4
    for (int i = lo + 32 * sub + lane; i < hi; i += 32 * W) {
      const float* row = rows + (long long)order[i] * F;
#pragma unroll
      for (int f = 0; f < F; ++f) s[f] += row[f];
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float v = warp_sum(s[f]);
    if (lane == 0) s_warp[warp][f] = v;
  }
  __syncthreads();
  if (sub == 0 && lane < F && seg < n) {
    float v = 0.f;
    for (int w = 0; w < W; ++w) v += s_warp[warp + w][lane];
    out[(long long)seg * F + lane] = v;
  }
}

template <int F>
void launch_segsum(const float* rows, const int* order, const int* start,
                   float* out, int n, long long M, cudaStream_t s) {
  // warps per segment: enough that a lane sums about 4 rows on average
  int W = 1;
  while (W < kSegWarps && 32LL * 4 * W * n < M) W *= 2;
  const int per_block = kSegWarps / W;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  schur_groups_segsum_kernel<F>
      <<<blocks, kSegWarps * 32, 0, s>>>(rows, order, start, out, n, W);
}

void segsum(const float* rows, const int* order, const int* start,
            float* out, int n, int F, long long M, cudaStream_t s) {
  if (n == 0) return;
#define SEGSUM(FF)                                         \
  case FF:                                                 \
    launch_segsum<FF>(rows, order, start, out, n, M, s);   \
    break;
  switch (F) {
    SEGSUM(1) SEGSUM(2) SEGSUM(3) SEGSUM(4) SEGSUM(5)
    SEGSUM(6) SEGSUM(7) SEGSUM(8) SEGSUM(9) SEGSUM(10)
  }
#undef SEGSUM
}

// layout: kColumns (the wrapper checked the strides, the alignment and
// M % 4 == 0; it needs the observations in point order, pt_order null),
// else kAnyStrides.
template <typename T>
int launch_pass1(const void* jc, const void* ji, const void* jp,
                 long long jc_sf, long long jc_sm, long long ji_sf,
                 long long ji_sm, long long jp_sf, long long jp_sm, int layout,
                 const int* obs_cam, const int* obs_group, const int* pt_order,
                 const int* pt_start, const float* vc, const float* vg,
                 float* u, float* wp, long long M, int P, int Np,
                 void* stream) {
  if (P < 1 || P > kMaxP) return (int)cudaErrorInvalidValue;
  if (pt_order != nullptr) layout = kAnyStrides;
  const unsigned blocks = (unsigned)((Np + kThreads - 1) / kThreads);
  if (blocks == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
#define PASS1(L)                                                            \
  schur_groups_pass1_kernel<T, L><<<blocks, kThreads, 0, s>>>(              \
      (const T*)jc, (const T*)ji, (const T*)jp, jc_sf, jc_sm, ji_sf, ji_sm, \
      jp_sf, jp_sm, obs_cam, obs_group, pt_order, pt_start, vc, vg, u, wp,  \
      M, P, Np)
  if (layout == kColumns)
    PASS1(kColumns);
  else
    PASS1(kAnyStrides);
#undef PASS1
  return (int)cudaGetLastError();
}

// Both stages of pass 2. y_work (M, 6) and g_work (M, P) are the row
// workspaces of stage A; stage B sums them into yc (Nc, 6) over the camera
// segments and yg (Ng, P) over the group segments.
template <typename T>
int launch_pass2(const void* jc, const void* ji, const void* jp,
                 long long jc_sf, long long jc_sm, long long ji_sf,
                 long long ji_sm, long long jp_sf, long long jp_sm,
                 const int* obs_pt, const float* u, const float* zp,
                 const int* cam_order, const int* cam_start,
                 const int* grp_order, const int* grp_start, float* y_work,
                 float* g_work, float* yc, float* yg, long long M, int P,
                 int Nc, int Ng, void* stream) {
  if (P < 1 || P > kMaxP) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (M > 0) {
    const long long needed = (M + kThreads - 1) / kThreads;
    const unsigned blocks = (unsigned)(needed < (1LL << 20) ? needed
                                                           : (1LL << 20));
    schur_groups_pass2_obs_kernel<T><<<blocks, kThreads, 0, s>>>(
        (const T*)jc, (const T*)ji, (const T*)jp, jc_sf, jc_sm, ji_sf, ji_sm,
        jp_sf, jp_sm, obs_pt, u, zp, y_work, g_work, M, P);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  segsum(y_work, cam_order, cam_start, yc, Nc, 6, M, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  segsum(g_work, grp_order, grp_start, yg, Ng, P, M, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int schur_groups_pass1_f32(const void* jc, const void* ji, const void* jp,
                           long long jc_sf, long long jc_sm, long long ji_sf,
                           long long ji_sm, long long jp_sf, long long jp_sm,
                           int layout, const int* obs_cam,
                           const int* obs_group, const int* pt_order,
                           const int* pt_start, const float* vc,
                           const float* vg, float* u, float* wp, long long M,
                           int P, int Np, void* stream) {
  return launch_pass1<float>(jc, ji, jp, jc_sf, jc_sm, ji_sf, ji_sm, jp_sf,
                             jp_sm, layout, obs_cam, obs_group, pt_order,
                             pt_start, vc, vg, u, wp, M, P, Np, stream);
}

int schur_groups_pass1_bf16(const void* jc, const void* ji, const void* jp,
                            long long jc_sf, long long jc_sm, long long ji_sf,
                            long long ji_sm, long long jp_sf, long long jp_sm,
                            int layout, const int* obs_cam,
                            const int* obs_group, const int* pt_order,
                            const int* pt_start, const float* vc,
                            const float* vg, float* u, float* wp,
                            long long M, int P, int Np, void* stream) {
  return launch_pass1<__nv_bfloat16>(
      jc, ji, jp, jc_sf, jc_sm, ji_sf, ji_sm, jp_sf, jp_sm, layout, obs_cam,
      obs_group, pt_order, pt_start, vc, vg, u, wp, M, P, Np, stream);
}

int schur_groups_pass2_f32(const void* jc, const void* ji, const void* jp,
                           long long jc_sf, long long jc_sm, long long ji_sf,
                           long long ji_sm, long long jp_sf, long long jp_sm,
                           const int* obs_pt, const float* u, const float* zp,
                           const int* cam_order, const int* cam_start,
                           const int* grp_order, const int* grp_start,
                           float* y_work, float* g_work, float* yc, float* yg,
                           long long M, int P, int Nc, int Ng, void* stream) {
  return launch_pass2<float>(jc, ji, jp, jc_sf, jc_sm, ji_sf, ji_sm, jp_sf,
                             jp_sm, obs_pt, u, zp, cam_order, cam_start,
                             grp_order, grp_start, y_work, g_work, yc, yg, M,
                             P, Nc, Ng, stream);
}

int schur_groups_pass2_bf16(const void* jc, const void* ji, const void* jp,
                            long long jc_sf, long long jc_sm, long long ji_sf,
                            long long ji_sm, long long jp_sf, long long jp_sm,
                            const int* obs_pt, const float* u,
                            const float* zp, const int* cam_order,
                            const int* cam_start, const int* grp_order,
                            const int* grp_start, float* y_work,
                            float* g_work, float* yc, float* yg, long long M,
                            int P, int Nc, int Ng, void* stream) {
  return launch_pass2<__nv_bfloat16>(
      jc, ji, jp, jc_sf, jc_sm, ji_sf, ji_sm, jp_sf, jp_sm, obs_pt, u, zp,
      cam_order, cam_start, grp_order, grp_start, y_work, g_work, yc, yg, M,
      P, Nc, Ng, stream);
}

}  // extern "C"
