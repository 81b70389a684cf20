// Schur-complement matvec observation sweeps for the bundle adjuster's
// PCG loop, for Hopper (sm_90a). Built with a plain C interface and
// loaded through ctypes (theiasfm_tpu_torch/_kernels.py); the wrappers
// and their plain PyTorch versions are in sfm/ba/fused_matvec.py.
//
// One matrix-free product S·v of the reduced camera system is
//   pass 1:  u  = Jc·vc[cam] + Ji·vg           per observation (2,)
//            wp[pt] += Jpᵀu                     per point       (3,)
//   glue:    zp = Hpp⁻¹ wp                      (torch, between passes)
//   pass 2:  d  = u − Jp·zp[pt]
//            yc[cam] += Jcᵀd                    per camera      (6,)
//            yg      += Jiᵀd  (as (2P, 2))      shared intrinsics group
//
// schur_pass1 replaces theiasfm_tpu/sfm/ba/pallas_matvec.py
// _pass1_t_kernel (:259) and its row-layout twin _pass1_kernel (:147);
// schur_pass2 replaces _pass2_t_kernel (:333) and _pass2_kernel (:203).
// The jacobians come as any strided (F, M) view — a (12, M) tensor or
// the .T of an (M, 12) one — so one kernel serves both layouts.
//
// What bounds them on this card: bytes. Each pass reads the three
// jacobians (18 + 2P values per observation: 40 bytes at P = 1 in bf16,
// 80 in f32) plus int32 ids and 8 bytes of u (written by pass 1, read by
// pass 2). It does 45–55 operations per observation: under 1 µs at the
// H100 SXM's 67 TFLOP/s f32 rate for 560,128 observations, against
// about 10 µs per pass for its inputs at the published 3.35 TB/s. The
// design therefore reads every jacobian element exactly once, coalesced
// along M in the transposed layout:
//
// * The TPU kernels rely on the sequential TPU grid (overlapping point
//   windows accumulated by an unguarded read-modify-write; camera sums
//   carried in one VMEM scratch across the grid). Blocks here run
//   concurrently and in no order.
// * Point side (pass 1): observations are sorted by point, so each warp
//   reduces every run of equal point ids with a segmented shuffle scan
//   and only the run's first lane issues the three atomicAdds. Runs are
//   found from adjacent ids, so an unsorted order stays correct (it only
//   makes runs shorter). No cumsum-and-difference: that cancels
//   catastrophically on monotone sums.
// * Pass 2 runs in two stages and takes no atomics, so two launches on
//   the same inputs give the same bits. Stage A (schur_pass2_obs), in
//   point order: d and the six products y = Jcᵀd per observation, written
//   as one 24-byte row of an (M, 6) f32 workspace; the 4P group products
//   Jiᵀd summed in registers across the grid-stride loop, warp-reduced
//   once at the end and stored as one partial per block. Stage B
//   (schur_pass2_cam): 1–8 warps per camera (about 4 rows per lane on
//   average) sum its rows of y in the order of the camera index
//   (cam_order, a stable argsort of obs_cam, with cam_start the segment
//   starts; built once per solve), lane by lane, then by a butterfly and
//   across the camera's warps in warp order, and store yc once; one more
//   block sums the group partials in block order into yg. The same path serves
//   every camera count. An earlier design added every product into
//   shared- or device-memory camera slots with atomics: 6 per
//   observation, plus a flush of every block's (Nc, 6) partial.
// * Stage A moves about 88 bytes per observation in bf16 (40 of
//   jacobians, 4 of point id, 8 of u, 12 of zp, 24 of y written) and
//   stage B about 36 (4 of index, a 24-byte row gathered as some 32 bytes
//   of sectors): some 70 MB, 0.021 ms at 3.35 TB/s, at 560,128
//   observations, twice the inputs' own bytes. (Rows padded to one
//   32-byte sector measured no faster.) At Notre-Dame the workspace
//   (13 MB) stays in the 50 MB L2; at 5M observations it does not, and
//   stage B's gather of random rows from device memory costs as much as
//   stage A.
//
// Rounding follows the TPU kernels so that the bf16 path means the same
// thing: vc is gathered in f32 and the gathered row rounded to the
// matvec type (rounding vc first slowed LM convergence); u is rounded
// before forming Jpᵀu; zp[pt] and d are rounded before their products;
// vg is rounded to the matvec type. Products are formed in f32 from the
// (possibly bf16) inputs and every sum accumulates in f32 — the TPU
// multiplies bf16 values in bf16, so the two differ by at most one bf16
// ulp per product. Pass 1's atomic point sums make their summation order,
// and so their last f32 bits, vary from run to run; pass 2's do not.
//
// The kernels allocate nothing: the wrapper hands in the outputs (wp
// zero-filled, the rest written whole), pass 2's workspaces (allocated
// once per solve with the camera index) and the stream (PyTorch's
// current stream), and each entry point returns cudaGetLastError() for
// the wrapper to check. No entry point queries the device: pass 2's grid
// is the block capacity of g_work, sized once per device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPass1Threads = 256;
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

template <typename T>
__global__ void __launch_bounds__(kPass1Threads)
schur_pass1_kernel(const T* __restrict__ jc, const T* __restrict__ ji,
                   const T* __restrict__ jp, long long jc_sf, long long jc_sm,
                   long long ji_sf, long long ji_sm, long long jp_sf,
                   long long jp_sm, const int* __restrict__ obs_cam,
                   const int* __restrict__ obs_pt,
                   const float* __restrict__ vc, const float* __restrict__ vg,
                   float* __restrict__ u, float* __restrict__ wp, long long M,
                   int P) {
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool valid = m < M;
  int pt = -1;
  float t0 = 0.f, t1 = 0.f, t2 = 0.f;
  if (valid) {
    const long long cam = obs_cam[m];
    pt = obs_pt[m];
    const long long jc_m = m * jc_sm;
    float u0 = 0.f, u1 = 0.f;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float v = round_mv<T>(vc[cam * 6 + i]);
      u0 += load(jc, i * jc_sf + jc_m) * v;
      u1 += load(jc, (6 + i) * jc_sf + jc_m) * v;
    }
    const long long ji_m = m * ji_sm;
    float g0 = 0.f, g1 = 0.f;
    for (int p = 0; p < P; ++p) {
      const float v = round_mv<T>(vg[p]);
      g0 += load(ji, p * ji_sf + ji_m) * v;
      g1 += load(ji, (P + p) * ji_sf + ji_m) * v;
    }
    u0 += g0;
    u1 += g1;
    u[m] = u0;
    u[M + m] = u1;
    const float a = round_mv<T>(u0);
    const float b = round_mv<T>(u1);
    const long long jp_m = m * jp_sm;
    t0 = load(jp, 0 * jp_sf + jp_m) * a + load(jp, 3 * jp_sf + jp_m) * b;
    t1 = load(jp, 1 * jp_sf + jp_m) * a + load(jp, 4 * jp_sf + jp_m) * b;
    t2 = load(jp, 2 * jp_sf + jp_m) * a + load(jp, 5 * jp_sf + jp_m) * b;
  }
  // Segmented suffix scan over runs of equal point ids inside the warp:
  // after it, each run's first lane holds the run's sum. A run is the
  // lanes [head, next head); heads come from adjacent ids only.
  const int prev_pt = __shfl_up_sync(kFull, pt, 1);
  const bool head = lane == 0 || prev_pt != pt;
  const unsigned heads = __ballot_sync(kFull, head);
  const unsigned above = heads & ~(kFull >> (31 - lane));  // lanes > lane
  const int run_end = above ? __ffs(above) - 1 : 32;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o0 = __shfl_down_sync(kFull, t0, off);
    const float o1 = __shfl_down_sync(kFull, t1, off);
    const float o2 = __shfl_down_sync(kFull, t2, off);
    if (lane + off < run_end) {
      t0 += o0;
      t1 += o1;
      t2 += o2;
    }
  }
  if (valid && head) {
    float* w = wp + (long long)pt * 3;
    atomicAdd(w + 0, t0);
    atomicAdd(w + 1, t1);
    atomicAdd(w + 2, t2);
  }
}

constexpr int kPass2ObsThreads = 256;
constexpr int kPass2CamWarps = 8;  // cameras per block of stage B
constexpr int kMaxP = 10;

// Stage A of pass 2, in point order: y[m] = Jcᵀd (M, 6) and one (4P,)
// partial of Jiᵀd per block, in a fixed order: every thread sums its
// observations of the grid-stride loop, each warp reduces by a butterfly
// and warp partials are added in warp order.
template <typename T, int P>
__global__ void __launch_bounds__(kPass2ObsThreads)
schur_pass2_obs_kernel(const T* __restrict__ jc, const T* __restrict__ ji,
                       const T* __restrict__ jp, long long jc_sf,
                       long long jc_sm, long long ji_sf, long long ji_sm,
                       long long jp_sf, long long jp_sm,
                       const int* __restrict__ obs_pt,
                       const float* __restrict__ u,
                       const float* __restrict__ zp, float* __restrict__ y,
                       float* __restrict__ g_part, long long M) {
  constexpr int G = 4 * P;  // (2P, 2) group values
  constexpr int kWarps = kPass2ObsThreads / 32;
  __shared__ float g_warp[kWarps][G];
  float g[G];
#pragma unroll
  for (int i = 0; i < G; ++i) g[i] = 0.f;
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
#pragma unroll
    for (int f = 0; f < 2 * P; ++f) {
      const float j = load(ji, f * ji_sf + ji_m);
      g[2 * f] += j * a;
      g[2 * f + 1] += j * b;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const float s = warp_sum(g[i]);
    if (lane == 0) g_warp[warp][i] = s;
  }
  __syncthreads();
  if (threadIdx.x < G) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += g_warp[w][threadIdx.x];
    g_part[(long long)blockIdx.x * G + threadIdx.x] = s;
  }
}

// Stage B of pass 2: W warps per camera (W = 1, 2, 4 or 8, from the mean
// segment length) sum the camera's rows of y in cam_order: lane l of
// warp w takes observations l + 32w, l + 32(w + W), ...; then a butterfly
// per warp and the W warp sums in warp order; yc is stored once. The last
// block sums the n_part group partials of stage A in block order, one
// warp per value, into yg.
__global__ void __launch_bounds__(kPass2CamWarps * 32)
schur_pass2_cam_kernel(const float* __restrict__ y,
                       const int* __restrict__ cam_order,
                       const int* __restrict__ cam_start,
                       const float* __restrict__ g_part, int n_part, int G,
                       float* __restrict__ yc, float* __restrict__ yg,
                       int Nc, int W) {
  __shared__ float s_warp[kPass2CamWarps][6];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (blockIdx.x == gridDim.x - 1) {
    for (int v = warp; v < G; v += kPass2CamWarps) {
      float s = 0.f;
      for (int i = lane; i < n_part; i += 32)
        s += g_part[(long long)i * G + v];
      s = warp_sum(s);
      if (lane == 0) yg[v] = s;
    }
    return;
  }
  const int sub = warp % W;
  const int cam = blockIdx.x * (kPass2CamWarps / W) + warp / W;
  float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (cam < Nc) {
    const int lo = cam_start[cam], hi = cam_start[cam + 1];
#pragma unroll 4
    for (int i = lo + 32 * sub + lane; i < hi; i += 32 * W) {
      const float2* row =
          reinterpret_cast<const float2*>(y + (long long)cam_order[i] * 6);
      const float2 r0 = row[0], r1 = row[1], r2 = row[2];
      s[0] += r0.x;
      s[1] += r0.y;
      s[2] += r1.x;
      s[3] += r1.y;
      s[4] += r2.x;
      s[5] += r2.y;
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float v = warp_sum(s[i]);
    if (lane == 0) s_warp[warp][i] = v;
  }
  __syncthreads();
  if (sub == 0 && lane < 6 && cam < Nc) {
    float v = 0.f;
    for (int w = 0; w < W; ++w) v += s_warp[warp + w][lane];
    yc[(long long)cam * 6 + lane] = v;
  }
}

template <typename T>
int launch_pass1(const void* jc, const void* ji, const void* jp,
                 long long jc_sf, long long jc_sm, long long ji_sf,
                 long long ji_sm, long long jp_sf, long long jp_sm,
                 const int* obs_cam, const int* obs_pt, const float* vc,
                 const float* vg, float* u, float* wp, long long M, int P,
                 void* stream) {
  const long long blocks = (M + kPass1Threads - 1) / kPass1Threads;
  schur_pass1_kernel<T><<<(unsigned)blocks, kPass1Threads, 0,
                          (cudaStream_t)stream>>>(
      (const T*)jc, (const T*)ji, (const T*)jp, jc_sf, jc_sm, ji_sf, ji_sm,
      jp_sf, jp_sm, obs_cam, obs_pt, vc, vg, u, wp, M, P);
  return (int)cudaGetLastError();
}

template <typename T, int P>
void launch_pass2_obs(unsigned blocks, cudaStream_t stream, const void* jc,
                      const void* ji, const void* jp, long long jc_sf,
                      long long jc_sm, long long ji_sf, long long ji_sm,
                      long long jp_sf, long long jp_sm, const int* obs_pt,
                      const float* u, const float* zp, float* y,
                      float* g_part, long long M) {
  schur_pass2_obs_kernel<T, P><<<blocks, kPass2ObsThreads, 0, stream>>>(
      (const T*)jc, (const T*)ji, (const T*)jp, jc_sf, jc_sm, ji_sf, ji_sm,
      jp_sf, jp_sm, obs_pt, u, zp, y, g_part, M);
}

// Both stages of pass 2. y_work (M, 6) and g_work (at least part_blocks
// × 4P floats) are the workspaces; stage A runs min(part_blocks, ⌈M/256⌉)
// blocks, so the grid, and with it the order of every sum, is fixed by
// M and the workspace.
template <typename T>
int launch_pass2(const void* jc, const void* ji, const void* jp,
                 long long jc_sf, long long jc_sm, long long ji_sf,
                 long long ji_sm, long long jp_sf, long long jp_sm,
                 const int* obs_pt, const float* u, const float* zp,
                 const int* cam_order, const int* cam_start, float* y_work,
                 float* g_work, float* yc, float* yg, long long M, int P,
                 int Nc, int part_blocks, void* stream) {
  if (P < 1 || P > kMaxP || part_blocks < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long needed = (M + kPass2ObsThreads - 1) / kPass2ObsThreads;
  const unsigned blocks =
      (unsigned)(needed < part_blocks ? needed : part_blocks);
#define PASS2_OBS(PP)                                                       \
  case PP:                                                                  \
    launch_pass2_obs<T, PP>(blocks, s, jc, ji, jp, jc_sf, jc_sm, ji_sf,     \
                            ji_sm, jp_sf, jp_sm, obs_pt, u, zp, y_work,     \
                            g_work, M);                                     \
    break;
  switch (P) {
    PASS2_OBS(1) PASS2_OBS(2) PASS2_OBS(3) PASS2_OBS(4) PASS2_OBS(5)
    PASS2_OBS(6) PASS2_OBS(7) PASS2_OBS(8) PASS2_OBS(9) PASS2_OBS(10)
  }
#undef PASS2_OBS
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // warps per camera: enough that a lane sums about 4 rows on average
  int W = 1;
  while (W < kPass2CamWarps && 32LL * 4 * W * Nc < M) W *= 2;
  const int cams_per_block = kPass2CamWarps / W;
  const unsigned cam_blocks = (Nc + cams_per_block - 1) / cams_per_block + 1;
  schur_pass2_cam_kernel<<<cam_blocks, kPass2CamWarps * 32, 0, s>>>(
      y_work, cam_order, cam_start, g_work, (int)blocks, 4 * P, yc, yg, Nc,
      W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int schur_pass1_f32(const void* jc, const void* ji, const void* jp,
                    long long jc_sf, long long jc_sm, long long ji_sf,
                    long long ji_sm, long long jp_sf, long long jp_sm,
                    const int* obs_cam, const int* obs_pt, const float* vc,
                    const float* vg, float* u, float* wp, long long M, int P,
                    void* stream) {
  return launch_pass1<float>(jc, ji, jp, jc_sf, jc_sm, ji_sf, ji_sm, jp_sf,
                             jp_sm, obs_cam, obs_pt, vc, vg, u, wp, M, P,
                             stream);
}

int schur_pass1_bf16(const void* jc, const void* ji, const void* jp,
                     long long jc_sf, long long jc_sm, long long ji_sf,
                     long long ji_sm, long long jp_sf, long long jp_sm,
                     const int* obs_cam, const int* obs_pt, const float* vc,
                     const float* vg, float* u, float* wp, long long M, int P,
                     void* stream) {
  return launch_pass1<__nv_bfloat16>(jc, ji, jp, jc_sf, jc_sm, ji_sf, ji_sm,
                                     jp_sf, jp_sm, obs_cam, obs_pt, vc, vg, u,
                                     wp, M, P, stream);
}

int schur_pass2_f32(const void* jc, const void* ji, const void* jp,
                    long long jc_sf, long long jc_sm, long long ji_sf,
                    long long ji_sm, long long jp_sf, long long jp_sm,
                    const int* obs_pt, const float* u, const float* zp,
                    const int* cam_order, const int* cam_start, float* y_work,
                    float* g_work, float* yc, float* yg, long long M, int P,
                    int Nc, int part_blocks, void* stream) {
  return launch_pass2<float>(jc, ji, jp, jc_sf, jc_sm, ji_sf, ji_sm, jp_sf,
                             jp_sm, obs_pt, u, zp, cam_order, cam_start,
                             y_work, g_work, yc, yg, M, P, Nc, part_blocks,
                             stream);
}

int schur_pass2_bf16(const void* jc, const void* ji, const void* jp,
                     long long jc_sf, long long jc_sm, long long ji_sf,
                     long long ji_sm, long long jp_sf, long long jp_sm,
                     const int* obs_pt, const float* u, const float* zp,
                     const int* cam_order, const int* cam_start,
                     float* y_work, float* g_work, float* yc, float* yg,
                     long long M, int P, int Nc, int part_blocks,
                     void* stream) {
  return launch_pass2<__nv_bfloat16>(
      jc, ji, jp, jc_sf, jc_sm, ji_sf, ji_sm, jp_sf, jp_sm, obs_pt, u, zp,
      cam_order, cam_start, y_work, g_work, yc, yg, M, P, Nc, part_blocks,
      stream);
}

}  // extern "C"
