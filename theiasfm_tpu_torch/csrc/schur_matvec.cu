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
// 80 in f32) plus two int32 ids and 8 bytes of u (written by pass 1,
// read by pass 2): 56 bytes per observation in bf16. It does 45–55
// operations per observation. At 560,128 observations that is about
// 33 MB per pass, about 10 µs at the H100 SXM's published 3.35 TB/s;
// the operations need under 1 µs at its 67 TFLOP/s f32 rate. The design therefore reads every jacobian
// element exactly once, coalesced along M in the transposed layout, and
// keeps the reductions off device memory as far as it can:
//
// * The TPU kernels rely on the sequential TPU grid (overlapping point
//   windows accumulated by an unguarded read-modify-write; camera sums
//   carried in one VMEM scratch across the grid). Blocks here run
//   concurrently and in no order, so every cross-block sum is atomic.
// * Point side (pass 1): observations are sorted by point, so each warp
//   reduces every run of equal point ids with a segmented shuffle scan
//   and only the run's first lane issues the three atomicAdds. Runs are
//   found from adjacent ids, so an unsorted order stays correct (it only
//   makes runs shorter). No cumsum-and-difference: that cancels
//   catastrophically on monotone sums.
// * Camera side (pass 2): camera ids are random. When an (Nc, 6) f32
//   partial fits in the block's shared memory (Nc·24 bytes, up to about
//   9,400 cameras in the 227 KB opt-in limit), a grid of one or two
//   1024-thread blocks per SM accumulates with shared-memory atomics and
//   flushes each non-zero partial with one global atomic. Above that the
//   kernel adds straight into global memory. The choice is made from
//   Nc and the device limit (schur_pass2_shared_cams) and the wrapper
//   reports it.
// * Group side (pass 2): each warp reduces its 4P products with
//   butterfly shuffles into a per-warp shared slot; one atomic per value
//   per block at the end.
//
// Rounding follows the TPU kernels so that the bf16 path means the same
// thing: vc is gathered in f32 and the gathered row rounded to the
// matvec type (rounding vc first slowed LM convergence); u is rounded
// before forming Jpᵀu; zp[pt] and d are rounded before their products;
// vg is rounded to the matvec type. Products are formed in f32 from the
// (possibly bf16) inputs and every sum accumulates in f32 — the TPU
// multiplies bf16 values in bf16, so the two differ by at most one bf16
// ulp per product. Atomic sums make the summation order, and so the
// last f32 bits, vary from run to run.
//
// The kernels allocate nothing: the wrapper hands in zero-filled outputs
// and the stream (PyTorch's current stream), and each entry point
// returns cudaGetLastError() for the wrapper to check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPass1Threads = 256;
constexpr int kPass2Threads = 1024;
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

// kSharedCams: accumulate the (Nc, 6) camera sums in shared memory and
// flush once per block; otherwise add straight into global memory.
// Dynamic shared memory: [Nc * 6 camera partials if kSharedCams]
// [warps * 4P group partials].
template <typename T, bool kSharedCams>
__global__ void __launch_bounds__(kPass2Threads)
schur_pass2_kernel(const T* __restrict__ jc, const T* __restrict__ ji,
                   const T* __restrict__ jp, long long jc_sf, long long jc_sm,
                   long long ji_sf, long long ji_sm, long long jp_sf,
                   long long jp_sm, const int* __restrict__ obs_cam,
                   const int* __restrict__ obs_pt,
                   const float* __restrict__ u, const float* __restrict__ zp,
                   float* __restrict__ yc, float* __restrict__ yg, long long M,
                   int P, int Nc) {
  extern __shared__ float smem[];
  const int n_cam_s = kSharedCams ? Nc * 6 : 0;
  const int G = 4 * P;  // (2P, 2) group values
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  float* yc_s = smem;
  float* yg_s = smem + n_cam_s;  // [warp][G]
  for (int i = threadIdx.x; i < n_cam_s + n_warps * G; i += blockDim.x)
    smem[i] = 0.f;
  __syncthreads();
  float* yc_dst = kSharedCams ? yc_s : yc;

  const long long stride = (long long)gridDim.x * blockDim.x;
  // every lane of a warp runs the same number of iterations (the bound
  // is rounded up to a whole warp) so the group shuffles stay converged
  const long long M_warp = (M + 31) / 32 * 32;
  for (long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       m < M_warp; m += stride) {
    const bool valid = m < M;
    float a = 0.f, b = 0.f;
    if (valid) {
      const long long cam = obs_cam[m];
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
      a = round_mv<T>(u[m] - u20);
      b = round_mv<T>(u[M + m] - u21);
      const long long jc_m = m * jc_sm;
      float* yc_cam = yc_dst + cam * 6;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float y = load(jc, i * jc_sf + jc_m) * a +
                        load(jc, (6 + i) * jc_sf + jc_m) * b;
        atomicAdd(yc_cam + i, y);
      }
    }
    const long long ji_m = m * ji_sm;
    for (int f = 0; f < 2 * P; ++f) {
      const float j = valid ? load(ji, f * ji_sf + ji_m) : 0.f;
      const float s0 = warp_sum(j * a);
      const float s1 = warp_sum(j * b);
      if (lane == 0) {
        yg_s[warp * G + 2 * f] += s0;
        yg_s[warp * G + 2 * f + 1] += s1;
      }
    }
  }
  __syncthreads();
  if (kSharedCams) {
    for (int i = threadIdx.x; i < n_cam_s; i += blockDim.x) {
      const float v = yc_s[i];
      if (v != 0.f) atomicAdd(yc + i, v);
    }
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < n_warps; ++w) s += yg_s[w * G + g];
    atomicAdd(yg + g, s);
  }
}

int smem_optin_limit() {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return limit;
}

size_t pass2_group_bytes(int P) {
  return (size_t)(kPass2Threads / 32) * 4 * P * sizeof(float);
}

bool pass2_shared_cams(int Nc, int P) {
  return (size_t)Nc * 6 * sizeof(float) + pass2_group_bytes(P) <=
         (size_t)smem_optin_limit();
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

template <typename T, bool kSharedCams>
int launch_pass2_path(const void* jc, const void* ji, const void* jp,
                      long long jc_sf, long long jc_sm, long long ji_sf,
                      long long ji_sm, long long jp_sf, long long jp_sm,
                      const int* obs_cam, const int* obs_pt, const float* u,
                      const float* zp, float* yc, float* yg, long long M,
                      int P, int Nc, void* stream) {
  auto kernel = schur_pass2_kernel<T, kSharedCams>;
  const size_t smem =
      (kSharedCams ? (size_t)Nc * 6 * sizeof(float) : 0) +
      pass2_group_bytes(P);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kPass2Threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;
  const long long needed = (M + kPass2Threads - 1) / kPass2Threads;
  long long blocks = (long long)sms * per_sm;
  if (needed < blocks) blocks = needed;
  kernel<<<(unsigned)blocks, kPass2Threads, smem, (cudaStream_t)stream>>>(
      (const T*)jc, (const T*)ji, (const T*)jp, jc_sf, jc_sm, ji_sf, ji_sm,
      jp_sf, jp_sm, obs_cam, obs_pt, u, zp, yc, yg, M, P, Nc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pass2(const void* jc, const void* ji, const void* jp,
                 long long jc_sf, long long jc_sm, long long ji_sf,
                 long long ji_sm, long long jp_sf, long long jp_sm,
                 const int* obs_cam, const int* obs_pt, const float* u,
                 const float* zp, float* yc, float* yg, long long M, int P,
                 int Nc, void* stream) {
  if (pass2_shared_cams(Nc, P))
    return launch_pass2_path<T, true>(jc, ji, jp, jc_sf, jc_sm, ji_sf, ji_sm,
                                      jp_sf, jp_sm, obs_cam, obs_pt, u, zp,
                                      yc, yg, M, P, Nc, stream);
  return launch_pass2_path<T, false>(jc, ji, jp, jc_sf, jc_sm, ji_sf, ji_sm,
                                     jp_sf, jp_sm, obs_cam, obs_pt, u, zp, yc,
                                     yg, M, P, Nc, stream);
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
                    const int* obs_cam, const int* obs_pt, const float* u,
                    const float* zp, float* yc, float* yg, long long M, int P,
                    int Nc, void* stream) {
  return launch_pass2<float>(jc, ji, jp, jc_sf, jc_sm, ji_sf, ji_sm, jp_sf,
                             jp_sm, obs_cam, obs_pt, u, zp, yc, yg, M, P, Nc,
                             stream);
}

int schur_pass2_bf16(const void* jc, const void* ji, const void* jp,
                     long long jc_sf, long long jc_sm, long long ji_sf,
                     long long ji_sm, long long jp_sf, long long jp_sm,
                     const int* obs_cam, const int* obs_pt, const float* u,
                     const float* zp, float* yc, float* yg, long long M, int P,
                     int Nc, void* stream) {
  return launch_pass2<__nv_bfloat16>(jc, ji, jp, jc_sf, jc_sm, ji_sf, ji_sm,
                                     jp_sf, jp_sm, obs_cam, obs_pt, u, zp, yc,
                                     yg, M, P, Nc, stream);
}

// 1 when pass 2 keeps the (Nc, 6) camera partial in shared memory on the
// current device, 0 when it adds straight into global memory.
int schur_pass2_shared_cams(int Nc, int P) {
  return pass2_shared_cams(Nc, P) ? 1 : 0;
}

}  // extern "C"
