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
// published 3.35 TB/s. The design reads each input once, coalesced along
// the observations, and keeps the sums off device memory as far as it can:
//
// * The TPU kernel relies on the sequential TPU grid: it adds its point
//   sums into overlapping point windows with an unguarded read-modify-
//   write and carries the camera sums and X, Y in VMEM scratch across the
//   grid. Blocks here run concurrently and in no order, so every sum that
//   crosses blocks is atomic.
// * Point side: observations are sorted by point, so each warp reduces
//   every run of equal point ids with a segmented shuffle scan and only the
//   run's first lane issues the twelve atomicAdds (schur_pass1's scheme).
//   Runs are found from adjacent ids, so an unsorted order stays correct.
//   No cumsum-and-difference: that cancels catastrophically on the
//   monotone Hpp sums.
// * Camera side: camera ids are random. When an (Nc, 42) f32 partial fits
//   in the block's shared memory (Nc·168 bytes, up to about 1,370 cameras
//   in the 227 KB opt-in limit), a grid of at most one or two 1024-thread
//   blocks per SM accumulates with shared-memory atomics and flushes each
//   non-zero partial with one global atomic. Above that the kernel adds
//   straight into device memory. ba_blocks_shared_cams reports the choice.
// * Group side (X, Y): each warp reduces its products with butterfly
//   shuffles into a per-warp shared slot (the upper triangle of X, mirrored
//   when stored); one atomic per value per block at the end. They are not
//   left to a library GEMM.
//
// Everything is f32, as on the TPU (FusedBlocks forces f32): products and
// sums in f32. Atomic sums make the summation order, and so the last f32
// bits, vary from run to run.
//
// The kernel allocates nothing: the wrapper hands in zero-filled outputs
// and the stream (PyTorch's current stream). The device attributes and the
// launch grid are looked up once per (device, shared-memory size) and
// cached; each entry point returns cudaGetLastError() (or the error of a
// failed query) for the wrapper to check.

#include <cuda_runtime.h>

#include <map>
#include <utility>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxP = 10;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Strides are (row stride along m, column stride along f) of each input.
// kSharedCams: accumulate the (Nc, 42) camera sums in shared memory and
// flush once per block; otherwise add straight into global memory.
// Dynamic shared memory: [Nc * 42 camera partials if kSharedCams]
// [warps * G group partials], G = 4P² + 4P (X then Y).
template <bool kSharedCams>
__global__ void __launch_bounds__(kThreads)
ba_blocks_kernel(const float* __restrict__ jc, const float* __restrict__ ji,
                 const float* __restrict__ jp, const float* __restrict__ r,
                 long long jc_sm, long long jc_sf, long long ji_sm,
                 long long ji_sf, long long jp_sm, long long jp_sf,
                 long long r_sm, long long r_sf,
                 const int* __restrict__ obs_cam,
                 const int* __restrict__ obs_pt, float* __restrict__ pt_out,
                 float* __restrict__ cam_out, float* __restrict__ x_out,
                 float* __restrict__ y_out, long long M, int P, int Nc) {
  extern __shared__ float smem[];
  const int n_cam_s = kSharedCams ? Nc * 42 : 0;
  const int P2 = 2 * P;
  const int GX = P2 * P2;
  const int G = GX + 2 * P2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  float* cam_s = smem;
  float* grp_s = smem + n_cam_s;  // [warp][G]
  for (int i = threadIdx.x; i < n_cam_s + n_warps * G; i += blockDim.x)
    smem[i] = 0.f;
  __syncthreads();
  float* cam_dst = kSharedCams ? cam_s : cam_out;

  const long long stride = (long long)gridDim.x * blockDim.x;
  // every lane of a warp runs the same number of iterations (the bound is
  // rounded up to a whole warp) so the shuffles stay converged
  const long long M_warp = (M + 31) / 32 * 32;
  for (long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       m < M_warp; m += stride) {
    const bool valid = m < M;
    int pt = -1;
    float r0 = 0.f, r1 = 0.f;
    float p[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) p[k] = 0.f;
    if (valid) {
      pt = obs_pt[m];
      r0 = r[m * r_sm];
      r1 = r[m * r_sm + r_sf];
#pragma unroll
      for (int k = 0; k < 6; ++k) p[k] = jp[m * jp_sm + k * jp_sf];
      // camera side: [Jcᵀ Jc | Jcᵀ r] straight into the partial
      float c[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) c[k] = jc[m * jc_sm + k * jc_sf];
      float* dst = cam_dst + (long long)obs_cam[m] * 42;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = 0; b < 6; ++b)
          atomicAdd(dst + 6 * a + b, c[a] * c[b] + c[6 + a] * c[6 + b]);
        atomicAdd(dst + 36 + a, c[a] * r0 + c[6 + a] * r1);
      }
    }

    // point side: [Jpᵀ Jp | Jpᵀ r], one sum per run of equal point ids
    float t[12];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b)
        t[3 * a + b] = p[a] * p[b] + p[3 + a] * p[3 + b];
      t[9 + a] = p[a] * r0 + p[3 + a] * r1;
    }
    // segmented suffix scan: after it each run's first lane holds the
    // run's sum. A run is the lanes [head, next head).
    const int prev_pt = __shfl_up_sync(kFull, pt, 1);
    const bool head = lane == 0 || prev_pt != pt;
    const unsigned heads = __ballot_sync(kFull, head);
    const unsigned above = heads & ~(kFull >> (31 - lane));  // lanes > lane
    const int run_end = above ? __ffs(above) - 1 : 32;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < 12; ++k) {
        const float o = __shfl_down_sync(kFull, t[k], off);
        if (lane + off < run_end) t[k] += o;
      }
    }
    if (valid && head) {
      float* w = pt_out + (long long)pt * 12;
#pragma unroll
      for (int k = 0; k < 12; ++k) atomicAdd(w + k, t[k]);
    }

    // group side: X = Jiᵀ Ji (upper triangle), Y = Jiᵀ r
    float j[2 * kMaxP];
    for (int f = 0; f < P2; ++f)
      j[f] = valid ? ji[m * ji_sm + f * ji_sf] : 0.f;
    float* gs = grp_s + warp * G;
    for (int f = 0; f < P2; ++f) {
      for (int g = f; g < P2; ++g) {
        const float s = warp_sum(j[f] * j[g]);
        if (lane == 0) gs[f * P2 + g] += s;
      }
      const float s0 = warp_sum(j[f] * r0);
      const float s1 = warp_sum(j[f] * r1);
      if (lane == 0) {
        gs[GX + 2 * f] += s0;
        gs[GX + 2 * f + 1] += s1;
      }
    }
  }
  __syncthreads();
  if (kSharedCams) {
    for (int i = threadIdx.x; i < n_cam_s; i += blockDim.x) {
      const float v = cam_s[i];
      if (v != 0.f) atomicAdd(cam_out + i, v);
    }
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < n_warps; ++w) s += grp_s[w * G + g];
    if (g < GX) {
      const int f = g / P2, h = g % P2;
      if (h < f) continue;  // the lower triangle mirrors the upper
      atomicAdd(x_out + g, s);
      if (h != f) atomicAdd(x_out + h * P2 + f, s);
    } else {
      atomicAdd(y_out + (g - GX), s);
    }
  }
}

struct DeviceInfo {
  int sms = 0;
  int smem_optin = 0;
};

cudaError_t device_info(DeviceInfo* out) {
  static std::map<int, DeviceInfo> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  auto it = cache.find(dev);
  if (it == cache.end()) {
    DeviceInfo info;
    err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(
        &info.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    it = cache.emplace(dev, info).first;
  }
  *out = it->second;
  return cudaSuccess;
}

size_t group_bytes(int P) {
  return (size_t)(kThreads / 32) * (4 * P * P + 4 * P) * sizeof(float);
}

size_t cam_bytes(int Nc) { return (size_t)Nc * 42 * sizeof(float); }

// Blocks per SM of the kernel at this shared-memory size, on the current
// device; cudaFuncSetAttribute and the occupancy query run once per
// (device, path, size).
template <bool kSharedCams>
cudaError_t blocks_per_sm(int dev, size_t smem, int* per_sm) {
  static std::map<std::pair<int, size_t>, int> cache;
  const auto key = std::make_pair(dev, smem);
  auto it = cache.find(key);
  if (it == cache.end()) {
    auto kernel = ba_blocks_kernel<kSharedCams>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                        smem);
    if (err != cudaSuccess) return err;
    it = cache.emplace(key, n < 1 ? 1 : n).first;
  }
  *per_sm = it->second;
  return cudaSuccess;
}

template <bool kSharedCams>
int launch(const float* jc, const float* ji, const float* jp, const float* r,
           const long long* strides, const int* obs_cam, const int* obs_pt,
           float* pt_out, float* cam_out, float* x_out, float* y_out,
           long long M, int P, int Nc, int sms, void* stream) {
  const size_t smem = (kSharedCams ? cam_bytes(Nc) : 0) + group_bytes(P);
  int dev = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = blocks_per_sm<kSharedCams>(dev, smem, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const long long needed = (M + kThreads - 1) / kThreads;
  long long blocks = (long long)sms * per_sm;
  if (needed < blocks) blocks = needed;
  ba_blocks_kernel<kSharedCams><<<(unsigned)blocks, kThreads, smem,
                                  (cudaStream_t)stream>>>(
      jc, ji, jp, r, strides[0], strides[1], strides[2], strides[3],
      strides[4], strides[5], strides[6], strides[7], obs_cam, obs_pt, pt_out,
      cam_out, x_out, y_out, M, P, Nc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 when the (Nc, 42) camera partial lives in shared memory on the current
// device, 0 when the kernel adds straight into global memory, negative (a
// cudaError) when the device query fails.
int ba_blocks_shared_cams(int Nc, int P) {
  DeviceInfo info;
  const cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return -(int)err;
  return cam_bytes(Nc) + group_bytes(P) <= (size_t)info.smem_optin ? 1 : 0;
}

// jc (M, 12), ji (M, 2P), jp (M, 6), r (M, 2): f32 with the given strides
// (row, column) each; obs_cam, obs_pt (M,) int32. Outputs zero-filled:
// pt_out (Np, 12), cam_out (Nc, 42), x_out (2P, 2P), y_out (2P, 2).
int ba_blocks_f32(const float* jc, const float* ji, const float* jp,
                  const float* r, long long jc_sm, long long jc_sf,
                  long long ji_sm, long long ji_sf, long long jp_sm,
                  long long jp_sf, long long r_sm, long long r_sf,
                  const int* obs_cam, const int* obs_pt, float* pt_out,
                  float* cam_out, float* x_out, float* y_out, long long M,
                  int P, int Nc, void* stream) {
  if (P < 1 || P > kMaxP) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  DeviceInfo info;
  const cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return (int)err;
  const long long strides[8] = {jc_sm, jc_sf, ji_sm, ji_sf,
                                jp_sm, jp_sf, r_sm,  r_sf};
  if (cam_bytes(Nc) + group_bytes(P) <= (size_t)info.smem_optin)
    return launch<true>(jc, ji, jp, r, strides, obs_cam, obs_pt, pt_out,
                        cam_out, x_out, y_out, M, P, Nc, info.sms, stream);
  return launch<false>(jc, ji, jp, r, strides, obs_cam, obs_pt, pt_out,
                       cam_out, x_out, y_out, M, P, Nc, info.sms, stream);
}

}  // extern "C"
