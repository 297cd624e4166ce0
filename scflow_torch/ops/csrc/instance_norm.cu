// Instance-norm forward and backward for Hopper (sm_90a); the backward's
// note is above its kernel, further down.
//
// Replaces the Pallas TPU kernel `_in_kernel` of
// scflow_tpu/ops/fused_norm.py (launched from `_instance_norm_fwd_impl`).
//
// What it computes, for each (sample, channel) plane of an NCHW activation:
// the f32 mean and biased variance over H*W, then
// y = (x - mean) * rsqrt(var + eps) * scale[c] + bias[c], cast back to the
// type of x (f32 or bf16), with one read and one write of device memory.
// It takes every contiguous plane: any H*W >= 1 at any element-aligned base.
//
// What bounds it on this card: device-memory bytes. It does ~8 FP32
// operations per element against 4 (f32) or 2 (bf16) bytes read plus the
// same written, far below the H100's ~20 FP32 operations per byte, so the
// bound is 2 * numel * sizeof(x) over 3.35 TB/s.
//
// Three forms, chosen per launch by the entry from H*W and the pointers'
// alignment (`pick_form`; it reports the choice to the caller):
//  0. vector form: planes of at most kMaxPlane (57,344) elements, H*W a
//     multiple of 8 and every pointer 16-byte aligned (every plane of the
//     SCFlow and RAFT encoders at 256-pixel crops). One CTA of 256 threads
//     per plane loads it once from device memory into dynamic shared
//     memory (at most 224 KB; the attribute for more than 48 KB is set
//     before the launch) with 16-byte vector loads; the statistics take
//     two passes over shared memory, the mean and then sum((x - mean)^2),
//     as the reference `_reference_in` computes them, in f32, reduced with
//     warp shuffles and one shared-memory step; the output is written once
//     with 16-byte stores. 2048 to 4096 CTAs per launch at batch 32 keep
//     all SMs busy; three 64 KB planes fit an SM at once.
//  1. general form: the other planes of at most kMaxPlane elements (an odd
//     H*W such as 7x7 or 13x17, a base that is not 16-byte aligned, a view
//     with a storage offset), and planes past what a cluster holds. One
//     CTA per plane of 32 to 1024 threads (about 8 elements a thread), each
//     thread on elements t, t + T, ...: every load and store is a
//     coalesced scalar access, so no alignment of x, y (or g, dx) and no
//     length is special. The plane (its first kMaxPlane elements) is
//     staged in shared memory; the rest of a plane past kMaxCluster *
//     kMaxPlane (458,752) elements is streamed: read again from device
//     memory by the variance and output passes. Two-pass f32 statistics.
//  2. cluster form: planes of kMaxPlane < H*W <= 458,752 elements (the
//     240x240 and 256x256 stems of 480- and 512-pixel crops, the 240x320
//     half-resolution plane of a 480x640 frame). A thread-block cluster of
//     2 to 8 CTAs (the portable size) shares a plane, each of 512 threads
//     staging a slice of about 16K elements (64 KB, three CTAs an SM); the
//     slices' partial sums meet through distributed shared memory (thread
//     0 of each CTA reads every CTA's sum in rank order, so the result is
//     deterministic), twice for the two-pass statistics (three times
//     backward). The plane is read once and written once, in 16-byte
//     vectors where a slice's pointers are 16-byte aligned (slices start
//     at multiples of 8 elements), else in coalesced scalars.
// Bound of every form: 2 * numel * sizeof(x) bytes forward (3 * numel
// backward) over 3.35 TB/s; the streamed part of a general-form plane adds
// 2 * (H*W - kMaxPlane) * sizeof(x) per plane (3 forward reads of it).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// largest plane staged whole in shared memory, f32 (224 KB of the 227 KB a
// block may use)
constexpr int kMaxPlane = 56 * 1024;
constexpr int kMaxThreads = 1024;
// the cluster form: up to 8 CTAs (the portable cluster size) share a plane,
// each staging a slice of at most kMaxPlane elements; slices of about
// kClusterSlice elements keep three CTAs of 512 threads on an SM
constexpr int kMaxCluster = 8;
constexpr int kClusterSlice = 16 * 1024;
constexpr int kClusterThreads = 512;

__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += scratch[w];
  __syncthreads();  // scratch is reused by the next reduction
  return total;
}

// 16 bytes of T as floats, and back
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int n = 4;
  __device__ static void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
instance_norm_fwd_kernel(const T* __restrict__ x,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, T* __restrict__ y,
                         int channels, int hw, float eps) {
  extern __shared__ float4 smem4[];  // the plane, as float4
  __shared__ float scratch[kWarps];
  constexpr int V = Pack<T>::n;

  const size_t base = (size_t)blockIdx.x * hw;
  const int c = blockIdx.x % channels;
  const int nvec = hw / V;

  float sum = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    float v[V];
    Pack<T>::load(x + base + (size_t)i * V, v);
#pragma unroll
    for (int q = 0; q < V; ++q) sum += v[q];
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      smem4[i * (V / 4) + q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
  const float mean = block_sum(sum, scratch) / hw;

  float sq = 0.f;
  for (int i = threadIdx.x; i < hw / 4; i += kThreads) {
    const float4 q = smem4[i];
    const float d0 = q.x - mean, d1 = q.y - mean, d2 = q.z - mean,
                d3 = q.w - mean;
    sq += d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
  }
  const float var = block_sum(sq, scratch) / hw;
  const float inv = rsqrtf(var + eps);
  const float g = scale[c], bb = bias[c];

  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    float v[V];
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 t = smem4[i * (V / 4) + q];
      v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z; v[4 * q + 3] = t.w;
    }
#pragma unroll
    for (int q = 0; q < V; ++q)
      v[q] = __fadd_rn(__fmul_rn(__fmul_rn(v[q] - mean, inv), g), bb);
    Pack<T>::store(y + base + (size_t)i * V, v);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const float* bias,
                   void* y, int planes, int channels, int hw, float eps,
                   cudaStream_t stream) {
  const size_t smem = (size_t)hw * sizeof(float);
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        instance_norm_fwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  instance_norm_fwd_kernel<T><<<planes, kThreads, smem, stream>>>(
      (const T*)x, scale, bias, (T*)y, channels, hw, eps);
  return cudaGetLastError();
}

// Backward, replacing `_bwd` of scflow_tpu/ops/fused_norm.py (plain XLA
// under jax.custom_vjp there). Per plane, with x_hat = (x - mean) * inv,
// inv = rsqrt(var + eps) and gs = g * scale[c]:
//   dx = inv * (gs - mean(gs) - x_hat * mean(gs * x_hat))   (type of x)
//   dscale[c] = sum over n, hw of g * x_hat, dbias[c] = sum of g   (f32)
// Bound: bytes again, one read of x and g and one write of dx. One CTA per
// plane stages x in shared memory as the forward does and recomputes the
// two-pass statistics there; g is read twice from device memory, once for
// its two sums and once for dx; the second read of a CTA's plane finds it
// in L2 (three 64 KB planes per SM, ~25 MB in flight on 132 SMs). Per-plane
// sums of g * x_hat and g go to an (N, C) buffer that a second kernel
// reduces over N in a fixed order: no float atomics, so two runs agree bit
// for bit.
template <typename T>
__global__ void __launch_bounds__(kThreads)
instance_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const float* __restrict__ scale, T* __restrict__ dx,
                         float* __restrict__ part_scale,
                         float* __restrict__ part_bias, int channels, int hw,
                         float eps) {
  extern __shared__ float4 smem4[];  // the plane of x, as float4
  __shared__ float scratch[kWarps];
  constexpr int V = Pack<T>::n;

  const size_t base = (size_t)blockIdx.x * hw;
  const int c = blockIdx.x % channels;
  const int nvec = hw / V;

  float sum = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    float v[V];
    Pack<T>::load(x + base + (size_t)i * V, v);
#pragma unroll
    for (int q = 0; q < V; ++q) sum += v[q];
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      smem4[i * (V / 4) + q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
  const float mean = block_sum(sum, scratch) / hw;

  float sq = 0.f;
  for (int i = threadIdx.x; i < hw / 4; i += kThreads) {
    const float4 q = smem4[i];
    const float d0 = q.x - mean, d1 = q.y - mean, d2 = q.z - mean,
                d3 = q.w - mean;
    sq += d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
  }
  const float var = block_sum(sq, scratch) / hw;
  const float inv = rsqrtf(var + eps);

  // sums of g and g * x_hat over the plane
  float sg = 0.f, sgx = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    float gv[V];
    Pack<T>::load(g + base + (size_t)i * V, gv);
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 t = smem4[i * (V / 4) + q];
      const float xv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float gk = gv[4 * q + k];
        sg += gk;
        sgx += gk * ((xv[k] - mean) * inv);
      }
    }
  }
  sg = block_sum(sg, scratch);
  sgx = block_sum(sgx, scratch);
  if (threadIdx.x == 0) {
    part_scale[blockIdx.x] = sgx;
    part_bias[blockIdx.x] = sg;
  }
  const float s = scale[c];
  const float m1 = s * sg / hw;    // mean(gs)
  const float m2 = s * sgx / hw;   // mean(gs * x_hat)

  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    float gv[V], out[V];
    Pack<T>::load(g + base + (size_t)i * V, gv);
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 t = smem4[i * (V / 4) + q];
      const float xv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float xh = (xv[k] - mean) * inv;
        out[4 * q + k] = inv * (gv[4 * q + k] * s - m1 - xh * m2);
      }
    }
    Pack<T>::store(dx + base + (size_t)i * V, out);
  }
}

// dscale[c] = sum_n part_scale[n, c], dbias likewise, n in order
__global__ void instance_norm_bwd_reduce(const float* __restrict__ part_scale,
                                         const float* __restrict__ part_bias,
                                         float* __restrict__ dscale,
                                         float* __restrict__ dbias,
                                         int samples, int channels) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  float ss = 0.f, sb = 0.f;
  for (int n = 0; n < samples; ++n) {
    ss += part_scale[(size_t)n * channels + c];
    sb += part_bias[(size_t)n * channels + c];
  }
  dscale[c] = ss;
  dbias[c] = sb;
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* g, const float* scale,
                       void* dx, float* part, float* dscale, float* dbias,
                       int planes, int channels, int hw, float eps,
                       cudaStream_t stream) {
  const size_t smem = (size_t)hw * sizeof(float);
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        instance_norm_bwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  instance_norm_bwd_kernel<T><<<planes, kThreads, smem, stream>>>(
      (const T*)x, (const T*)g, scale, (T*)dx, part, part + planes, channels,
      hw, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  instance_norm_bwd_reduce<<<(channels + kThreads - 1) / kThreads, kThreads,
                             0, stream>>>(part, part + planes, dscale, dbias,
                                          planes / channels, channels);
  return cudaGetLastError();
}

// ---- the general form (form 1): any length, any element-aligned base ----

// sum over a block of any multiple of 32 threads up to 1024
__device__ __forceinline__ float block_sum_any(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  const int warps = blockDim.x / 32;
  for (int w = 0; w < warps; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// x of the plane's element e: staged below kMaxPlane, streamed above
template <typename T>
__device__ __forceinline__ float plane_x(const float* staged, const T* xp,
                                         int e) {
  return e < kMaxPlane ? staged[e] : load1(xp + e);
}

// mean and inv = rsqrt(var + eps) of one plane, staging its head in `staged`
template <typename T>
__device__ __forceinline__ void plane_stats(const T* xp, int hw, float eps,
                                            float* staged, float* scratch,
                                            float& mean, float& inv) {
  float sum = 0.f;
#pragma unroll 4
  for (int e = threadIdx.x; e < hw; e += blockDim.x) {
    const float v = load1(xp + e);
    if (e < kMaxPlane) staged[e] = v;
    sum += v;
  }
  mean = block_sum_any(sum, scratch) / hw;   // its barrier publishes staged
  float sq = 0.f;
#pragma unroll 4
  for (int e = threadIdx.x; e < hw; e += blockDim.x) {
    const float d = plane_x(staged, xp, e) - mean;
    sq += d * d;
  }
  inv = rsqrtf(block_sum_any(sq, scratch) / hw + eps);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
instance_norm_fwd_any(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ y,
                      int channels, int hw, float eps) {
  extern __shared__ float staged[];  // the plane's first kMaxPlane elements
  __shared__ float scratch[32];
  const size_t base = (size_t)blockIdx.x * hw;
  const T* xp = x + base;
  T* yp = y + base;
  const int c = blockIdx.x % channels;
  float mean, inv;
  plane_stats(xp, hw, eps, staged, scratch, mean, inv);
  const float g = scale[c], bb = bias[c];
#pragma unroll 4
  for (int e = threadIdx.x; e < hw; e += blockDim.x) {
    const float v = plane_x(staged, xp, e);
    store1(yp + e, __fadd_rn(__fmul_rn(__fmul_rn(v - mean, inv), g), bb));
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
instance_norm_bwd_any(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ scale, T* __restrict__ dx,
                      float* __restrict__ part_scale,
                      float* __restrict__ part_bias, int channels, int hw,
                      float eps) {
  extern __shared__ float staged[];
  __shared__ float scratch[32];
  const size_t base = (size_t)blockIdx.x * hw;
  const T* xp = x + base;
  const T* gp = g + base;
  T* dxp = dx + base;
  const int c = blockIdx.x % channels;
  float mean, inv;
  plane_stats(xp, hw, eps, staged, scratch, mean, inv);
  float sg = 0.f, sgx = 0.f;
#pragma unroll 4
  for (int e = threadIdx.x; e < hw; e += blockDim.x) {
    const float gk = load1(gp + e);
    sg += gk;
    sgx += gk * ((plane_x(staged, xp, e) - mean) * inv);
  }
  sg = block_sum_any(sg, scratch);
  sgx = block_sum_any(sgx, scratch);
  if (threadIdx.x == 0) {
    part_scale[blockIdx.x] = sgx;
    part_bias[blockIdx.x] = sg;
  }
  const float s = scale[c];
  const float m1 = s * sg / hw;
  const float m2 = s * sgx / hw;
#pragma unroll 4
  for (int e = threadIdx.x; e < hw; e += blockDim.x) {
    const float xh = (plane_x(staged, xp, e) - mean) * inv;
    // an unfused g * s: its rounding cancels m1's exactly on a 1-element
    // plane, where dx is 0
    store1(dxp + e, inv * (__fmul_rn(load1(gp + e), s) - m1 - xh * m2));
  }
}

// threads per CTA of the general form: ~8 elements a thread, 32 to 1024
inline int any_threads(int hw) {
  const int t = ((hw + 8 * 32 - 1) / (8 * 32)) * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

template <typename K>
cudaError_t stage_smem(K kernel, size_t smem, size_t* smem_set) {
  if (smem <= *smem_set) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *smem_set = smem;
  return err;
}

template <typename T>
cudaError_t launch_any(const void* x, const float* scale, const float* bias,
                       void* y, int planes, int channels, int hw, float eps,
                       cudaStream_t stream) {
  const size_t smem = (size_t)(hw < kMaxPlane ? hw : kMaxPlane) * sizeof(float);
  static size_t smem_set = 48 * 1024;
  const cudaError_t err = stage_smem(instance_norm_fwd_any<T>, smem, &smem_set);
  if (err != cudaSuccess) return err;
  instance_norm_fwd_any<T><<<planes, any_threads(hw), smem, stream>>>(
      (const T*)x, scale, bias, (T*)y, channels, hw, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_any(const void* x, const void* g, const float* scale,
                           void* dx, float* part, float* dscale, float* dbias,
                           int planes, int channels, int hw, float eps,
                           cudaStream_t stream) {
  const size_t smem = (size_t)(hw < kMaxPlane ? hw : kMaxPlane) * sizeof(float);
  static size_t smem_set = 48 * 1024;
  cudaError_t err = stage_smem(instance_norm_bwd_any<T>, smem, &smem_set);
  if (err != cudaSuccess) return err;
  instance_norm_bwd_any<T><<<planes, any_threads(hw), smem, stream>>>(
      (const T*)x, (const T*)g, scale, (T*)dx, part, part + planes, channels,
      hw, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  instance_norm_bwd_reduce<<<(channels + kThreads - 1) / kThreads, kThreads,
                             0, stream>>>(part, part + planes, dscale, dbias,
                                          planes / channels, channels);
  return cudaGetLastError();
}

// ---- the cluster form (form 2): a plane split across a thread-block
// cluster, its partial sums combined through distributed shared memory ----

// the sum over the cluster of each CTA's `local` (thread 0's), in rank
// order, returned to every thread; `slot` is this CTA's shared word
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster,
                                             float local, float* slot,
                                             float* bcast) {
  if (threadIdx.x == 0) *slot = local;
  cluster.sync();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (unsigned q = 0; q < cluster.num_blocks(); ++q)
      total += *cluster.map_shared_rank(slot, q);
    *bcast = total;
  }
  __syncthreads();
  return *bcast;
}

// this CTA's slice [lo, hi) of a plane of hw elements split in `parts`
__device__ __forceinline__ void cluster_slice(int hw, int parts, int rank,
                                              int& lo, int& hi) {
  const int chunk = ((hw + parts - 1) / parts + 7) / 8 * 8;
  lo = rank * chunk < hw ? rank * chunk : hw;
  hi = lo + chunk < hw ? lo + chunk : hw;
}

__device__ __forceinline__ bool on16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

// mean and inv of the cluster's plane; this CTA's slice [lo, hi) staged in
// `staged`. With `vec` (the slice's every pointer 16-byte aligned) the
// slice moves in 16-byte vectors, its tail in scalars.
template <typename T>
__device__ __forceinline__ void cluster_stats(cg::cluster_group& cluster,
                                              const T* xs, int n, bool vec,
                                              int hw, float eps,
                                              float* staged, float* scratch,
                                              float* slots, float* bcast,
                                              float& mean, float& inv) {
  constexpr int V = Pack<T>::n;
  const int nvec = vec ? n / V : 0;
  float sum = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[V];
    Pack<T>::load(xs + (size_t)i * V, v);
#pragma unroll
    for (int q = 0; q < V; ++q) sum += v[q];
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      reinterpret_cast<float4*>(staged)[i * (V / 4) + q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
#pragma unroll 4
  for (int e = nvec * V + threadIdx.x; e < n; e += blockDim.x) {
    const float v = load1(xs + e);
    staged[e] = v;
    sum += v;
  }
  sum = block_sum_any(sum, scratch);
  mean = cluster_sum(cluster, sum, slots, bcast) / hw;
  float sq = 0.f;
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float d = staged[e] - mean;
    sq += d * d;
  }
  sq = block_sum_any(sq, scratch);
  inv = rsqrtf(cluster_sum(cluster, sq, slots + 1, bcast) / hw + eps);
}

// the i-th V-element vector of a staged slice, as floats
template <int V>
__device__ __forceinline__ void slice_vec(const float4* staged4, int i,
                                          float* v) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    const float4 t = staged4[i * (V / 4) + q];
    v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z; v[4 * q + 3] = t.w;
  }
}

template <typename T>
__global__ void __launch_bounds__(kClusterThreads)
instance_norm_fwd_cluster(const T* __restrict__ x,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias, T* __restrict__ y,
                          int channels, int hw, float eps) {
  extern __shared__ float4 staged4[];  // this CTA's slice of the plane
  float* staged = reinterpret_cast<float*>(staged4);
  __shared__ float scratch[32];
  __shared__ float slots[2], bcast[1];
  constexpr int V = Pack<T>::n;
  cg::cluster_group cluster = cg::this_cluster();
  const int parts = (int)cluster.num_blocks();
  const int plane = blockIdx.x / parts;
  const size_t base = (size_t)plane * hw;
  const int c = plane % channels;
  int lo, hi;
  cluster_slice(hw, parts, (int)cluster.block_rank(), lo, hi);
  const int n = hi - lo;
  const T* xs = x + base + lo;
  T* ys = y + base + lo;
  const bool vec = on16(xs) && on16(ys);
  float mean, inv;
  cluster_stats(cluster, xs, n, vec, hw, eps, staged, scratch, slots, bcast,
                mean, inv);
  const float g = scale[c], bb = bias[c];
  const int nvec = vec ? n / V : 0;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[V];
    slice_vec<V>(staged4, i, v);
#pragma unroll
    for (int q = 0; q < V; ++q)
      v[q] = __fadd_rn(__fmul_rn(__fmul_rn(v[q] - mean, inv), g), bb);
    Pack<T>::store(ys + (size_t)i * V, v);
  }
#pragma unroll 4
  for (int e = nvec * V + threadIdx.x; e < n; e += blockDim.x)
    store1(ys + e,
           __fadd_rn(__fmul_rn(__fmul_rn(staged[e] - mean, inv), g), bb));
  cluster.sync();  // no CTA leaves while another reads its slots
}

template <typename T>
__global__ void __launch_bounds__(kClusterThreads)
instance_norm_bwd_cluster(const T* __restrict__ x, const T* __restrict__ g,
                          const float* __restrict__ scale,
                          T* __restrict__ dx, float* __restrict__ part_scale,
                          float* __restrict__ part_bias, int channels, int hw,
                          float eps) {
  extern __shared__ float4 staged4[];
  float* staged = reinterpret_cast<float*>(staged4);
  __shared__ float scratch[32];
  __shared__ float slots[4], bcast[1];
  constexpr int V = Pack<T>::n;
  cg::cluster_group cluster = cg::this_cluster();
  const int parts = (int)cluster.num_blocks();
  const int plane = blockIdx.x / parts;
  const size_t base = (size_t)plane * hw;
  const int c = plane % channels;
  int lo, hi;
  cluster_slice(hw, parts, (int)cluster.block_rank(), lo, hi);
  const int n = hi - lo;
  const T* xs = x + base + lo;
  const T* gs = g + base + lo;
  T* dxs = dx + base + lo;
  const bool vec = on16(xs) && on16(gs) && on16(dxs);
  const int nvec = vec ? n / V : 0;
  float mean, inv;
  cluster_stats(cluster, xs, n, vec, hw, eps, staged, scratch, slots, bcast,
                mean, inv);
  float sg = 0.f, sgx = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float gv[V], xv[V];
    Pack<T>::load(gs + (size_t)i * V, gv);
    slice_vec<V>(staged4, i, xv);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      sg += gv[q];
      sgx += gv[q] * ((xv[q] - mean) * inv);
    }
  }
#pragma unroll 4
  for (int e = nvec * V + threadIdx.x; e < n; e += blockDim.x) {
    const float gk = load1(gs + e);
    sg += gk;
    sgx += gk * ((staged[e] - mean) * inv);
  }
  sg = cluster_sum(cluster, block_sum_any(sg, scratch), slots + 2, bcast);
  sgx = cluster_sum(cluster, block_sum_any(sgx, scratch), slots + 3, bcast);
  if (threadIdx.x == 0 && cluster.block_rank() == 0) {
    part_scale[plane] = sgx;
    part_bias[plane] = sg;
  }
  const float s = scale[c];
  const float m1 = s * sg / hw;
  const float m2 = s * sgx / hw;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float gv[V], xv[V], out[V];
    Pack<T>::load(gs + (size_t)i * V, gv);
    slice_vec<V>(staged4, i, xv);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const float xh = (xv[q] - mean) * inv;
      out[q] = inv * (__fmul_rn(gv[q], s) - m1 - xh * m2);
    }
    Pack<T>::store(dxs + (size_t)i * V, out);
  }
#pragma unroll 4
  for (int e = nvec * V + threadIdx.x; e < n; e += blockDim.x) {
    const float xh = (staged[e] - mean) * inv;
    store1(dxs + e, inv * (__fmul_rn(load1(gs + e), s) - m1 - xh * m2));
  }
  cluster.sync();
}

// CTAs in a plane's cluster: slices of about kClusterSlice elements
inline int cluster_parts(int hw) {
  const int parts = (hw + kClusterSlice - 1) / kClusterSlice;
  return parts < 2 ? 2 : (parts > kMaxCluster ? kMaxCluster : parts);
}

template <typename K, typename... Args>
cudaError_t launch_cluster(K kernel, int planes, int hw, size_t* smem_set,
                           cudaStream_t stream, Args... args) {
  const int parts = cluster_parts(hw);
  const size_t smem =
      (size_t)(((hw + parts - 1) / parts + 7) / 8 * 8) * sizeof(float);
  cudaError_t err = stage_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(planes * parts));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd_cluster(const void* x, const float* scale,
                               const float* bias, void* y, int planes,
                               int channels, int hw, float eps,
                               cudaStream_t stream) {
  static size_t smem_set = 48 * 1024;
  return launch_cluster(instance_norm_fwd_cluster<T>, planes, hw, &smem_set,
                        stream, (const T*)x, scale, bias, (T*)y, channels, hw,
                        eps);
}

template <typename T>
cudaError_t launch_bwd_cluster(const void* x, const void* g,
                               const float* scale, void* dx, float* part,
                               float* dscale, float* dbias, int planes,
                               int channels, int hw, float eps,
                               cudaStream_t stream) {
  static size_t smem_set = 48 * 1024;
  cudaError_t err = launch_cluster(
      instance_norm_bwd_cluster<T>, planes, hw, &smem_set, stream,
      (const T*)x, (const T*)g, scale, (T*)dx, part, part + planes, channels,
      hw, eps);
  if (err != cudaSuccess) return err;
  instance_norm_bwd_reduce<<<(channels + kThreads - 1) / kThreads, kThreads,
                             0, stream>>>(part, part + planes, dscale, dbias,
                                          planes / channels, channels);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// The form for planes of hw elements at these pointers: 0 vector, 1
// general, 2 cluster, 3 general with the part past kMaxCluster * kMaxPlane
// streamed (the code the entries report; 3 launches form 1's kernels).
int pick_form(int hw, const void* a, const void* b, const void* c) {
  if (hw > kMaxPlane)
    return hw <= kMaxCluster * kMaxPlane ? 2 : 3;
  return hw % 8 == 0 && aligned16(a) && aligned16(b) && aligned16(c) ? 0 : 1;
}

}  // namespace

// x, y (planes, hw) contiguous; dtype 0 = f32, 1 = bf16; scale, bias
// (channels,) f32. Any hw >= 1 and any element-aligned base; *form gets
// the form launched (pick_form's code).
extern "C" int scflow_instance_norm_fwd(const void* x, const void* scale,
                                        const void* bias, void* y, int planes,
                                        int channels, int hw, float eps,
                                        int dtype, int* form, void* stream) {
  if (hw <= 0 || planes <= 0 || channels <= 0 || planes % channels ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  *form = pick_form(hw, x, y, y);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* sc = (const float*)scale;
  const float* bi = (const float*)bias;
  if (*form == 0)
    return dtype == 0
               ? (int)launch<float>(x, sc, bi, y, planes, channels, hw, eps, s)
               : (int)launch<__nv_bfloat16>(x, sc, bi, y, planes, channels,
                                            hw, eps, s);
  if (*form == 2)
    return dtype == 0
               ? (int)launch_fwd_cluster<float>(x, sc, bi, y, planes,
                                                channels, hw, eps, s)
               : (int)launch_fwd_cluster<__nv_bfloat16>(x, sc, bi, y, planes,
                                                        channels, hw, eps, s);
  return dtype == 0
             ? (int)launch_any<float>(x, sc, bi, y, planes, channels, hw, eps,
                                      s)
             : (int)launch_any<__nv_bfloat16>(x, sc, bi, y, planes, channels,
                                              hw, eps, s);
}

// x, g, dx (planes, hw) contiguous, of one dtype (0 = f32, 1 = bf16);
// scale, dscale, dbias (channels,) f32; part (2, planes) f32 scratch for
// the per-plane sums. *form as for the forward (the vector form needs x,
// g and dx aligned).
extern "C" int scflow_instance_norm_bwd(const void* x, const void* g,
                                        const void* scale, void* dx,
                                        void* part, void* dscale, void* dbias,
                                        int planes, int channels, int hw,
                                        float eps, int dtype, int* form,
                                        void* stream) {
  if (hw <= 0 || planes <= 0 || channels <= 0 || planes % channels ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  *form = pick_form(hw, x, g, dx);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* sc = (const float*)scale;
  float* pa = (float*)part;
  float* ds = (float*)dscale;
  float* db = (float*)dbias;
  if (*form == 0)
    return dtype == 0
               ? (int)launch_bwd<float>(x, g, sc, dx, pa, ds, db, planes,
                                        channels, hw, eps, s)
               : (int)launch_bwd<__nv_bfloat16>(x, g, sc, dx, pa, ds, db,
                                                planes, channels, hw, eps, s);
  if (*form == 2)
    return dtype == 0
               ? (int)launch_bwd_cluster<float>(x, g, sc, dx, pa, ds, db,
                                                planes, channels, hw, eps, s)
               : (int)launch_bwd_cluster<__nv_bfloat16>(
                     x, g, sc, dx, pa, ds, db, planes, channels, hw, eps, s);
  return dtype == 0
             ? (int)launch_bwd_any<float>(x, g, sc, dx, pa, ds, db, planes,
                                          channels, hw, eps, s)
             : (int)launch_bwd_any<__nv_bfloat16>(x, g, sc, dx, pa, ds, db,
                                                  planes, channels, hw, eps,
                                                  s);
}
