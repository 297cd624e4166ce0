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
//
// What bounds it on this card: device-memory bytes. It does ~8 FP32
// operations per element against 4 (f32) or 2 (bf16) bytes read plus the
// same written, far below the H100's ~20 FP32 operations per byte, so the
// bound is 2 * numel * sizeof(x) over 3.35 TB/s.
//
// What the design does about it:
//  - The port is NCHW, so each plane is contiguous. One CTA per plane loads
//    it once from device memory into dynamic shared memory (at most
//    128*128*4 B = 64 KB on the encoders' largest layer; the attribute for
//    more than 48 KB is set before the launch), with 16-byte vector loads.
//  - Statistics take two passes over shared memory, the mean and then
//    sum((x - mean)^2), as the reference `_reference_in` computes them;
//    f32 throughout, reduced with warp shuffles and one shared-memory step.
//  - The normalised, scaled and shifted values are written once, again with
//    16-byte vector stores.
// 2048 to 4096 CTAs per launch at batch 32 keep all SMs busy; three 64 KB
// planes fit an SM at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

}  // namespace

// x, y (planes, hw) contiguous, planes = N * channels, hw % 8 == 0, 16-byte
// aligned; dtype 0 = f32, 1 = bf16; scale, bias (channels,) f32.
extern "C" int scflow_instance_norm_fwd(const void* x, const void* scale,
                                        const void* bias, void* y, int planes,
                                        int channels, int hw, float eps,
                                        int dtype, void* stream) {
  if (hw <= 0 || hw % 8 || planes <= 0 || channels <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(x, (const float*)scale, (const float*)bias, y,
                              planes, channels, hw, eps, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, (const float*)scale,
                                      (const float*)bias, y, planes, channels,
                                      hw, eps, s);
  return (int)cudaErrorInvalidValue;
}

// x, g, dx (planes, hw) contiguous and 16-byte aligned, of one dtype (0 =
// f32, 1 = bf16), hw % 8 == 0; scale, dscale, dbias (channels,) f32; part
// (2, planes) f32 scratch for the per-plane sums.
extern "C" int scflow_instance_norm_bwd(const void* x, const void* g,
                                        const void* scale, void* dx,
                                        void* part, void* dscale, void* dbias,
                                        int planes, int channels, int hw,
                                        float eps, int dtype, void* stream) {
  if (hw <= 0 || hw % 8 || planes <= 0 || channels <= 0 ||
      planes % channels)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_bwd<float>(x, g, (const float*)scale, dx,
                                  (float*)part, (float*)dscale,
                                  (float*)dbias, planes, channels, hw, eps, s);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(x, g, (const float*)scale, dx,
                                          (float*)part, (float*)dscale,
                                          (float*)dbias, planes, channels, hw,
                                          eps, s);
  return (int)cudaErrorInvalidValue;
}
