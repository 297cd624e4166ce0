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
// Five forms, chosen per launch by the entry from H*W and the pointers'
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
//  4. warp form: the other planes of at most kWarpPlane (512) elements
//     (ResNet's 7x7 and 14x14, 13x17, a small plane at an offset). One
//     warp per plane, eight warps a CTA of 256 threads: each lane holds
//     at most 16 of the plane's elements in registers (coalesced scalar
//     loads, so no alignment matters) and both statistics come from
//     __shfl_xor_sync alone: no shared memory, no __syncthreads. A forward
//     warp takes up to 8 planes of 1 to 4 elements a lane and loads them
//     all before it reduces any. One CTA per small plane was bound by CTA
//     launches, not bytes; at 7x7 the warp form is still bound by its
//     launch and latency more than by bytes (PERF.md).
//  1. general form: the other planes of 513 to kMaxPlane elements (an odd H*W
//     such as 23x23 or ResNet-50's 175x175 at 1400-pixel inputs, a base that
//     is not 16-byte aligned). Bound: bytes, as every form. Its first design
//     moved every element in a scalar access and staged the plane as f32
//     (bound by issue and latency: bf16 took 83% of f32's time), read g twice
//     and reduced dscale in a second launch. Now each plane is cut at its own
//     16-byte boundaries into slots of 4 f32 or 8 bf16 (its phase changes from
//     plane to plane with an odd H*W or an offset view; a scalar head and
//     tail, whole slots between). A plane goes to one CTA of 64 to 512
//     threads, about 8 slots a thread (more threads held a large plane's CTA
//     alone on an SM by its registers), or, up to 256 slots (1,021 f32, 2,041
//     bf16 elements), to one warp, eight planes a CTA. Whole slots go into
//     shared memory kept in the plane's own type by 16-byte cp.async (every
//     copy of a thread in flight before the first sum); the statistics take
//     two passes over shared memory in 16-byte reads, one reduction each (a
//     barrier a CTA, none a warp). The output is written in its own slots with
//     16-byte stores; where its phase differs from x's (a fresh y beside an
//     offset x), each slot's values are read across 16-byte lines (bf16 as
//     32-bit words). A CTA stages at most 112 KB, so that two share an SM,
//     unless that leaves more than an eighth of the plane unstaged; then up to
//     226 KB. Past it, a plane's first slots are staged and the rest read from
//     device memory in each pass, from L2 after the first. The backward stages
//     x, then g in what is left, sums the pairs (sum x, sum g) and (sum
//     (x-m)^2, sum g(x-m)) in two reductions and writes dx once; dscale and
//     dbias come in the same launch: each plane's group writes its two sums,
//     fences them, and draws a ticket from a counter that the wrapper keeps
//     per (device, stream); the group that draws the last ticket adds the sums
//     in the order of instance_norm_bwd_reduce and returns the counter to 0.
//     No float atomics: two launches give equal bits.
//  2. cluster form: planes of kMaxPlane < H*W <= 458,752 elements (the
//     240x240 and 256x256 stems of 480- and 512-pixel crops, the 240x320
//     half-resolution plane of a 480x640 frame). A thread-block cluster of
//     2 to 8 CTAs (the portable size) shares a plane, each of 512 threads
//     staging a slice of about 16K elements (64 KB, three CTAs an SM); the
//     slices' partial sums meet through distributed shared memory (thread
//     0 of each CTA reads every CTA's sum in rank order, so the result is
//     deterministic), twice for the two-pass statistics. The plane is read
//     once and written once, in 16-byte vectors where a slice's pointers
//     are 16-byte aligned (slices start at multiples of 8 elements), else
//     in coalesced scalars. The backward (redesigned, see its note) stages
//     x and g in their own type and sums pairs in two cluster reductions.
//  3. split form: planes past a cluster (H*W > 458,752: a 700x700 plane,
//     the stem of a crop past ~1356 pixels). Each plane is cut into slices
//     of 16 KB (4096 f32 or 8192 bf16 elements; 4096 backward), one CTA of
//     256 threads each, held in registers, so the grid fills the card
//     whatever the number of planes.
//     Two launches: the first writes each slice's sum and its own centred
//     sum of squares (two passes over the registers); the second combines
//     a plane's slices in slice order (Chan: M2 = sum of M2_s + n_s (m_s -
//     mean)^2, by the CTA's first warp, shared through shared memory),
//     re-reads its slice and normalises. A whole slice at 16-byte aligned
//     pointers moves in 16-byte vectors, any other in coalesced scalars.
//     The plane is read twice; the second launch walks the slices in
//     reverse so that its first CTAs find the first launch's last slices
//     in L2. No float atomics: two launches give equal bits. (A cluster of
//     up to 16 CTAs would read a 700x700 plane once, but needs the
//     non-portable cluster size and one CTA an SM, and still a second
//     design past 16 * kMaxPlane elements; the split form takes any size.)
// Bound of every form: 2 * numel * sizeof(x) bytes forward (3 * numel
// backward) over 3.35 TB/s; the split form moves 3 * numel * sizeof(x)
// forward (5 * numel backward), less what its second launch finds in L2;
// the general form reads what it cannot stage (f32 planes past 28,669
// elements, bf16 past 28,665 backward) three times, less what the later
// reads find in L2.

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
// the cluster form: up to 8 CTAs (the portable cluster size) share a plane,
// each staging a slice of at most kMaxPlane elements; slices of about
// kClusterSlice elements keep three CTAs of 512 threads on an SM
constexpr int kMaxCluster = 8;
constexpr int kClusterSlice = 16 * 1024;
constexpr int kClusterThreads = 512;
// the warp form: one warp a plane, eight planes a CTA, at most
// kWarpMaxPerLane elements a lane; planes up to kWarpPlane elements take it
constexpr int kWarpsPerCta = 8;
constexpr int kWarpMaxPerLane = 16;
constexpr int kWarpPlane = 512;
static_assert(kWarpPlane <= 32 * kWarpMaxPerLane,
              "a lane holds at most kWarpMaxPerLane elements");
// a forward warp takes several small planes, up to kWarpValues elements a
// lane
constexpr int kWarpValues = 8;
// the split form: slices of kThreads * PER elements, PER a thread in
// registers: kSplitPer, and kSplitPerBf16 in the bf16 forward (the same 64
// bytes a thread as f32)
constexpr int kSplitPer = 16;
constexpr int kSplitPerBf16 = 32;
constexpr int split_per(int bytes, bool backward) {
  return bytes == 2 && !backward ? kSplitPerBf16 : kSplitPer;
}

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

__device__ __forceinline__ bool on16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

// ---- helpers of the forms below ----

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

template <typename K>
cudaError_t stage_smem(K kernel, size_t smem, size_t* smem_set) {
  if (smem <= *smem_set) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *smem_set = smem;
  return err;
}

// dscale, dbias from the per-plane sums `part` (2, planes)
cudaError_t launch_bwd_reduce(const float* part, float* dscale, float* dbias,
                              int planes, int channels, cudaStream_t stream) {
  instance_norm_bwd_reduce<<<(channels + kThreads - 1) / kThreads, kThreads,
                             0, stream>>>(part, part + planes, dscale, dbias,
                                          planes / channels, channels);
  return cudaGetLastError();
}

// ---- the warp form (form 4): planes of at most kWarpPlane elements, one
// warp a plane, the plane in registers ----

__device__ __forceinline__ float warp_sum(float v) {
  // a butterfly: every lane ends with the same bits (each step adds the
  // same two values, in either order)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A warp takes P planes, one after another in memory, and loads all of
// them before it reduces any: the loads of small planes (E = 1 or 2
// elements a lane) are in flight together. Plane p's element i * 32 + lane
// is the lane's v[p][i]. The first of the warp's planes:
template <int P>
__device__ __forceinline__ int warp_first_plane() {
  return (blockIdx.x * kWarpsPerCta + (int)threadIdx.x / 32) * P;
}

template <typename T, int E, int P>
__device__ __forceinline__ void warp_load(const T* x, int first, int planes,
                                          int hw, float (&v)[P][E]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int e = i * 32 + lane;
      v[p][i] = first + p < planes && e < hw
                    ? load1(x + (size_t)(first + p) * hw + e)
                    : 0.f;
    }
}

// each plane's mean and inv (every lane the same bits)
template <int E, int P>
__device__ __forceinline__ void warp_stats(const float (&v)[P][E], int hw,
                                           float eps, float (&mean)[P],
                                           float (&inv)[P]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) sum += v[p][i];
    mean[p] = warp_sum(sum) / hw;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float d = i * 32 + lane < hw ? v[p][i] - mean[p] : 0.f;
      sq += d * d;
    }
    inv[p] = rsqrtf(warp_sum(sq) / hw + eps);
  }
}

template <typename T, int E, int P>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
instance_norm_fwd_warp(const T* __restrict__ x,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ y,
                       int planes, int channels, int hw, float eps) {
  const int first = warp_first_plane<P>();
  if (first >= planes) return;                   // the whole warp
  const int lane = threadIdx.x % 32;
  float v[P][E], mean[P], inv[P];
  warp_load<T, E, P>(x, first, planes, hw, v);
  warp_stats<E, P>(v, hw, eps, mean, inv);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (first + p >= planes) break;
    const int c = (first + p) % channels;
    const float g = scale[c], bb = bias[c];
    T* yp = y + (size_t)(first + p) * hw;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int e = i * 32 + lane;
      if (e < hw)
        store1(yp + e,
               __fadd_rn(__fmul_rn(__fmul_rn(v[p][i] - mean[p], inv[p]), g),
                         bb));
    }
  }
}

template <typename T, int E, int P>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
instance_norm_bwd_warp(const T* __restrict__ x, const T* __restrict__ g,
                       const float* __restrict__ scale, T* __restrict__ dx,
                       float* __restrict__ part_scale,
                       float* __restrict__ part_bias, int planes,
                       int channels, int hw, float eps) {
  const int first = warp_first_plane<P>();
  if (first >= planes) return;
  const int lane = threadIdx.x % 32;
  float xv[P][E], gv[P][E], mean[P], inv[P];
  warp_load<T, E, P>(x, first, planes, hw, xv);
  warp_load<T, E, P>(g, first, planes, hw, gv);
  warp_stats<E, P>(xv, hw, eps, mean, inv);
  float sg[P], sgx[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    sg[p] = sgx[p] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (i * 32 + lane < hw) {
        sg[p] += gv[p][i];
        sgx[p] += gv[p][i] * ((xv[p][i] - mean[p]) * inv[p]);
      }
    }
    sg[p] = warp_sum(sg[p]);
    sgx[p] = warp_sum(sgx[p]);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int plane = first + p;
    if (plane >= planes) break;
    if (lane == 0) {
      part_scale[plane] = sgx[p];
      part_bias[plane] = sg[p];
    }
    const float s = scale[plane % channels];
    const float m1 = s * sg[p] / hw;
    const float m2 = s * sgx[p] / hw;
    T* dxp = dx + (size_t)plane * hw;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int e = i * 32 + lane;
      if (e < hw) {
        const float xh = (xv[p][i] - mean[p]) * inv[p];
        // unfused g * s, as the general form: dx = 0 on a 1-element plane
        store1(dxp + e, inv[p] * (__fmul_rn(gv[p][i], s) - m1 - xh * m2));
      }
    }
  }
}

// the warp form's kernels for planes of hw <= 32 * E elements: E is the
// least power of two that holds the plane; a forward warp takes P planes,
// as many as keep E * P <= kWarpValues, a backward warp one (it holds x
// and g; more planes a warp measured slower)
template <typename T, int E = 1>
cudaError_t launch_warp(bool backward, const void* x, const void* g,
                        const float* scale, const float* bias, void* y,
                        float* part, int planes, int channels, int hw,
                        float eps, cudaStream_t stream) {
  if constexpr (E < kWarpMaxPerLane) {
    if (hw > 32 * E)
      return launch_warp<T, 2 * E>(backward, x, g, scale, bias, y, part,
                                   planes, channels, hw, eps, stream);
  }
  constexpr int P = kWarpValues / E < 1 ? 1 : kWarpValues / E;
  if (backward) {
    const int ctas = (planes + kWarpsPerCta - 1) / kWarpsPerCta;
    instance_norm_bwd_warp<T, E, 1><<<ctas, kWarpsPerCta * 32, 0, stream>>>(
        (const T*)x, (const T*)g, scale, (T*)y, part, part + planes, planes,
        channels, hw, eps);
  } else {
    const int ctas = (planes + kWarpsPerCta * P - 1) / (kWarpsPerCta * P);
    instance_norm_fwd_warp<T, E, P><<<ctas, kWarpsPerCta * 32, 0, stream>>>(
        (const T*)x, scale, bias, (T*)y, planes, channels, hw, eps);
  }
  return cudaGetLastError();
}

// ---- the split form (form 3): planes past a cluster, cut into slices of
// kSliceOf<PER> elements, one CTA each, two launches ----

// elements of a slice whose kThreads threads hold PER each
template <int PER>
constexpr int kSliceOf = kThreads * PER;

// sums over the CTA (kThreads) of each thread's v[0..N), returned to every
// thread in v; `scratch` holds N * kWarps floats
template <int N>
__device__ __forceinline__ void block_sums(float (&v)[N], float* scratch) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    v[k] = warp_sum(v[k]);
    if (lane == 0) scratch[k * kWarps + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += scratch[k * kWarps + w];
    v[k] = t;
  }
  __syncthreads();   // scratch is reused by the next call
}

// the length of slice s of a plane of hw elements
template <int PER>
__device__ __forceinline__ int slice_len(int s, int hw) {
  const int rest = hw - s * kSliceOf<PER>;
  return rest < kSliceOf<PER> ? rest : kSliceOf<PER>;
}

// A slice in registers, PER values a thread. With `vec` (a
// whole slice whose pointers are all 16-byte aligned) thread t holds the
// V-element vectors t, t + kThreads, ... of the slice, moved as 16-byte
// vectors; else its elements t, t + kThreads, ... in coalesced scalars
// (0 past the slice's n). The slice's element that is v[i]:
template <typename T>
__device__ __forceinline__ int slice_elem(int i, bool vec) {
  constexpr int V = Pack<T>::n;
  return vec ? ((i / V) * kThreads + (int)threadIdx.x) * V + i % V
             : i * kThreads + (int)threadIdx.x;
}

template <typename T, int PER>
__device__ __forceinline__ void load_slice(const T* p, int n, bool vec,
                                           float (&v)[PER]) {
  constexpr int V = Pack<T>::n;
  if (vec) {
#pragma unroll
    for (int j = 0; j < PER / V; ++j)
      Pack<T>::load(p + ((size_t)j * kThreads + threadIdx.x) * V, v + j * V);
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = slice_elem<T>(i, false);
      v[i] = e < n ? load1(p + e) : 0.f;
    }
  }
}

template <typename T, int PER>
__device__ __forceinline__ void store_slice(T* p, int n, bool vec,
                                            const float (&v)[PER]) {
  constexpr int V = Pack<T>::n;
  if (vec) {
#pragma unroll
    for (int j = 0; j < PER / V; ++j)
      Pack<T>::store(p + ((size_t)j * kThreads + threadIdx.x) * V, v + j * V);
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = slice_elem<T>(i, false);
      if (e < n) store1(p + e, v[i]);
    }
  }
}

template <int PER>
__device__ __forceinline__ float thread_sum(const float (&v)[PER]) {
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) t += v[i];
  return t;
}

// this thread's sum of (v - m)^2 over the slice's first n elements
template <typename T, int PER>
__device__ __forceinline__ float slice_centred(const float (&v)[PER],
                                               int n, bool vec, float m) {
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const float d = slice_elem<T>(i, vec) < n ? v[i] - m : 0.f;
    sq += d * d;
  }
  return sq;
}

// forward, first launch: part[b] = (sum, centred sum of squares) of slice b
template <typename T, int PER>
__global__ void __launch_bounds__(kThreads)
instance_norm_split_stats(const T* __restrict__ x, float2* __restrict__ part,
                          int hw, int slices) {
  __shared__ float scratch[kWarps];
  const int plane = blockIdx.x / slices, s = blockIdx.x % slices;
  const int n = slice_len<PER>(s, hw);
  const T* xs = x + (size_t)plane * hw + (size_t)s * kSliceOf<PER>;
  const bool vec = n == kSliceOf<PER> && on16(xs);
  float v[PER];
  load_slice(xs, n, vec, v);
  float t[1] = {thread_sum(v)};
  block_sums(t, scratch);
  float q[1] = {slice_centred<T, PER>(v, n, vec, t[0] / n)};
  block_sums(q, scratch);
  if (threadIdx.x == 0) part[blockIdx.x] = make_float2(t[0], q[0]);
}

// a plane's mean and inv from its slices' (sum, M2), in slice order: lane
// l of warp 0 takes slices l, l + 32, ..., then the warp's butterfly;
// every thread reads them from `shared` after the barrier
template <int PER>
__device__ __forceinline__ void split_combine(const float2* part, int slices,
                                              int hw, float eps,
                                              float* shared, float& mean,
                                              float& inv) {
  if (threadIdx.x < 32) {
    float t = 0.f;
#pragma unroll 4
    for (int s = threadIdx.x; s < slices; s += 32) t += part[s].x;
    const float mu = warp_sum(t) / hw;
    float m2 = 0.f;
#pragma unroll 4
    for (int s = threadIdx.x; s < slices; s += 32) {
      const float2 p = part[s];
      const float n = (float)slice_len<PER>(s, hw);
      const float d = p.x / n - mu;
      m2 += p.y + n * d * d;
    }
    const float iv = rsqrtf(warp_sum(m2) / hw + eps);
    if (threadIdx.x == 0) {
      shared[0] = mu;
      shared[1] = iv;
    }
  }
  __syncthreads();
  mean = shared[0];
  inv = shared[1];
}

// forward, second launch: combine, re-read the slice, normalise. Slices in
// the reverse of the first launch's order: its last ones are still in L2.
template <typename T, int PER>
__global__ void __launch_bounds__(kThreads, 4)
instance_norm_split_fwd(const T* __restrict__ x,
                        const float2* __restrict__ part,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, T* __restrict__ y,
                        int channels, int hw, int slices, float eps) {
  const int b = gridDim.x - 1 - blockIdx.x;
  const int plane = b / slices, s = b % slices;
  const int n = slice_len<PER>(s, hw);
  const size_t lo = (size_t)plane * hw + (size_t)s * kSliceOf<PER>;
  const bool vec = n == kSliceOf<PER> && on16(x + lo) && on16(y + lo);
  float v[PER];
  load_slice(x + lo, n, vec, v);
  __shared__ float stats[2];
  float mean, inv;
  split_combine<PER>(part + (size_t)plane * slices, slices, hw, eps, stats,
                     mean, inv);
  const float g = scale[plane % channels], bb = bias[plane % channels];
#pragma unroll
  for (int i = 0; i < PER; ++i)
    v[i] = __fadd_rn(__fmul_rn(__fmul_rn(v[i] - mean, inv), g), bb);
  store_slice(y + lo, n, vec, v);
}

// backward, first launch: part[b] = (sum x, sum (x - m_s)^2, sum g,
// sum g (x - m_s)) of slice b, m_s its own mean
template <typename T, int PER>
__global__ void __launch_bounds__(kThreads)
instance_norm_split_bwd_stats(const T* __restrict__ x,
                              const T* __restrict__ g,
                              float4* __restrict__ part, int hw, int slices) {
  __shared__ float scratch[3 * kWarps];
  const int plane = blockIdx.x / slices, s = blockIdx.x % slices;
  const int n = slice_len<PER>(s, hw);
  const size_t lo = (size_t)plane * hw + (size_t)s * kSliceOf<PER>;
  const bool vec = n == kSliceOf<PER> && on16(x + lo) && on16(g + lo);
  float xv[PER], gv[PER];
  load_slice(x + lo, n, vec, xv);
  load_slice(g + lo, n, vec, gv);
  float t[1] = {thread_sum(xv)};
  block_sums(t, scratch);
  const float m = t[0] / n;
  float q[3] = {slice_centred<T, PER>(xv, n, vec, m), thread_sum(gv), 0.f};
#pragma unroll
  for (int i = 0; i < PER; ++i)
    q[2] += slice_elem<T>(i, vec) < n ? gv[i] * (xv[i] - m) : 0.f;
  block_sums(q, scratch);
  if (threadIdx.x == 0) part[blockIdx.x] = make_float4(t[0], q[0], q[1], q[2]);
}

// backward, second launch: the plane's mean, inv, sum g and sum g * x_hat
// from its slices (sum g (x - mean) = sum g (x - m_s) + (m_s - mean) sum g),
// then dx of the slice; slice 0's CTA writes the plane's two sums
template <typename T, int PER>
__global__ void __launch_bounds__(kThreads, 4)
instance_norm_split_bwd(const T* __restrict__ x, const T* __restrict__ g,
                        const float4* __restrict__ part,
                        const float* __restrict__ scale, T* __restrict__ dx,
                        float* __restrict__ part_scale,
                        float* __restrict__ part_bias, int channels, int hw,
                        int slices, float eps) {
  const int b = gridDim.x - 1 - blockIdx.x;
  const int plane = b / slices, s = b % slices;
  const int n = slice_len<PER>(s, hw);
  const size_t lo = (size_t)plane * hw + (size_t)s * kSliceOf<PER>;
  const bool vec = n == kSliceOf<PER> && on16(x + lo) && on16(g + lo) &&
                   on16(dx + lo);
  float xv[PER], gv[PER];
  load_slice(x + lo, n, vec, xv);
  load_slice(g + lo, n, vec, gv);
  // warp 0 combines the plane's slices in slice order, as split_combine
  __shared__ float stats[4];
  if (threadIdx.x < 32) {
    const float4* pp = part + (size_t)plane * slices;
    float t = 0.f;
#pragma unroll 4
    for (int q = threadIdx.x; q < slices; q += 32) t += pp[q].x;
    const float mu = warp_sum(t) / hw;
    float m2 = 0.f, sgq = 0.f, sgc = 0.f;
#pragma unroll 4
    for (int q = threadIdx.x; q < slices; q += 32) {
      const float4 p = pp[q];
      const float nq = (float)slice_len<PER>(q, hw);
      const float d = p.x / nq - mu;
      m2 += p.y + nq * d * d;
      sgq += p.z;
      sgc += p.w + d * p.z;
    }
    const float iv = rsqrtf(warp_sum(m2) / hw + eps);
    sgq = warp_sum(sgq);
    sgc = warp_sum(sgc) * iv;
    if (threadIdx.x == 0) {
      stats[0] = mu;
      stats[1] = iv;
      stats[2] = sgq;
      stats[3] = sgc;
      if (s == 0) {
        part_scale[plane] = sgc;
        part_bias[plane] = sgq;
      }
    }
  }
  __syncthreads();
  const float mean = stats[0], inv = stats[1], sg = stats[2], sgx = stats[3];
  const float sc = scale[plane % channels];
  const float m1 = sc * sg / hw;
  const float mx = sc * sgx / hw;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const float xh = (xv[i] - mean) * inv;
    xv[i] = inv * (__fmul_rn(gv[i], sc) - m1 - xh * mx);
  }
  store_slice(dx + lo, n, vec, xv);
}

// slices of the split form per plane, and the f32 scratch both launches
// share: (sum, M2) per slice forward, four sums backward
inline int split_slices(int hw, int per) {
  return (hw + kThreads * per - 1) / (kThreads * per);
}

inline long long split_work(int planes, int hw, bool backward, int bytes) {
  return (long long)planes * split_slices(hw, split_per(bytes, backward)) *
         (backward ? 4 : 2);
}

template <typename T>
cudaError_t launch_fwd_split(const void* x, const float* scale,
                             const float* bias, void* y, float* work,
                             int planes, int channels, int hw, float eps,
                             cudaStream_t stream) {
  constexpr int PER = split_per(sizeof(T), false);
  const int slices = split_slices(hw, PER);
  if ((long long)planes * slices > 0x7fffffffLL || work == nullptr)
    return cudaErrorInvalidValue;
  float2* part = reinterpret_cast<float2*>(work);
  instance_norm_split_stats<T, PER><<<planes * slices, kThreads, 0, stream>>>(
      (const T*)x, part, hw, slices);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  instance_norm_split_fwd<T, PER><<<planes * slices, kThreads, 0, stream>>>(
      (const T*)x, part, scale, bias, (T*)y, channels, hw, slices, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_split(const void* x, const void* g, const float* scale,
                             void* dx, float* part, float* work,
                             float* dscale, float* dbias, int planes,
                             int channels, int hw, float eps,
                             cudaStream_t stream) {
  constexpr int PER = split_per(sizeof(T), true);
  const int slices = split_slices(hw, PER);
  if ((long long)planes * slices > 0x7fffffffLL || work == nullptr)
    return cudaErrorInvalidValue;
  float4* sums = reinterpret_cast<float4*>(work);
  instance_norm_split_bwd_stats<T, PER>
      <<<planes * slices, kThreads, 0, stream>>>((const T*)x, (const T*)g,
                                                 sums, hw, slices);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  instance_norm_split_bwd<T, PER><<<planes * slices, kThreads, 0, stream>>>(
      (const T*)x, (const T*)g, sums, scale, (T*)dx, part, part + planes,
      channels, hw, slices, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_bwd_reduce(part, dscale, dbias, planes, channels, stream);
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

// ---- the cluster backward (redesigned for Hopper) ----
// What held the first design at 47% of its bound in bf16 (62% f32): g was
// read from device memory twice and x staged as f32 (8 bytes an element in
// bf16 against a bound of 6), and four cluster reductions ran in series
// (sum x, sum (x-m)^2, sum g, sum g*xhat), each a cluster barrier and a
// serial walk by thread 0 over every rank's slot. This design:
//  - stages x and g in shared memory in their own type with cp.async (every
//    copy of a thread in flight at once), so each is read once: bf16 slices
//    of ~16K elements take 2 x 32 KB, three CTAs of 512 threads an SM. In
//    f32 both fit at slices of ~8K elements (64 KB); where a slice is too
//    large for both (f32 planes past 229,376 elements, up to the top of
//    the form), g stays in device memory and is read twice (`kStageG`
//    false);
//  - fuses the statistics into two cluster reductions of a float pair:
//    (sum x, sum g), then (sum (x-m)^2, sum g*(x-m)), the second pass
//    centred on the first's mean (the two-pass variance); then
//    sgx = inv * sum g*(x-m), m1 = s * sum g / hw, m2 = s * sgx / hw;
//  - reads the ranks' slots in parallel (lane q of warp 0 reads rank q's)
//    and sums them in rank order with shuffles: the same order on every
//    run, no atomics, so two launches give equal bits;
//  - arrives at the exit barrier as soon as its last remote read is done
//    and waits for it only before leaving, so dx's stores overlap it.

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// this CTA's slice [0, n) of T copied to shared memory `dst`: 16-byte
// cp.async copies where `vec` (src 16-byte aligned), plain copies past
// them; the caller waits (cp_async_wait_all) and synchronises
template <typename T>
__device__ __forceinline__ void stage_slice(const T* src, T* dst, int n,
                                            bool vec) {
  constexpr int V = Pack<T>::n;
  const int nvec = vec ? n / V : 0;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x)
    cp_async16(dst + (size_t)i * V, src + (size_t)i * V);
  for (int e = nvec * V + threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the sum over the cluster of every thread's pair `v`, returned to every
// thread: warp shuffles, then the warps' sums in order by thread 0 into
// this CTA's `slot`; a cluster barrier; then lane q of warp 0 reads rank
// q's slot and lane 0 adds them in rank order. With `leave`, every thread
// arrives at the exit barrier right after the remote reads (the caller
// waits on it, `cluster_wait`, before it leaves).
__device__ __forceinline__ float2 cluster_sum2(cg::cluster_group& cluster,
                                               float2 v, float2* scratch,
                                               float2* slot, float2* bcast,
                                               bool leave) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 t = make_float2(0.f, 0.f);
    for (int w = 0; w < (int)blockDim.x / 32; ++w) {
      t.x += scratch[w].x;
      t.y += scratch[w].y;
    }
    *slot = t;
  }
  cluster.sync();
  if (warp == 0) {
    const int parts = (int)cluster.num_blocks();
    float2 r = make_float2(0.f, 0.f);
    if (lane < parts) r = *cluster.map_shared_rank(slot, lane);
    float2 t = make_float2(0.f, 0.f);
    for (int q = 0; q < parts; ++q) {
      t.x += __shfl_sync(0xffffffffu, r.x, q);
      t.y += __shfl_sync(0xffffffffu, r.y, q);
    }
    if (lane == 0) *bcast = t;
  }
  if (leave) cluster_arrive();
  __syncthreads();
  return *bcast;
}

template <typename T, bool kStageG>
__global__ void __launch_bounds__(kClusterThreads)
instance_norm_bwd_cluster(const T* __restrict__ x, const T* __restrict__ g,
                          const float* __restrict__ scale,
                          T* __restrict__ dx, float* __restrict__ part_scale,
                          float* __restrict__ part_bias, int channels, int hw,
                          float eps) {
  extern __shared__ float4 smem4[];
  __shared__ float2 scratch[kClusterThreads / 32];
  __shared__ float2 slots[2], bcast[1];
  constexpr int V = Pack<T>::n;
  cg::cluster_group cluster = cg::this_cluster();
  const int parts = (int)cluster.num_blocks();
  const int plane = blockIdx.x / parts;
  const size_t base = (size_t)plane * hw;
  const int c = plane % channels;
  int lo, hi;
  cluster_slice(hw, parts, (int)cluster.block_rank(), lo, hi);
  const int n = hi - lo;
  const int chunk = ((hw + parts - 1) / parts + 7) / 8 * 8;
  const T* xs = x + base + lo;
  const T* gs = g + base + lo;
  T* dxs = dx + base + lo;
  T* x_s = reinterpret_cast<T*>(smem4);        // this CTA's slice of x
  T* g_s = x_s + chunk;                        // and of g, with kStageG
  const bool vec = on16(xs) && on16(gs) && on16(dxs);
  const int nvec = vec ? n / V : 0;
  stage_slice(xs, x_s, n, vec);
  if (kStageG) stage_slice(gs, g_s, n, vec);
  cp_async_wait_all();
  __syncthreads();

  // V values of g at vector i, scalar e: staged or from device memory
  auto g_vec = [&](int i, float* v) {
    Pack<T>::load((kStageG ? g_s : gs) + (size_t)i * V, v);
  };
  auto g_at = [&](int e) { return kStageG ? to_f(g_s[e]) : load1(gs + e); };

  float2 s1 = make_float2(0.f, 0.f);             // (sum x, sum g)
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float xv[V], gv[V];
    Pack<T>::load(x_s + (size_t)i * V, xv);
    g_vec(i, gv);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      s1.x += xv[q];
      s1.y += gv[q];
    }
  }
#pragma unroll 4
  for (int e = nvec * V + threadIdx.x; e < n; e += blockDim.x) {
    s1.x += to_f(x_s[e]);
    s1.y += g_at(e);
  }
  s1 = cluster_sum2(cluster, s1, scratch, slots, bcast, false);
  const float mean = s1.x / hw;
  float2 s2 = make_float2(0.f, 0.f);             // (sum d^2, sum g*d)
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float xv[V], gv[V];
    Pack<T>::load(x_s + (size_t)i * V, xv);
    g_vec(i, gv);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const float d = xv[q] - mean;
      s2.x += d * d;
      s2.y += gv[q] * d;
    }
  }
#pragma unroll 4
  for (int e = nvec * V + threadIdx.x; e < n; e += blockDim.x) {
    const float d = to_f(x_s[e]) - mean;
    s2.x += d * d;
    s2.y += g_at(e) * d;
  }
  s2 = cluster_sum2(cluster, s2, scratch, slots + 1, bcast, true);
  const float inv = rsqrtf(s2.x / hw + eps);
  const float sg = s1.y, sgx = inv * s2.y;
  if (threadIdx.x == 0 && cluster.block_rank() == 0) {
    part_scale[plane] = sgx;
    part_bias[plane] = sg;
  }
  const float s = scale[c];
  const float m1 = s * sg / hw;
  const float m2 = s * sgx / hw;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float xv[V], gv[V], out[V];
    Pack<T>::load(x_s + (size_t)i * V, xv);
    g_vec(i, gv);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const float xh = (xv[q] - mean) * inv;
      out[q] = inv * (__fmul_rn(gv[q], s) - m1 - xh * m2);
    }
    Pack<T>::store(dxs + (size_t)i * V, out);
  }
#pragma unroll 4
  for (int e = nvec * V + threadIdx.x; e < n; e += blockDim.x) {
    const float xh = (to_f(x_s[e]) - mean) * inv;
    store1(dxs + e, inv * (__fmul_rn(g_at(e), s) - m1 - xh * m2));
  }
  cluster_wait();  // no CTA leaves while another may read its slots
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

// the backward's slices: ~kClusterSlice elements in bf16, whose x and g
// fit three CTAs an SM; ~kClusterSliceBwdF32 in f32, the same bytes (on
// the card this beat 16K-element f32 slices with x alone or with both
// staged; PERF.md)
constexpr int kClusterSliceBwdF32 = 8 * 1024;

template <typename T>
cudaError_t launch_bwd_cluster(const void* x, const void* g,
                               const float* scale, void* dx, float* part,
                               float* dscale, float* dbias, int planes,
                               int channels, int hw, float eps,
                               cudaStream_t stream) {
  const int target = sizeof(T) == 2 ? kClusterSlice : kClusterSliceBwdF32;
  int parts = (hw + target - 1) / target;
  parts = parts < 2 ? 2 : (parts > kMaxCluster ? kMaxCluster : parts);
  const size_t chunk = (size_t)(((hw + parts - 1) / parts + 7) / 8 * 8);
  // x and g staged where both fit the 227 KB a block may use (less the
  // static reduction scratch), else x alone
  const bool both = 2 * chunk * sizeof(T) <= 224 * 1024;
  const size_t smem = (both ? 2 : 1) * chunk * sizeof(T);
  auto kernel = both ? instance_norm_bwd_cluster<T, true>
                     : instance_norm_bwd_cluster<T, false>;
  static size_t smem_set[2] = {48 * 1024, 48 * 1024};
  cudaError_t err = stage_smem(kernel, smem, &smem_set[both]);
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
  err = cudaLaunchKernelEx(&cfg, kernel, (const T*)x, (const T*)g, scale,
                           (T*)dx, part, part + planes, channels, hw, eps);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  instance_norm_bwd_reduce<<<(channels + kThreads - 1) / kThreads, kThreads,
                             0, stream>>>(part, part + planes, dscale, dbias,
                                          planes / channels, channels);
  return cudaGetLastError();
}

// ---- the general form (form 1, redesigned for Hopper; its note is at the
// top): a plane of 513 to kMaxPlane elements at any element-aligned base,
// cut into 16-byte slots ----

// A plane of hw elements of T whose first element lies `ph` elements past
// a 16-byte boundary (its phase) covers the slots k = 0 .. slots - 1 of
// V = Pack<T>::n elements: slot k holds its elements [k V - ph, (k + 1) V -
// ph) that lie in [0, hw). Every slot is whole, at a 16-byte aligned
// address, except at most the first (the head) and the last (the tail).
template <typename T>
__device__ __forceinline__ int phase_of(const T* p) {
  return (int)(((uintptr_t)p & 15u) / sizeof(T));
}

// the most slots a plane of hw elements covers, whatever its phase
__host__ __device__ constexpr int any_pitch(int hw, int v) {
  return (hw + 2 * v - 2) / v;
}

// slots a thread takes (about), and the most threads a CTA: 512, so that
// two CTAs of a large plane fit an SM's registers (the bf16 backward takes
// ~60 a thread)
constexpr int kAnySlotsPerThread = 8;
constexpr int kAnyThreads = 512;

// The threads that take one plane: the CTA (a plane a CTA), or with kWarp
// one warp (a plane a warp, kWarpsPerCta planes a CTA: planes of at most
// 32 * kAnySlotsPerThread slots, which a CTA of one warp each took ~6%
// longer at 23x23; PERF.md). t: this thread's index among them, n: their
// number.
template <bool kWarp>
struct Group {
  int t, n;
  __device__ __forceinline__ Group()
      : t(kWarp ? (int)threadIdx.x % 32 : (int)threadIdx.x),
        n(kWarp ? 32 : (int)blockDim.x) {}
  __device__ __forceinline__ void sync() const {
    if (kWarp) __syncwarp();
    else __syncthreads();
  }
};

// f(e0, whole) for this thread's slots of a plane of hw elements at phase
// ph: slots t, t + n, ... (neighbouring threads on neighbouring 16 bytes);
// e0 is the slot's first element (negative in a head)
template <int V, bool kWarp, typename F>
__device__ __forceinline__ void for_slots(const Group<kWarp>& grp, int hw,
                                          int ph, F f) {
  const int slots = (ph + hw + V - 1) / V;
  for (int k = grp.t; k < slots; k += grp.n) {
    const int e0 = k * V - ph;
    f(e0, e0 >= 0 && e0 + V <= hw);
  }
}

// two bf16 in a 32-bit word, as floats (the first in the low half)
__device__ __forceinline__ void bf16_pair(unsigned w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

// the 8 bf16 at q, not 16-byte aligned, through 32-bit words: 4 words
// where q is 4-byte aligned, else 5, each pair taken across two words
__device__ __forceinline__ void bf16_words(const __nv_bfloat16* q, float* v) {
  const uintptr_t a = (uintptr_t)q;
  const unsigned* w = reinterpret_cast<const unsigned*>(a & ~(uintptr_t)3);
  if ((a & 3u) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) bf16_pair(w[i], v + 2 * i);
    return;
  }
  unsigned lo = w[0];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned hi = w[i + 1];
    bf16_pair(__byte_perm(lo, hi, 0x5432), v + 2 * i);
    lo = hi;
  }
}

// the V values of the slot at e0 of a plane of hw elements at p, in device
// or shared memory: one 16-byte read where the slot is whole and p + e0
// 16-byte aligned (p's phase is the slots'); a whole bf16 slot at another
// phase through 32-bit words; else one by one, 0 outside the plane
template <typename T>
__device__ __forceinline__ void slot_load(const T* p, int e0, int hw,
                                          bool whole, float* v) {
  constexpr int V = Pack<T>::n;
  if (whole && on16(p + e0)) {
    Pack<T>::load(p + e0, v);
    return;
  }
  if constexpr (sizeof(T) == 2) {
    if (whole) {
      bf16_words(p + e0, v);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int e = e0 + i;
    v[i] = whole || (e >= 0 && e < hw) ? to_f(p[e]) : 0.f;
  }
}

// A plane whose elements below `staged` sit in shared memory at s (element
// e at s[e]) and the rest in device memory at p: the slot at e0 read from
// the one that holds it, element by element where it holds both halves.
template <typename T>
struct Staged {
  const T* s;
  const T* p;
  int staged;
  __device__ __forceinline__ void load(int e0, int hw, bool whole,
                                       float* v) const {
    constexpr int V = Pack<T>::n;
    if (e0 + V <= staged) {
      slot_load(s, e0, hw, whole, v);
    } else if (e0 >= staged) {
      slot_load(p, e0, hw, whole, v);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int e = e0 + i;
        v[i] = whole || (e >= 0 && e < hw)
                   ? to_f(e < staged ? s[e] : p[e]) : 0.f;
      }
    }
  }
};

// the values v of the slot at e0 (whole or not) stored into p, whose phase
// is the slots'
template <typename T>
__device__ __forceinline__ void slot_store(T* p, int e0, int hw, bool whole,
                                           const float* v) {
  constexpr int V = Pack<T>::n;
  if (whole) {
    Pack<T>::store(p + e0, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int e = e0 + i;
    if (e >= 0 && e < hw) store1(p + e, v[i]);
  }
}

// The first `slots` slots of a plane of hw elements at p (phase ph) copied
// into shared memory s so that s's element e sits where p's does in its
// 16-byte line: s + ph is the staged plane, holding the elements below
// slots * V - ph. Whole slots by 16-byte cp.async, every copy of the
// thread in flight at once; then the head and the tail by scalars, one
// element a thread, so that their loads overlap the copies. The caller
// waits (cp_async_wait_all) and synchronises the group.
template <typename T, bool kWarp>
__device__ __forceinline__ void stage_any(const Group<kWarp>& grp,
                                          const T* p, int hw, int ph,
                                          int slots, T* s) {
  constexpr int V = Pack<T>::n;
  if (slots == 0) return;
  T* d = s + ph;
  const int head = min(hw, (V - ph) % V);
  const int end = min(hw, slots * V - ph);   // the staged elements' end
  const int whole = (end - head) / V;
  for (int j = grp.t; j < whole; j += grp.n)
    cp_async16(d + head + j * V, p + head + j * V);
  for (int e = grp.t; e < head && e < end; e += grp.n) d[e] = p[e];
  for (int e = head + whole * V + grp.t; e < end; e += grp.n) d[e] = p[e];
}

// sums over the CTA (any multiple of 32 threads up to 1024) of each
// thread's v[0..N), returned to every thread in v: warp butterflies, then
// every thread adds the warps' sums in warp order (the same bits in every
// thread and every run). `scratch` (N * 32 floats) serves this call alone,
// so one barrier is all it takes. With kWarp, the warp's butterflies alone.
template <bool kWarp, int N>
__device__ __forceinline__ void group_sums(float (&v)[N], float* scratch) {
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = warp_sum(v[k]);
  if (kWarp) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) scratch[k * 32 + warp] = v[k];
  }
  __syncthreads();
  const int warps = blockDim.x / 32;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float t = 0.f;
    for (int w = 0; w < warps; ++w) t += scratch[k * 32 + w];
    v[k] = t;
  }
}

// this thread's sum over its slots of a plane at phase ph
template <typename T, bool kWarp>
__device__ __forceinline__ float any_sum(const Group<kWarp>& grp,
                                         const Staged<T>& a, int hw, int ph) {
  constexpr int V = Pack<T>::n;
  float t = 0.f;
  for_slots<V>(grp, hw, ph, [&](int e0, bool whole) {
    float v[V];
    a.load(e0, hw, whole, v);
#pragma unroll
    for (int i = 0; i < V; ++i) t += v[i];
  });
  return t;
}

// the plane a group takes (planes past the last: none), and the group's
// shared memory of `region` elements of T
template <bool kWarp>
__device__ __forceinline__ int any_plane() {
  return kWarp ? (int)(blockIdx.x * kWarpsPerCta + threadIdx.x / 32)
               : (int)blockIdx.x;
}

template <typename T, bool kWarp>
__device__ __forceinline__ T* any_region(float4* smem4, int region) {
  return reinterpret_cast<T*>(smem4) +
         (kWarp ? (size_t)(threadIdx.x / 32) * region : 0);
}

// Forward. sx: x's slots staged (the first sx of the plane, all where
// they fit the CTA's share of shared memory), region: a group's shared
// memory in elements.
template <typename T, bool kWarp>
__global__ void __launch_bounds__(kAnyThreads)
instance_norm_fwd_any(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ y,
                      int planes, int channels, int hw, int sx, int region,
                      float eps) {
  extern __shared__ float4 smem4[];
  __shared__ float scratch[2][32];
  constexpr int V = Pack<T>::n;
  const int plane = any_plane<kWarp>();
  if (plane >= planes) return;           // with kWarp: the whole warp
  const Group<kWarp> grp;
  const size_t base = (size_t)plane * hw;
  const T* xp = x + base;
  T* yp = y + base;
  const int c = plane % channels;
  const int px = phase_of(xp);
  T* s = any_region<T, kWarp>(smem4, region);
  const Staged<T> xa{s + px, xp, sx * V - px};
  stage_any(grp, xp, hw, px, sx, s);
  cp_async_wait_all();
  grp.sync();
  float t[1] = {any_sum(grp, xa, hw, px)};
  group_sums<kWarp>(t, scratch[0]);
  const float mean = t[0] / hw;
  float q[1] = {0.f};
  for_slots<V>(grp, hw, px, [&](int e0, bool whole) {
    float v[V];
    xa.load(e0, hw, whole, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int e = e0 + i;
      const float d = whole || (e >= 0 && e < hw) ? v[i] - mean : 0.f;
      q[0] += d * d;
    }
  });
  group_sums<kWarp>(q, scratch[1]);
  const float inv = rsqrtf(q[0] / hw + eps);
  const float g = scale[c], bb = bias[c];
  // y in its own slots: 16-byte stores; x read across 16-byte lines where
  // x's phase is another
  for_slots<V>(grp, hw, phase_of(yp), [&](int e0, bool whole) {
    float v[V];
    xa.load(e0, hw, whole, v);
#pragma unroll
    for (int i = 0; i < V; ++i)
      v[i] = __fadd_rn(__fmul_rn(__fmul_rn(v[i] - mean, inv), g), bb);
    slot_store(yp, e0, hw, whole, v);
  });
}

// Backward, one launch: x and g staged (the first sx and sg slots: all
// where they fit, x first), the pairs (sum x, sum g) and (sum (x - m)^2,
// sum g (x - m)) in two reductions (sgx = inv * sum g (x - m), as the
// cluster backward), dx in its own slots; each group writes its plane's
// (sgx, sum g) to part, and the group that draws the last ticket sums them
// into dscale and dbias.
template <typename T, bool kWarp>
__global__ void __launch_bounds__(kAnyThreads)
instance_norm_bwd_any(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ scale, T* __restrict__ dx,
                      float* __restrict__ part_scale,
                      float* __restrict__ part_bias,
                      float* __restrict__ dscale, float* __restrict__ dbias,
                      unsigned* __restrict__ tickets, int planes,
                      int channels, int hw, int sx, int sg, int region,
                      float eps) {
  extern __shared__ float4 smem4[];
  __shared__ float scratch[2][2 * 32];
  __shared__ bool last_cta;
  constexpr int V = Pack<T>::n;
  const int plane = any_plane<kWarp>();
  if (plane >= planes) return;           // with kWarp: the whole warp
  const Group<kWarp> grp;
  const size_t base = (size_t)plane * hw;
  const T* xp = x + base;
  const T* gp = g + base;
  T* dxp = dx + base;
  const int c = plane % channels;
  const int px = phase_of(xp), pg = phase_of(gp);
  T* s = any_region<T, kWarp>(smem4, region);
  T* sgb = s + sx * V;                   // g's staging after x's
  const Staged<T> xa{s + px, xp, sx * V - px};
  const Staged<T> ga{sgb + pg, gp, sg * V - pg};
  stage_any(grp, xp, hw, px, sx, s);
  stage_any(grp, gp, hw, pg, sg, sgb);
  cp_async_wait_all();
  grp.sync();
  float s1[2] = {any_sum(grp, xa, hw, px), any_sum(grp, ga, hw, pg)};
  group_sums<kWarp>(s1, scratch[0]);
  const float mean = s1[0] / hw, sum_g = s1[1];
  float s2[2] = {0.f, 0.f};              // (sum d^2, sum g d), d = x - mean
  for_slots<V>(grp, hw, px, [&](int e0, bool whole) {
    float xv[V], gv[V];
    xa.load(e0, hw, whole, xv);
    ga.load(e0, hw, whole, gv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int e = e0 + i;
      const float d = whole || (e >= 0 && e < hw) ? xv[i] - mean : 0.f;
      s2[0] += d * d;
      s2[1] += gv[i] * d;
    }
  });
  group_sums<kWarp>(s2, scratch[1]);
  const float inv = rsqrtf(s2[0] / hw + eps);
  const float sgx = inv * s2[1];
  bool last = false;
  if (grp.t == 0) {
    part_scale[plane] = sgx;
    part_bias[plane] = sum_g;
    __threadfence();                     // the sums before the ticket
    last = atomicAdd(tickets, 1u) == (unsigned)planes - 1u;
  }
  const float sc = scale[c];
  const float m1 = sc * sum_g / hw;      // mean(gs)
  const float m2 = sc * sgx / hw;        // mean(gs * x_hat)
  for_slots<V>(grp, hw, phase_of(dxp), [&](int e0, bool whole) {
    float xv[V], gv[V];
    xa.load(e0, hw, whole, xv);
    ga.load(e0, hw, whole, gv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float xh = (xv[i] - mean) * inv;
      // an unfused g * s, as every form
      xv[i] = inv * (__fmul_rn(gv[i], sc) - m1 - xh * m2);
    }
    slot_store(dxp, e0, hw, whole, xv);
  });
  if (kWarp) {
    last = __shfl_sync(0xffffffffu, last, 0);
  } else {
    if (grp.t == 0) last_cta = last;
    __syncthreads();
    last = last_cta;
  }
  if (!last) return;
  // every other plane's sums are in part (each group fenced them before
  // its ticket): dscale[c] = sum over n of part_scale[n, c] in n order, as
  // instance_norm_bwd_reduce adds them; read past L1
  __threadfence();
  const int samples = planes / channels;
  for (int ch = grp.t; ch < channels; ch += grp.n) {
    float ss = 0.f, sb = 0.f;
    for (int n = 0; n < samples; ++n) {
      ss += __ldcg(part_scale + (size_t)n * channels + ch);
      sb += __ldcg(part_bias + (size_t)n * channels + ch);
    }
    dscale[ch] = ss;
    dbias[ch] = sb;
  }
  if (grp.t == 0) *tickets = 0u;         // ready for the stream's next call
}

// threads of a general-form CTA for a plane of `slots` 16-byte slots:
// about kAnySlotsPerThread a thread, a multiple of 32 from 32 to
// kAnyThreads (one warp at 23x23 in f32: such planes go a warp each,
// kWarpsPerCta a CTA)
inline int any_threads(int slots) {
  const int t = (slots + kAnySlotsPerThread - 1) / kAnySlotsPerThread;
  const int w = (t + 31) / 32 * 32;
  return w < 32 ? 32 : (w > kAnyThreads ? kAnyThreads : w);
}

// A CTA's shared memory for staging: two CTAs an SM (of its 228 KB, 1 KB
// reserved a CTA, the static arrays under 1 KB), or a whole SM's where two
// would leave more than an eighth of the plane unstaged. Past it, a
// plane's first slots are staged and the rest read from device memory in
// each pass (from L2 after the first, where it stays). Measured at
// 175x175 (PERF.md): the f32 forward and the bf16 backward, an eighth or
// less unstaged at two CTAs an SM, ran faster than at one, the f32
// backward (half of x and g unstaged) slower.
constexpr int kAnyStage = 112 * 1024;
constexpr int kAnyStageSm = 226 * 1024;

// The general form's launch: with one warp's worth of threads a plane, a
// plane a warp; x staged first, then g (backward) in what is left.
struct AnyLaunch {
  bool warp;
  int threads, ctas, sx, sg, region;
  size_t smem;
};

inline AnyLaunch any_launch(int planes, int hw, int v, bool backward) {
  AnyLaunch a;
  const int pitch = any_pitch(hw, v);
  a.threads = any_threads(pitch);
  a.warp = a.threads == 32;
  const int need = (backward ? 2 : 1) * pitch;   // slots
  const int two = kAnyStage / 16;
  const int stage = 8 * (need - two) <= need ? two : kAnyStageSm / 16;
  a.sx = pitch < stage ? pitch : stage;
  a.sg = !backward ? 0 : (pitch < stage - a.sx ? pitch : stage - a.sx);
  a.region = (a.sx + a.sg) * v;
  const int groups = a.warp ? kWarpsPerCta : 1;
  a.smem = (size_t)groups * (a.sx + a.sg) * 16;
  a.threads = a.warp ? kWarpsPerCta * 32 : a.threads;
  a.ctas = a.warp ? (planes + kWarpsPerCta - 1) / kWarpsPerCta : planes;
  return a;
}

template <typename T>
cudaError_t launch_any(const void* x, const float* scale, const float* bias,
                       void* y, int planes, int channels, int hw, float eps,
                       cudaStream_t stream) {
  const AnyLaunch a = any_launch(planes, hw, Pack<T>::n, false);
  auto kernel = a.warp ? instance_norm_fwd_any<T, true>
                       : instance_norm_fwd_any<T, false>;
  static size_t smem_set[2] = {48 * 1024, 48 * 1024};
  const cudaError_t err = stage_smem(kernel, a.smem, &smem_set[a.warp]);
  if (err != cudaSuccess) return err;
  kernel<<<a.ctas, a.threads, a.smem, stream>>>(
      (const T*)x, scale, bias, (T*)y, planes, channels, hw, a.sx, a.region,
      eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_any(const void* x, const void* g, const float* scale,
                           void* dx, float* part, unsigned* tickets,
                           float* dscale, float* dbias, int planes,
                           int channels, int hw, float eps,
                           cudaStream_t stream) {
  if (tickets == nullptr) return cudaErrorInvalidValue;
  const AnyLaunch a = any_launch(planes, hw, Pack<T>::n, true);
  auto kernel = a.warp ? instance_norm_bwd_any<T, true>
                       : instance_norm_bwd_any<T, false>;
  static size_t smem_set[2] = {48 * 1024, 48 * 1024};
  const cudaError_t err = stage_smem(kernel, a.smem, &smem_set[a.warp]);
  if (err != cudaSuccess) return err;
  kernel<<<a.ctas, a.threads, a.smem, stream>>>(
      (const T*)x, (const T*)g, scale, (T*)dx, part, part + planes, dscale,
      dbias, tickets, planes, channels, hw, a.sx, a.sg, a.region, eps);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// The form for planes of hw elements at these pointers: 0 vector, 1
// general, 2 cluster, 3 split, 4 warp (the code the entries report).
int pick_form(int hw, const void* a, const void* b, const void* c) {
  if (hw > kMaxPlane)
    return hw <= kMaxCluster * kMaxPlane ? 2 : 3;
  if (hw % 8 == 0 && aligned16(a) && aligned16(b) && aligned16(c)) return 0;
  return hw <= kWarpPlane ? 4 : 1;
}

template <typename T>
cudaError_t launch_fwd_form(int form, const void* x, const float* sc,
                            const float* bi, void* y, float* work, int planes,
                            int channels, int hw, float eps,
                            cudaStream_t s) {
  switch (form) {
    case 0: return launch<T>(x, sc, bi, y, planes, channels, hw, eps, s);
    case 1: return launch_any<T>(x, sc, bi, y, planes, channels, hw, eps, s);
    case 2:
      return launch_fwd_cluster<T>(x, sc, bi, y, planes, channels, hw, eps, s);
    case 3:
      return launch_fwd_split<T>(x, sc, bi, y, work, planes, channels, hw,
                                 eps, s);
    default:
      return launch_warp<T>(false, x, nullptr, sc, bi, y, nullptr, planes,
                            channels, hw, eps, s);
  }
}

template <typename T>
cudaError_t launch_bwd_form(int form, const void* x, const void* g,
                            const float* sc, void* dx, float* part,
                            float* work, unsigned* tickets, float* ds,
                            float* db, int planes, int channels, int hw,
                            float eps, cudaStream_t s) {
  switch (form) {
    case 0:
      return launch_bwd<T>(x, g, sc, dx, part, ds, db, planes, channels, hw,
                           eps, s);
    case 1:
      return launch_bwd_any<T>(x, g, sc, dx, part, tickets, ds, db, planes,
                               channels, hw, eps, s);
    case 2:
      return launch_bwd_cluster<T>(x, g, sc, dx, part, ds, db, planes,
                                   channels, hw, eps, s);
    case 3:
      return launch_bwd_split<T>(x, g, sc, dx, part, work, ds, db, planes,
                                 channels, hw, eps, s);
    default: {
      const cudaError_t err = launch_warp<T>(true, x, g, sc, nullptr, dx,
                                             part, planes, channels, hw, eps,
                                             s);
      if (err != cudaSuccess) return err;
      return launch_bwd_reduce(part, ds, db, planes, channels, s);
    }
  }
}

bool bad_args(int planes, int channels, int hw, int dtype) {
  return hw <= 0 || planes <= 0 || channels <= 0 || planes % channels ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// f32 elements of the scratch `work` the entries below need for planes of
// hw elements of a dtype (0 = f32, 1 = bf16): the split form's per-slice
// sums, 0 for every other form; -1 past an int
extern "C" int scflow_instance_norm_work(int planes, int hw, int backward,
                                         int dtype) {
  if (planes <= 0 || hw <= 0 || pick_form(hw, nullptr, nullptr, nullptr) != 3)
    return 0;
  const long long n =
      split_work(planes, hw, backward != 0, dtype == 1 ? 2 : 4);
  return n > 0x7fffffffLL ? -1 : (int)n;
}

// x, y (planes, hw) contiguous; dtype 0 = f32, 1 = bf16; scale, bias
// (channels,) f32; work: scflow_instance_norm_work(planes, hw, 0, dtype)
// f32 of scratch (may be null where that is 0). Any hw >= 1 and any
// element-aligned base; *form gets the form launched (pick_form's code).
extern "C" int scflow_instance_norm_fwd(const void* x, const void* scale,
                                        const void* bias, void* y, void* work,
                                        int planes, int channels, int hw,
                                        float eps, int dtype, int* form,
                                        void* stream) {
  if (bad_args(planes, channels, hw, dtype)) return (int)cudaErrorInvalidValue;
  *form = pick_form(hw, x, y, y);
  const float* sc = (const float*)scale;
  const float* bi = (const float*)bias;
  float* wk = (float*)work;
  const cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0
             ? (int)launch_fwd_form<float>(*form, x, sc, bi, y, wk, planes,
                                           channels, hw, eps, s)
             : (int)launch_fwd_form<__nv_bfloat16>(*form, x, sc, bi, y, wk,
                                                   planes, channels, hw, eps,
                                                   s);
}

// x, g, dx (planes, hw) contiguous, of one dtype (0 = f32, 1 = bf16);
// scale, dscale, dbias (channels,) f32; part (2, planes) f32 scratch for
// the per-plane sums; work as for the forward, with backward = 1;
// tickets: one 32-bit counter, 0 before the call and 0 again after it,
// which no launch on another stream uses at the same time (the general
// form's CTAs draw tickets from it; the other forms leave it alone). *form
// as for the forward (the vector form needs x, g and dx aligned).
extern "C" int scflow_instance_norm_bwd(const void* x, const void* g,
                                        const void* scale, void* dx,
                                        void* part, void* work, void* tickets,
                                        void* dscale, void* dbias, int planes,
                                        int channels, int hw, float eps,
                                        int dtype, int* form, void* stream) {
  if (bad_args(planes, channels, hw, dtype)) return (int)cudaErrorInvalidValue;
  *form = pick_form(hw, x, g, dx);
  const float* sc = (const float*)scale;
  float* pa = (float*)part;
  float* wk = (float*)work;
  unsigned* tk = (unsigned*)tickets;
  float* ds = (float*)dscale;
  float* db = (float*)dbias;
  const cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0
             ? (int)launch_bwd_form<float>(*form, x, g, sc, dx, pa, wk, tk,
                                           ds, db, planes, channels, hw, eps,
                                           s)
             : (int)launch_bwd_form<__nv_bfloat16>(*form, x, g, sc, dx, pa,
                                                   wk, tk, ds, db, planes,
                                                   channels, hw, eps, s);
}
