// Tile rasterizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rasterize_kernel` of
// scflow_tpu/ops/rasterize_fast.py (launched from `rasterize_fast`).
//
// What it computes, for every pixel of a 32x32 tile and each of the (at
// most K = 256) faces selected for that tile: three edge functions with the
// area sign folded in and the inside test; z = sum w_k * zt_k (zt already
// divided by |area|); a packed int32 key, the bits of max(z, 1e-30) with the
// low 14 bits replaced by the face id, whose minimum is the z-test with ties
// broken by face id; then the winner's z and its attributes interpolated
// from its edge weights (<= 16 channels, premultiplied by 1/|area|).
//
// What bounds it on this card: the bytes it writes. Every pixel stores a
// 4-byte key, a 4-byte z and d_attr attribute floats (9 for Phong), each
// pixel's attributes 36 bytes apart: at batch 32 and 256x256 that is 92 MB
// of output, 0.028 ms at 3.35 TB/s, against ~13 MB of inputs. The arithmetic
// is the second bound: each (pixel, face) pair costs 17 FP32 operations
// (6 mul + 6 add for the edge functions, 3 mul + 2 add for z) plus
// 4 compares, 1 max and ~5 integer ops for the key and the running min,
// 22 in all; the main path's render has ~28M pairs (only the covered tiles'
// filled slots), 0.6 GFLOP, 0.009 ms at the 67 TFLOP/s FP32 peak.
//
// What the design does about it:
//  - One CTA per (sample, tile): a single launch covers the whole batch,
//    2048 CTAs at batch 32 and 256x256, so all 132 SMs stay busy.
//  - The tile's K coefficient rows (16 floats each, 16 KB at K = 256) are
//    staged once in shared memory. All threads of a warp read the same row
//    at the same time, a broadcast without bank conflicts.
//  - 256 threads, 4 pixels each: one row read from shared memory feeds four
//    pixels' arithmetic, and the running min key and winning slot stay in
//    registers. This replaces the TPU's (P, K) one-hot mask and its three
//    (P,K)@(K,16) MXU products.
//  - The loop runs over the filled slots only: selection fills slots as a
//    prefix, so a tile that overlaps few faces does little work.
//  - At the end each pixel recomputes its winner's three weights and reads
//    only the winner's 48-float attribute row from global memory (mostly L2
//    hits), and writes key, z and attributes straight into (N, H, W[, D])
//    image layout, each output byte once. Key and z stores of a warp are
//    coalesced; the attribute stores go out one channel at a time with a
//    36-byte stride between neighbouring lanes, the first suspect for the
//    distance to the byte bound (staging them through shared memory for
//    contiguous rows is not done yet).
//
// Rounding: the edge, z and attribute arithmetic is written with
// __fmul_rn / __fadd_rn in the order of the plain PyTorch version, so nvcc
// contracts nothing into FMA and the inside test and the keys agree bit for
// bit with `rasterize_tiles_reference` on the same inputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kPixPerThread = kTile * kTile / kThreads;   // 4
constexpr int kMaxFaces = 256;
constexpr int kIdBits = 14;
constexpr int kBigKey = 0x7F7F0000;
constexpr int kAttrPad = 16;

__device__ __forceinline__ float edge(float a, float b, float c, float px,
                                      float py) {
  // a*px + (b*py + c), unfused
  return __fadd_rn(__fmul_rn(a, px), __fadd_rn(__fmul_rn(b, py), c));
}

__device__ __forceinline__ float blend(float w0, float w1, float w2, float v0,
                                       float v1, float v2) {
  // (w0*v0 + w1*v1) + w2*v2, unfused
  return __fadd_rn(__fadd_rn(__fmul_rn(w0, v0), __fmul_rn(w1, v1)),
                   __fmul_rn(w2, v2));
}

// coeff row layout (4 float4): [a0 b0 c0 a1] [b1 c1 a2 b2] [c2 zt0 zt1 zt2]
// [inv fid valid pad]
__global__ void __launch_bounds__(kThreads)
rasterize_tiles_kernel(const float4* __restrict__ coeff,
                       const int* __restrict__ sel,
                       const float* __restrict__ attr,
                       int* __restrict__ key_out, float* __restrict__ z_out,
                       float* __restrict__ attr_out, int faces, int k,
                       int height, int width, int d_attr) {
  __shared__ float4 rows[kMaxFaces * 4];

  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int tiles_x = width / kTile;
  const int num_tiles = tiles_x * (height / kTile);
  const int y0 = (tile / tiles_x) * kTile;
  const int x0 = (tile % tiles_x) * kTile;

  // stage the filled slots (a prefix of the K slots) in shared memory
  const int* sel_t = sel + ((size_t)b * num_tiles + tile) * k;
  const int s = threadIdx.x;
  const int face = s < k ? sel_t[s] : -1;
  if (face >= 0) {
    const float4* src = coeff + ((size_t)b * faces + face) * 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) rows[s * 4 + q] = src[q];
  }
  const int filled = __syncthreads_count(face >= 0);

  float px[kPixPerThread], py[kPixPerThread];
  int best[kPixPerThread], slot[kPixPerThread];
#pragma unroll
  for (int j = 0; j < kPixPerThread; ++j) {
    const int p = threadIdx.x + j * kThreads;
    px[j] = (float)(x0 + p % kTile);
    py[j] = (float)(y0 + p / kTile);
    best[j] = kBigKey;
    slot[j] = -1;
  }

  for (int f = 0; f < filled; ++f) {
    const float4 r0 = rows[f * 4 + 0];
    const float4 r1 = rows[f * 4 + 1];
    const float4 r2 = rows[f * 4 + 2];
    const float4 r3 = rows[f * 4 + 3];
    const bool valid = r3.z > 0.f;
    const int fid = (int)r3.y;
#pragma unroll
    for (int j = 0; j < kPixPerThread; ++j) {
      const float w0 = edge(r0.x, r0.y, r0.z, px[j], py[j]);
      const float w1 = edge(r0.w, r1.x, r1.y, px[j], py[j]);
      const float w2 = edge(r1.z, r1.w, r2.x, px[j], py[j]);
      const float zi = blend(w0, w1, w2, r2.y, r2.z, r2.w);
      const int zkey = __float_as_int(fmaxf(zi, 1e-30f));
      const int key = ((zkey >> kIdBits) << kIdBits) | fid;
      const bool inside = valid && w0 >= 0.f && w1 >= 0.f && w2 >= 0.f;
      if (inside && key < best[j]) {
        best[j] = key;
        slot[j] = f;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kPixPerThread; ++j) {
    const int p = threadIdx.x + j * kThreads;
    const size_t pix = ((size_t)b * height + y0 + p / kTile) * width + x0 +
                       p % kTile;
    key_out[pix] = best[j];
    float* a_out = attr_out + pix * d_attr;
    if (slot[j] < 0) {
      z_out[pix] = 0.f;
      for (int c = 0; c < d_attr; ++c) a_out[c] = 0.f;
      continue;
    }
    const float4 r0 = rows[slot[j] * 4 + 0];
    const float4 r1 = rows[slot[j] * 4 + 1];
    const float4 r2 = rows[slot[j] * 4 + 2];
    const float w0 = edge(r0.x, r0.y, r0.z, px[j], py[j]);
    const float w1 = edge(r0.w, r1.x, r1.y, px[j], py[j]);
    const float w2 = edge(r1.z, r1.w, r2.x, px[j], py[j]);
    z_out[pix] = blend(w0, w1, w2, r2.y, r2.z, r2.w);
    const int fid = best[j] & ((1 << kIdBits) - 1);
    const float* a = attr + ((size_t)b * faces + fid) * (3 * kAttrPad);
    for (int c = 0; c < d_attr; ++c)
      a_out[c] = blend(w0, w1, w2, __ldg(a + c), __ldg(a + kAttrPad + c),
                       __ldg(a + 2 * kAttrPad + c));
  }
}

}  // namespace

extern "C" const char* scflow_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// coeff (n, faces, 16) f32, sel (n, T, k) i32, attr (n, faces, 48) f32;
// outputs key (n, H, W) i32, zbuf (n, H, W) f32, attrs (n, H, W, d_attr)
// f32. Launches on `stream`; returns the launch's
// cudaError_t.
extern "C" int scflow_rasterize_tiles(const void* coeff, const void* sel,
                                      const void* attr, void* key, void* zbuf,
                                      void* attrs, int n, int faces, int k,
                                      int height, int width, int d_attr,
                                      void* stream) {
  if (k <= 0 || k > kMaxFaces || height % kTile || width % kTile ||
      d_attr <= 0 || d_attr > kAttrPad)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((height / kTile) * (width / kTile), n);
  rasterize_tiles_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)coeff, (const int*)sel, (const float*)attr, (int*)key,
      (float*)zbuf, (float*)attrs, faces, k, height, width, d_attr);
  return (int)cudaGetLastError();
}
