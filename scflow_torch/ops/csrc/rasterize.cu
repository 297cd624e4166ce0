// Tile rasterizer for Hopper (sm_90a): the binning, z-test and attribute
// interpolation of one 32x32 pixel tile in one CTA.
//
// Replaces the Pallas TPU kernel `_rasterize_kernel` of
// scflow_tpu/ops/rasterize_fast.py (launched from `rasterize_fast`), with
// the per-tile face selection (`_select_tiles`) and the key decode around it.
//
// What it computes, per (sample, tile):
//  - the selection of `_select_tiles`: a chunk of 8 faces overlaps the tile
//    if one of its faces is usable (coefficient channel 14 > 0) and has a
//    bounding box within the tile's +-0.5 pixel margin; the first k/8
//    overlapping chunks in face order fill the k slots as a prefix, all 8
//    faces of a chunk together;
//  - for every pixel and filled slot: three edge functions with the area
//    sign folded in and the inside test; z = sum w_k * zt_k (zt already
//    divided by |area|); a packed int32 key, the bits of max(z, 1e-30) with
//    the low 14 bits replaced by the face id, whose minimum is the z-test
//    with ties broken by face id;
//  - the winner's face id (-1 where no face covers), z and attributes
//    interpolated from its edge weights (<= 16 channels, premultiplied by
//    1/|area|), 0 on background. With no attributes (d_attr 0, the TPU
//    kernel's `tri_attrs=None` form: depth and masks only) it writes face
//    ids and z alone.
//
// What bounds it on this card: bytes. Each pixel writes a 4-byte face id,
// a 4-byte z and d_attr attribute floats; of each face, the 14 coefficients
// the pass uses (edges, z, id, usable flag) and its 3*d_attr attribute
// floats are read once. At the main path's render (batch 32, 256x256, 1280
// faces, d_attr 9) that is 92.3 MB of output and 6.7 MB of input, 99.0 MB,
// 0.0295 ms at 3.35 TB/s. The arithmetic is 22
// operations per filled (pixel, slot) pair (edge functions 12, z 5, key and
// running min 5); ~28M pairs there, 0.6 G operations, 0.009 ms at the
// 67 TFLOP/s FP32 peak. So the kernel should cost what its stores cost, and
// everything else should hide under them.
//
// What the design does about it:
//  - One CTA per (sample, tile), one launch for the batch: 2048 CTAs at the
//    main path's render. CTAs start central tiles first (`center_out`):
//    crops are centred on their object, so the heavy tiles start early and
//    the light border tiles fill the tail.
//  - Binning in the kernel; no selection tensor is written or read. Each
//    warp votes on 256 faces: all eight 16-byte box loads of a lane are in
//    flight at once, channel 14 is read only where a box overlaps,
//    `__ballot_sync` turns the votes into 32 chunk flags, and `__popc` with
//    a shared array of warp counts ranks the chunks. Blocks of 256 chunks
//    are scanned with a running total until the slots are full.
//  - A tile that no chunk overlaps (most of the frame) writes -1 / 0 / 0
//    with 16-byte stores and does nothing else.
//  - The chosen faces' coefficient rows (16 floats) and the 3*d_attr
//    attribute floats they use are staged in shared memory with cp.async, so
//    a thread's copies wait on one memory latency, not one each.
//  - Exact culling: a chosen face that is unusable, or has an edge negative
//    at all four corners of the tile, is inside no pixel of the tile (see
//    `reaches_tile`) and is left out of the face loop. Chunks bring 8 faces
//    each, and not all of them reach the tile.
//  - Face loop: 256 threads, one pixel column and four rows each; the
//    running min key and winning slot stay in registers, a*px of each edge
//    is shared by a thread's four pixels, and z and the key are computed
//    only inside the face. All lanes read the same row, a broadcast.
//  - Epilogue, per warp and without CTA barriers: a warp's 32 lanes are one
//    image row of the tile, so face ids and z leave straight from registers
//    as 128 contiguous bytes. The winner's attributes are interpolated from
//    its staged row and staged per warp, and the row's 32*d_attr floats
//    (1152 B for Phong) leave as contiguous 16-byte stores. The attribute
//    count is a template parameter for Phong (9), the main path's shading,
//    so its loops unroll; other counts take the generic instantiation.
//  - No attributes (d_attr 0) is an instantiation of its own: it stages
//    only the coefficient rows (16 KB of shared memory at k = 256) and its
//    epilogue stores 8 bytes per pixel, face id and z, straight from
//    registers. At batch 32 x 256x256 that is 16.8 MB of output and ~2.3
//    MB of face rows read, 0.0057 ms at 3.35 TB/s, less than the 0.009 ms
//    of its 0.6 G operations: without attributes the bound is arithmetic.
//
// Rounding: the edge, z and attribute arithmetic is written with
// __fmul_rn / __fadd_rn in the order of the plain PyTorch version
// (`rasterize_tiles_reference`), so nvcc contracts nothing into FMA and
// face ids, z and attributes agree bit for bit with it on the same inputs.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixPerThread = kTile * kTile / kThreads;    // 4
constexpr int kChunk = 8;
constexpr int kMaxFaces = 256;
constexpr int kMaxChunks = kMaxFaces / kChunk;             // 32
static_assert(kMaxFaces <= kThreads, "the cull gives each slot a thread");
constexpr int kIdBits = 14;
constexpr int kBigKey = 0x7F7F0000;
constexpr int kAttrPad = 16;
// dynamic shared memory: coefficient rows, attribute rows, output staging
constexpr int smem_bytes(int k, int d_attr) {
  return k * 16 * 4 + k * 3 * d_attr * 4 + kThreads * d_attr * 4;
}

// asynchronous global -> shared copies (sm_80+): a thread queues all of its
// copies before waiting for any, so staging costs one memory latency
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 0, 1, 2, ... -> the middle of 0..n-1 first, then alternately outwards
__device__ __forceinline__ int center_out(int i, int n) {
  return n / 2 + ((i & 1) ? -((i + 1) >> 1) : (i >> 1));
}

__device__ __forceinline__ float edge(float apx, float b, float c, float py) {
  // a*px + (b*py + c), unfused; a*px is passed in
  return __fadd_rn(apx, __fadd_rn(__fmul_rn(b, py), c));
}

// Whether the edge a*px + (b*py + c), evaluated as `edge` rounds it, is >= 0
// at a corner of the tile [x0, x0 + 31] x [y0, y0 + 31]. Correct rounding
// is monotone, so the rounded edge is monotone in px and in py and takes
// its maximum over the tile's pixels at a corner: an edge negative at all
// four is negative at every pixel of the tile.
__device__ __forceinline__ bool reaches_tile(float a, float b, float c,
                                             float x0, float y0) {
  const float x1 = x0 + (kTile - 1), y1 = y0 + (kTile - 1);
  const float ax0 = __fmul_rn(a, x0), ax1 = __fmul_rn(a, x1);
  return edge(ax0, b, c, y0) >= 0.f || edge(ax1, b, c, y0) >= 0.f ||
         edge(ax0, b, c, y1) >= 0.f || edge(ax1, b, c, y1) >= 0.f;
}

__device__ __forceinline__ float blend(float w0, float w1, float w2, float v0,
                                       float v1, float v2) {
  // (w0*v0 + w1*v1) + w2*v2, unfused
  return __fadd_rn(__fadd_rn(__fmul_rn(w0, v0), __fmul_rn(w1, v1)),
                   __fmul_rn(w2, v2));
}

// coeff row layout (4 float4): [a0 b0 c0 a1] [b1 c1 a2 b2] [c2 zt0 zt1 zt2]
// [inv fid valid pad]; bbox row: [xmin xmax ymin ymax]. kD >= 0 fixes the
// attribute count at compile time (unrolled attribute loops, constant
// divisions; kD = 0 reads and writes no attributes at all); kD = -1 takes
// d_in.
template <int kD>
__global__ void __launch_bounds__(kThreads)
rasterize_tiles_kernel(const float4* __restrict__ coeff,
                       const float4* __restrict__ bbox,
                       const float* __restrict__ attr,
                       int* __restrict__ fid_out, float* __restrict__ z_out,
                       float* __restrict__ attr_out, int faces, int k,
                       int height, int width, int d_in) {
  const int d_attr = kD >= 0 ? kD : d_in;
  constexpr bool kAttrs = kD != 0;
  extern __shared__ float4 smem[];
  __shared__ int warp_count[kWarps];
  __shared__ int chosen[kMaxChunks];
  __shared__ int live_slot[kMaxFaces];

  // blockIdx.x is the sample, blockIdx.y the tile's rank: CTAs start in
  // rank order, and the central tiles, where the objects of crops are and
  // the work is, come first, so the light border tiles fill the tail
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles_x = width / kTile;
  const int y0 =
      center_out(blockIdx.y / tiles_x, height / kTile) * kTile;
  const int x0 = center_out(blockIdx.y % tiles_x, tiles_x) * kTile;
  const float4* coeff_b = coeff + (size_t)b * faces * 4;
  const float4* bbox_b = bbox + (size_t)b * faces;

  // ---- binning: rank the overlapping chunks, keep the first k/8 ----------
  const float xlo = (float)x0 - 0.5f, xhi = (float)(x0 + kTile) - 0.5f;
  const float ylo = (float)y0 - 0.5f, yhi = (float)(y0 + kTile) - 0.5f;
  const int k8 = k / kChunk;
  const float inf = __int_as_float(0x7f800000);
  const float4 no_box = make_float4(inf, -inf, inf, -inf);  // overlaps none
  int total = 0;                   // overlapping chunks so far, block-uniform
  for (int base = 0; base < faces && total < k8;
       base += kThreads * kChunk) {
    const int wbase = base + warp * 32 * kChunk;  // this warp's 32 chunks
    // all eight box loads are in flight before the first test, and the
    // usable flags (channel 14) of the overlapping faces after it
    float4 box[kChunk];
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const int f = wbase + s * 32 + lane;
      box[s] = f < faces ? bbox_b[f] : no_box;
    }
    float ok[kChunk];
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const int f = wbase + s * 32 + lane;
      const float4 bb = box[s];
      const bool overlap =
          bb.y >= xlo && bb.x <= xhi && bb.w >= ylo && bb.z <= yhi;
      ok[s] = overlap
                  ? reinterpret_cast<const float*>(coeff_b + f * 4 + 3)[2]
                  : 0.f;
    }
    unsigned flags = 0;                           // bit i: chunk wbase/8 + i
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const unsigned vote = __ballot_sync(0xffffffffu, ok[s] > 0.f);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if ((vote >> (q * kChunk)) & 0xffu) flags |= 1u << (s * 4 + q);
    }
    if (lane == 0) warp_count[warp] = __popc(flags);
    __syncthreads();
    int before = total;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_count[w];
      if (w < warp) before += c;
      total += c;
    }
    if ((flags >> lane) & 1u) {
      const int rank = before + __popc(flags & ((1u << lane) - 1u));
      if (rank < k8) chosen[rank] = wbase / kChunk + lane;
    }
    __syncthreads();               // warp_count is rewritten next block
  }
  const int filled = min(total, k8) * kChunk;

  // ---- empty tile: background with 16-byte stores -------------------------
  const int row_vecs = 8 * (2 + d_attr);  // float4s per image row of the tile
  if (filled == 0) {
    const int4 no_face = make_int4(-1, -1, -1, -1);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tid; i < kTile * row_vecs; i += kThreads) {
      const int r = i / row_vecs, v = i - r * row_vecs;
      const size_t pix = ((size_t)b * height + y0 + r) * width + x0;
      if (v < 8)
        reinterpret_cast<int4*>(fid_out + pix)[v] = no_face;
      else if (!kAttrs || v < 16)
        reinterpret_cast<float4*>(z_out + pix)[v - 8] = zero;
      else
        reinterpret_cast<float4*>(attr_out + pix * d_attr)[v - 16] = zero;
    }
    return;
  }

  // ---- stage the chosen faces' rows in shared memory ----------------------
  float4* rows = smem;                                        // filled * 4
  float* attr_s = reinterpret_cast<float*>(smem + k * 4);     // filled * 3d
  float* a_s = attr_s + k * 3 * d_attr;      // kThreads * d: a row per warp
  for (int i = tid; i < filled * 4; i += kThreads) {
    const int slot = i >> 2;
    const int face = chosen[slot / kChunk] * kChunk + slot % kChunk;
    cp_async16(rows + i, coeff_b + face * 4 + (i & 3));
  }
  const int n3d = 3 * d_attr;
  for (int i = tid; kAttrs && i < filled * 3; i += kThreads) {  // (slot, v)
    const int slot = i / 3, v = i - slot * 3;
    const int face = chosen[slot / kChunk] * kChunk + slot % kChunk;
    const float* src =
        attr + ((size_t)b * faces + face) * (3 * kAttrPad) + v * kAttrPad;
    float* dst = attr_s + slot * n3d + v * d_attr;
#pragma unroll
    for (int c = 0; c < d_attr; ++c) cp_async4(dst + c, src + c);
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- the slots whose face can cover a pixel of the tile, in order -------
  // a face is dropped if it is unusable (culled back face, padding) or an
  // edge is negative over the whole tile: it is inside no pixel here, so
  // the z-test does not change without it
  bool live = false;
  if (tid < filled) {
    const float4 r0 = rows[tid * 4 + 0];
    const float4 r1 = rows[tid * 4 + 1];
    const float4 r2 = rows[tid * 4 + 2];
    const float4 r3 = rows[tid * 4 + 3];
    const float fx = (float)x0, fy = (float)y0;
    live = r3.z > 0.f && reaches_tile(r0.x, r0.y, r0.z, fx, fy) &&
           reaches_tile(r0.w, r1.x, r1.y, fx, fy) &&
           reaches_tile(r1.z, r1.w, r2.x, fx, fy);
  }
  const unsigned live_vote = __ballot_sync(0xffffffffu, live);
  if (lane == 0) warp_count[warp] = __popc(live_vote);
  __syncthreads();
  int n_live = 0, live_before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_count[w];
    if (w < warp) live_before += c;
    n_live += c;
  }
  if (live)
    live_slot[live_before + __popc(live_vote & ((1u << lane) - 1u))] = tid;
  __syncthreads();

  // ---- face loop: running min key per pixel -------------------------------
  // thread tid owns column x0 + lane of rows warp + 8 j: a warp is a row
  const float px = (float)(x0 + lane);
  float py[kPixPerThread];
  int best[kPixPerThread], slot[kPixPerThread];
#pragma unroll
  for (int j = 0; j < kPixPerThread; ++j) {
    py[j] = (float)(y0 + warp + j * kWarps);
    best[j] = kBigKey;
    slot[j] = -1;
  }
  for (int i = 0; i < n_live; ++i) {
    const int f = live_slot[i];
    const float4 r0 = rows[f * 4 + 0];
    const float4 r1 = rows[f * 4 + 1];
    const float4 r2 = rows[f * 4 + 2];
    const int fid = (int)rows[f * 4 + 3].y;
    const float a0px = __fmul_rn(r0.x, px);
    const float a1px = __fmul_rn(r0.w, px);
    const float a2px = __fmul_rn(r1.z, px);
#pragma unroll
    for (int j = 0; j < kPixPerThread; ++j) {
      const float w0 = edge(a0px, r0.y, r0.z, py[j]);
      const float w1 = edge(a1px, r1.x, r1.y, py[j]);
      const float w2 = edge(a2px, r1.w, r2.x, py[j]);
      if (w0 >= 0.f && w1 >= 0.f && w2 >= 0.f) {
        const float zi = blend(w0, w1, w2, r2.y, r2.z, r2.w);
        const int zkey = __float_as_int(fmaxf(zi, 1e-30f));
        const int key = ((zkey >> kIdBits) << kIdBits) | fid;
        if (key < best[j]) {
          best[j] = key;
          slot[j] = f;
        }
      }
    }
  }

  // ---- epilogue: each warp writes its own four image rows ----------------
  // face id and z go out straight from registers (a warp's 32 lanes are 128
  // contiguous bytes of a row); a pixel's attributes are staged so that the
  // row's 32 * d_attr floats leave as contiguous 16-byte stores
  float* a_row = a_s + warp * kTile * d_attr;
#pragma unroll
  for (int j = 0; j < kPixPerThread; ++j) {
    const size_t pix =
        ((size_t)b * height + y0 + warp + j * kWarps) * width + x0;
    float* a_px = a_row + lane * d_attr;
    if (slot[j] < 0) {
      fid_out[pix + lane] = -1;
      z_out[pix + lane] = 0.f;
      if (!kAttrs) continue;
#pragma unroll
      for (int c = 0; c < d_attr; ++c) a_px[c] = 0.f;
    } else {
      const float4 r0 = rows[slot[j] * 4 + 0];
      const float4 r1 = rows[slot[j] * 4 + 1];
      const float4 r2 = rows[slot[j] * 4 + 2];
      const float w0 = edge(__fmul_rn(r0.x, px), r0.y, r0.z, py[j]);
      const float w1 = edge(__fmul_rn(r0.w, px), r1.x, r1.y, py[j]);
      const float w2 = edge(__fmul_rn(r1.z, px), r1.w, r2.x, py[j]);
      fid_out[pix + lane] = best[j] & ((1 << kIdBits) - 1);
      z_out[pix + lane] = blend(w0, w1, w2, r2.y, r2.z, r2.w);
      if (!kAttrs) continue;
      const float* a = attr_s + slot[j] * n3d;
#pragma unroll
      for (int c = 0; c < d_attr; ++c)
        a_px[c] = blend(w0, w1, w2, a[c], a[d_attr + c], a[2 * d_attr + c]);
    }
    __syncwarp();
    float4* dst = reinterpret_cast<float4*>(attr_out + pix * d_attr);
    for (int v = lane; v < 8 * d_attr; v += 32)
      dst[v] = reinterpret_cast<const float4*>(a_row)[v];
    __syncwarp();
  }
}

}  // namespace

extern "C" const char* scflow_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// coeff (n, faces, 16) f32, bbox (n, faces, 4) f32, attr (n, faces, 48) f32,
// all 16-byte aligned, faces a multiple of 8 below 2^14; outputs face_id
// (n, H, W) i32, zbuf (n, H, W) f32, attrs (n, H, W, d_attr) f32. With
// d_attr 0, attr and attrs are not touched (null is fine). Launches on
// `stream`; returns the launch's cudaError_t.
extern "C" int scflow_rasterize_tiles(const void* coeff, const void* bbox,
                                      const void* attr, void* face_id,
                                      void* zbuf, void* attrs, int n,
                                      int faces, int k, int height, int width,
                                      int d_attr, void* stream) {
  if (k <= 0 || k > kMaxFaces || k % kChunk || faces <= 0 ||
      faces % kChunk || faces >= (1 << kIdBits) || height % kTile ||
      width % kTile || (height / kTile) * (width / kTile) > 65535 ||
      d_attr < 0 || d_attr > kAttrPad)
    return (int)cudaErrorInvalidValue;
  // Phong, the main path's shading, interpolates 9 channels; depth-only and
  // mask-only renders none
  void (*kernel)(const float4*, const float4*, const float*, int*, float*,
                 float*, int, int, int, int, int) =
      d_attr == 9   ? &rasterize_tiles_kernel<9>
      : d_attr == 0 ? &rasterize_tiles_kernel<0>
                    : &rasterize_tiles_kernel<-1>;
  // above 48 KB only after this; the attribute belongs to the current
  // device, so it is set on every launch
  const int smem = smem_bytes(k, d_attr);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n, (height / kTile) * (width / kTile));
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)coeff, (const float4*)bbox, (const float*)attr,
      (int*)face_id, (float*)zbuf, (float*)attrs, faces, k, height, width,
      d_attr);
  return (int)cudaGetLastError();
}
