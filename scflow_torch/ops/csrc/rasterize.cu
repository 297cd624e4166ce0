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
// What the design does about it (two launches a call; PERF.md has the
// measurements behind it):
//  - Binning is a launch of its own whose cost follows the faces, not
//    tiles x faces. `bin_chunks_kernel` gives each usable face one thread:
//    it reads the face's box and usable flag once, finds the tiles its box
//    overlaps within the +-0.5 pixel margin (the exact comparisons of
//    `_select_tiles`) and ORs its chunk's bit into those tiles' chunk masks
//    in shared memory. A CTA takes the 256 faces of one 32-bit mask word
//    for every tile (or for a group of tiles on very large frames), so each
//    word has one writer: no memset, no global atomics, and the OR is
//    order-free, so the masks are the same bits on every run. (Each raster
//    CTA reading all F boxes of its sample would cost tiles x faces: 20 KB
//    a CTA at 1280 faces, 197 MB of L2 reads at 32 x 480x640.)
//  - The raster launch is a programmatic dependent launch: its CTAs are
//    scheduled while the binning runs and wait for it (`griddepcontrol`)
//    before they read their masks, so the second launch adds no launch gap.
//  - One raster CTA per (sample, tile): 2048 CTAs at the main path's
//    render. CTAs start central tiles first (`center_out`): crops are
//    centred on their object, so the heavy tiles start early and the light
//    border tiles fill the tail. A CTA reads its tile's mask words (one
//    thread a word, in parallel) and ranks the set bits in face order with
//    `__popc` and a warp scan: the first k/8 are its chunks.
//  - A tile with no chunk (most of a frame) writes -1 / 0 / 0 with 16-byte
//    stores and does nothing else: 8 bytes a pixel without attributes.
//  - The chosen faces' coefficient rows (16 floats) and the 3*d_attr
//    attribute floats they use are staged in shared memory with cp.async, so
//    a thread's copies wait on one memory latency, not one each.
//  - Exact culling, twice: a chosen face that is unusable, or has an edge
//    negative at all four corners of the tile, is inside no pixel of the
//    tile (see `reaches_rect`) and leaves the tile's list. Then each warp,
//    which owns 4 adjacent rows of the tile (a 32 x 4 block), tests 32
//    listed faces at a time against its block's corners, one a lane, and
//    runs the pixel loop only for the faces that reach its block
//    (`__ballot_sync`, then `__ffs` over the votes). Faces of a 1280-face
//    object are a few pixels across, so most reach one or two of a tile's
//    eight blocks: each pixel evaluates a fraction of the tile's faces.
//  - Pixel loop: a lane owns one column of its warp's 4 rows; the running
//    min key and winning slot stay in registers, a*px of each edge is
//    shared by a lane's four pixels, and z and the key are computed only
//    inside the face. All lanes read the same row, a broadcast.
//  - Epilogue, per warp and without CTA barriers: a warp's 32 lanes are one
//    image row at a time, so face ids and z leave straight from registers
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
//    of its 0.6 G operations (counted densely, every pixel against every
//    filled slot): without attributes the bound is arithmetic, and the
//    block culling skips most of those operations.
// What sets its time on the card (PERF.md): the background stores of the
// empty tiles, and at crops the pixel loop of the few tiles where a warp's
// block meets dozens of faces; the binning launch adds little.
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
constexpr int kRowsPerWarp = kTile / kWarps;                // 4
static_assert(kRowsPerWarp == kPixPerThread, "a lane owns a block column");
// the binning: a CTA per 32-bit mask word (256 faces, one a thread) and per
// group of at most kBinTiles tiles, whose masks it holds in shared memory
constexpr int kBinThreads = 32 * kChunk;
constexpr int kBinTiles = 8192;
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
// at a corner of the pixel rectangle [x0, x1] x [y0, y1]. Correct rounding
// is monotone, so the rounded edge is monotone in px and in py and takes
// its maximum over the rectangle's pixels at a corner: an edge negative at
// all four is negative at every pixel of the rectangle.
__device__ __forceinline__ bool reaches_rect(float a, float b, float c,
                                             float x0, float x1, float y0,
                                             float y1) {
  const float ax0 = __fmul_rn(a, x0), ax1 = __fmul_rn(a, x1);
  return edge(ax0, b, c, y0) >= 0.f || edge(ax1, b, c, y0) >= 0.f ||
         edge(ax0, b, c, y1) >= 0.f || edge(ax1, b, c, y1) >= 0.f;
}

// whether a face's three edges (coefficient rows r0..r2) each reach the
// rectangle: otherwise the face covers no pixel of it
__device__ __forceinline__ bool face_reaches(const float4& r0,
                                             const float4& r1,
                                             const float4& r2, float x0,
                                             float x1, float y0, float y1) {
  return reaches_rect(r0.x, r0.y, r0.z, x0, x1, y0, y1) &&
         reaches_rect(r0.w, r1.x, r1.y, x0, x1, y0, y1) &&
         reaches_rect(r1.z, r1.w, r2.x, x0, x1, y0, y1);
}

// tiles [lo, hi] along one axis of `n` tiles that a box [vmin, vmax]
// overlaps within the +-0.5 pixel margin, the comparisons of
// `_select_tiles` (tile i starts at 32 i); lo > hi where it overlaps none.
// A float estimate is widened by one tile and each end tested exactly, so
// rounding and non-finite boxes (NaN overlaps nothing) are handled.
__device__ __forceinline__ void box_tiles(float vmin, float vmax, int n,
                                          int& lo, int& hi) {
  const float top = (float)n;
  const float flo = fminf(fmaxf(floorf((vmin - 31.5f) * (1.f / kTile)), -1.f),
                          top);
  const float fhi = fminf(fmaxf(floorf((vmax + 0.5f) * (1.f / kTile)), -1.f),
                          top);
  lo = max((int)flo - 1, 0);
  hi = min((int)fhi + 1, n - 1);
  while (lo <= hi && !(vmin <= (float)(lo * kTile) + (kTile - 0.5f) &&
                       vmax >= (float)(lo * kTile) - 0.5f))
    ++lo;
  while (hi >= lo && !(vmin <= (float)(hi * kTile) + (kTile - 0.5f) &&
                       vmax >= (float)(hi * kTile) - 0.5f))
    --hi;
}

__device__ __forceinline__ void wait_for_primary_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void allow_dependent_grid() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Chunk masks: bit c % 32 of word c / 32 of (sample, tile) is set where a
// usable face of chunk c (faces 8c .. 8c + 7) has a box overlapping the
// tile. masks is (n, words, tiles) u32: a CTA (sample, word, tile group)
// owns word `blockIdx.y` of its tiles and writes it whole.
__global__ void __launch_bounds__(kBinThreads)
bin_chunks_kernel(const float4* __restrict__ coeff,
                  const float4* __restrict__ bbox,
                  unsigned* __restrict__ masks, int faces, int height,
                  int width) {
  extern __shared__ unsigned smask[];             // min(tiles, kBinTiles)
  allow_dependent_grid();
  const int b = blockIdx.x, word = blockIdx.y;
  const int tiles_x = width / kTile, tiles_y = height / kTile;
  const int tiles = tiles_x * tiles_y;
  const int t0 = blockIdx.z * kBinTiles;
  const int nt = min(tiles - t0, kBinTiles);
  for (int i = threadIdx.x; i < nt; i += kBinThreads) smask[i] = 0u;
  __syncthreads();
  const int f = word * kBinThreads + threadIdx.x;
  if (f < faces) {
    const size_t row = (size_t)b * faces + f;
    const float4 bb = bbox[row];
    const float ok = reinterpret_cast<const float*>(coeff + row * 4 + 3)[2];
    int c0, c1, r0, r1;
    box_tiles(bb.x, bb.y, tiles_x, c0, c1);
    box_tiles(bb.z, bb.w, tiles_y, r0, r1);
    const unsigned bit = 1u << ((f / kChunk) & 31);
    if (ok > 0.f)
      for (int r = r0; r <= r1; ++r)
        for (int c = c0; c <= c1; ++c) {
          const int t = r * tiles_x + c - t0;
          if (t >= 0 && t < nt) atomicOr(smask + t, bit);
        }
  }
  __syncthreads();
  const int words = (faces / kChunk + 31) / 32;
  unsigned* out = masks + ((size_t)b * words + word) * tiles + t0;
  for (int i = threadIdx.x; i < nt; i += kBinThreads) out[i] = smask[i];
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
                       const unsigned* __restrict__ masks,
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

  // ---- this tile's chunks: the first k/8 set bits of its masks ----------
  const int tiles = tiles_x * (height / kTile);
  const int words = (faces / kChunk + 31) / 32;
  const unsigned* mask_t =
      masks + (size_t)b * words * tiles + (y0 / kTile) * tiles_x + x0 / kTile;
  const int k8 = k / kChunk;
  wait_for_primary_grid();         // the binning launch has written masks
  int total = 0;                   // set bits so far, block-uniform
  for (int base = 0; base < words && total < k8; base += kThreads) {
    const int w = base + tid;
    const unsigned bits = w < words ? mask_t[(size_t)w * tiles] : 0u;
    const int cnt = __popc(bits);
    int incl = cnt;                               // inclusive warp scan
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_count[warp] = incl;
    __syncthreads();
    int rank = total + incl - cnt;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      const int c = warp_count[q];
      if (q < warp) rank += c;
      total += c;
    }
    for (unsigned m = bits; m && rank < k8; m &= m - 1u)
      chosen[rank++] = w * 32 + __ffs(m) - 1;
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
    live = r3.z > 0.f &&
           face_reaches(r0, r1, r2, (float)x0, (float)(x0 + kTile - 1),
                        (float)y0, (float)(y0 + kTile - 1));
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
  // warp w owns the block of rows y0 + 4w .. y0 + 4w + 3, lane the column
  // x0 + lane; it tests 32 listed faces at a time against the block's
  // corners (one a lane) and runs the pixels only for the faces that reach
  const int yb = y0 + warp * kRowsPerWarp;
  const float px = (float)(x0 + lane);
  const float bx0 = (float)x0, bx1 = (float)(x0 + kTile - 1);
  const float by0 = (float)yb, by1 = (float)(yb + kRowsPerWarp - 1);
  float py[kPixPerThread];
  int best[kPixPerThread], slot[kPixPerThread];
#pragma unroll
  for (int j = 0; j < kPixPerThread; ++j) {
    py[j] = (float)(yb + j);
    best[j] = kBigKey;
    slot[j] = -1;
  }
  for (int g = 0; g < n_live; g += 32) {
    int mine = -1;
    bool hit = false;
    if (g + lane < n_live) {
      mine = live_slot[g + lane];
      hit = face_reaches(rows[mine * 4 + 0], rows[mine * 4 + 1],
                         rows[mine * 4 + 2], bx0, bx1, by0, by1);
    }
    for (unsigned m = __ballot_sync(0xffffffffu, hit); m; m &= m - 1u) {
      const int f = __shfl_sync(0xffffffffu, mine, __ffs(m) - 1);
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
  }

  // ---- epilogue: each warp writes its own four image rows -----------------
  // face id and z go out straight from registers (a warp's 32 lanes are 128
  // contiguous bytes of a row); a pixel's attributes are staged so that the
  // row's 32 * d_attr floats leave as contiguous 16-byte stores
  float* a_row = a_s + warp * kTile * d_attr;
#pragma unroll
  for (int j = 0; j < kPixPerThread; ++j) {
    const size_t pix = ((size_t)b * height + yb + j) * width + x0;
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
// (n, H, W) i32, zbuf (n, H, W) f32, attrs (n, H, W, d_attr) f32; masks:
// n * ceil(faces / 256) * (H / 32) * (W / 32) u32 of scratch. With d_attr
// 0, attr and attrs are not touched (null is fine). Two launches on
// `stream`, the binning and the raster pass (a programmatic dependent
// launch); returns the first failing launch's cudaError_t.
extern "C" int scflow_rasterize_tiles(const void* coeff, const void* bbox,
                                      const void* attr, void* face_id,
                                      void* zbuf, void* attrs, void* masks,
                                      int n, int faces, int k, int height,
                                      int width, int d_attr, void* stream) {
  if (k <= 0 || k > kMaxFaces || k % kChunk || faces <= 0 ||
      faces % kChunk || faces >= (1 << kIdBits) || height % kTile ||
      width % kTile || (height / kTile) * (width / kTile) > 65535 ||
      d_attr < 0 || d_attr > kAttrPad || masks == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (height / kTile) * (width / kTile);
  const int words = (faces / kChunk + 31) / 32;
  const int groups = (tiles + kBinTiles - 1) / kBinTiles;
  const int bin_tiles = tiles < kBinTiles ? tiles : kBinTiles;
  bin_chunks_kernel<<<dim3(n, words, groups), kBinThreads,
                      bin_tiles * sizeof(unsigned), s>>>(
      (const float4*)coeff, (const float4*)bbox, (unsigned*)masks, faces,
      height, width);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // Phong, the main path's shading, interpolates 9 channels; depth-only and
  // mask-only renders none
  void (*kernel)(const float4*, const unsigned*, const float*, int*, float*,
                 float*, int, int, int, int, int) =
      d_attr == 9   ? &rasterize_tiles_kernel<9>
      : d_attr == 0 ? &rasterize_tiles_kernel<0>
                    : &rasterize_tiles_kernel<-1>;
  // above 48 KB only after this; the attribute belongs to the current
  // device, so it is set on every launch
  const int smem = smem_bytes(k, d_attr);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr_pdl[1];
  attr_pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr_pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr_pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const float4*)coeff,
                           (const unsigned*)masks, (const float*)attr,
                           (int*)face_id, (float*)zbuf, (float*)attrs, faces,
                           k, height, width, d_attr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
