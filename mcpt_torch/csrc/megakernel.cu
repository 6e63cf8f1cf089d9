// The dense megakernel for Hopper: whole path lifetimes, one thread per lane.
//
// Replaces mcpt/pallas/megakernel.py _render_mega_jit (pallas_call at :1168;
// body _make_render_kernel :140 -> _render_body :721,
// _make_tri_intersectors :175, _make_bounce_core :410).
//
// Per lane: render_lane (render_body.cuh) runs whole paths of the lane's
// pixel through bounce<DenseIsect> (bounce_core.cuh), under the regen
// schedule (one thread per pixel, a finished path starts the pixel's next
// sample in place, capped at spp * max_depth iterations as on the TPU) or
// batch (one thread per (sample, pixel)).  Outputs are per-lane r, g, b and
// live-segment counts in pixel order; the wrapper reduces them.
//
// Bound.  Every segment Wald-tests every row (<= 128 triangles) or each row
// of every chunk whose box it enters: 33 multiplies and adds and a division
// a row, all lanes of a warp on the same row.  Operations bound it: config
// 0's 16-spp step tests 1.02 G rows, 0.61 ms at the FP32 peak and 1.22 ms
// at the rate left without FMAs (-fmad=false keeps the plain version's
// bits).  Its only global traffic is 16 B of output a lane.
//
// What the card showed (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): the
// first port took 6.4 ms at that step and 61 ms at config 6's, this design
// 5.0 and 45 ms (device time, chip_smoke.py --kernel-ab).  The port read its
// rows as twelve scalar loads through one pointer that could be shared or
// global memory, and every launch carried both tiers' code.  This design,
// each part timed against the others (chip_smoke.py --define-ab, variants
// with compile-time switches since removed, and --kernel-ab):
//   - a template on the tier and on the table home: a launch carries its own
//     tier only, and the shared home reads a row as three float4 loads of a
//     shared array (12 floats a row: the winning row's normal and material
//     are read once, from global memory);
//   - the row loops unrolled by 4, so neighbouring rows overlap their loads
//     and divisions (-8% at config 0; by 2, by 8 or as the compiler chose
//     the kernel was 3-18% slower);
//   - lanes in 8x4 warp tiles, so a warp's rays start close together (-4%
//     at config 0, -9% at the furnace's step);
//   - __launch_bounds__(128, 5): 96 registers without spills, 20 warps an
//     SM.  Held to 64-80 registers for 24-32 warps it spilled 100-430 B and
//     was up to 9% slower; 4 blocks were 4-6% slower, 256-thread blocks up
//     to 16%.
// Tried and dropped, every one bit-equal too: the rows in the constant bank
// (+6% at config 0, +30% at config 6, whose 22 KB table overflows the
// constant cache); an early reject that tests the distance before u and v
// (+3% to +46%), or the sign of the quotient before the division (+26% to
// +74%): the branches cost more than the arithmetic they skip; persistent
// warps with whole-warp refill (-1% to +2%); a warp vote over the chunk
// boxes (+5% at config 6).
//
// Tables: a block stages the rows, the chunk boxes and the material and
// light tables in shared memory when they fit (cbox 4 KB, veach_mis 38 KB,
// the 1600-tri furnace 98 KB through the opt-in above 48 KB; read from
// global memory instead, they were 17-89% slower, even where that let 5
// blocks fit an SM in place of 2); past the 227 KB a block may hold, every
// table is read from global memory.

#include <cuda_runtime.h>

#include <cstdint>

#include "bounce_core.cuh"
#include "render_body.cuh"

namespace mcpt {

constexpr int kChunk = 16;  // rows per chunk (CHUNK_TRIS)
constexpr int kMegaBlock = 128;
constexpr int kMegaMinBlocks = 5;  // resident blocks an SM (~96 registers)

// Where a launch reads its triangle rows and chunk boxes (the wrapper's
// megakernel.table_home decides): a block-wide copy in shared memory, or
// global memory through the read-only path.
enum Home : int { kShared = 0, kGlobal = 1 };

// The launch's lanes, per sample, over the 8x4 tiles (a warp each) of the
// image rows that hold its pixels, tile rows first, row-major in a tile.
struct Tiles {
  int tiles_x;  // tiles across the image
  int tile_y0;  // the first tile row
  int lanes;    // lanes a sample: 32 a tile
};

// Dynamic shared memory of the shared home: 12-float rows, 8-float chunk
// boxes, then the 16-float material and light rows.
extern __shared__ float4 mk_smem[];

constexpr int kMaxSmemTables = kMaxSmem - 19 * static_cast<int>(sizeof(float));

inline size_t mega_smem_bytes(int n_rows, int n_mat_rows, int n_lit_rows,
                              int n_chunks, int home) {
  if (home != kShared) return 0;
  return 48u * n_rows + 32u * n_chunks + 64u * (n_mat_rows + n_lit_rows);
}

// Dense triangle-table intersectors: every row in order (<= 128 tris) or
// 16-row Morton chunks behind a slab test of the chunk box.  Ties keep the
// first row (strict <), as on the TPU.
template <bool kChunked, int kHome>
struct DenseIsect {
  const float* tri;   // (n_rows, 16) in global memory
  const float* cbox;  // (n_chunks, 8) in global memory
  int n_tris, n_rows, n_chunks;

  // float4 q (0-2: the Wald transform) of row t
  __device__ __forceinline__ float4 row(int t, int q) const {
    if (kHome == kShared) return mk_smem[3 * t + q];
    return __ldg(reinterpret_cast<const float4*>(tri) + 4 * t + q);
  }

  // float4 q (0-1: lo xyz, hi xyz) of chunk c's box
  __device__ __forceinline__ float4 box(int c, int q) const {
    if (kHome == kShared) return mk_smem[3 * n_rows + 2 * c + q];
    return __ldg(reinterpret_cast<const float4*>(cbox) + 2 * c + q);
  }

  __device__ __forceinline__ static float safe_inv(float x) {
    const float tiny = MCPT_F(1e-30);
    return 1.0f / (fabsf(x) < tiny ? (x < 0.0f ? -tiny : tiny) : x);
  }

  // slab test of chunk c's box, pruned to (0, t_far)
  __device__ __forceinline__ bool box_hit(int c, const float* o,
                                          const float* inv, float t_far) const {
    const float4 b0 = box(c, 0), b1 = box(c, 1);
    float t0x = (b0.x - o[0]) * inv[0], t1x = (b0.w - o[0]) * inv[0];
    float t0y = (b0.y - o[1]) * inv[1], t1y = (b1.x - o[1]) * inv[1];
    float t0z = (b0.z - o[2]) * inv[2], t1z = (b1.y - o[2]) * inv[2];
    float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    return tf >= fmaxf(tn, 0.0f) && tn < t_far;
  }

  // row t's Wald test for a hit in (t_min, t_max) at distance th
  __device__ __forceinline__ bool hits(int t, const float* o, const float* d,
                                       float t_min, float t_max,
                                       float& th) const {
    const float4 r0 = row(t, 0), r1 = row(t, 1), r2 = row(t, 2);
    const float c[12] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y,
                         r1.z, r1.w, r2.x, r2.y, r2.z, r2.w};
    float u, v;
    wald(c, o, d, th, u, v);
    return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && th > t_min &&
           th < t_max;
  }

  __device__ __forceinline__ void test(int t, const float* o, const float* d,
                                       float t_min, float& best_t,
                                       int& best_i) const {
    float th;
    if (hits(t, o, d, t_min, best_t, th)) {
      best_t = th;
      best_i = t;
    }
  }

  __device__ __forceinline__ const float* closest(const float* o,
                                                  const float* d, float t_min,
                                                  float& best_t) const {
    best_t = kMiss;
    int best_i = 0;
    if (!kChunked) {
#pragma unroll 4
      for (int t = 0; t < n_tris; ++t) test(t, o, d, t_min, best_t, best_i);
    } else {
      const float inv[3] = {safe_inv(d[0]), safe_inv(d[1]), safe_inv(d[2])};
      for (int c = 0; c < n_chunks; ++c) {
        if (!box_hit(c, o, inv, best_t)) continue;
#pragma unroll 4
        for (int j = 0; j < kChunk; ++j)
          test(c * kChunk + j, o, d, t_min, best_t, best_i);
      }
    }
    return tri + 16 * best_i;
  }

  __device__ __forceinline__ bool occluded(const float* o, const float* d,
                                           float t_min, float limit) const {
    float th;
    if (!kChunked) {
#pragma unroll 4
      for (int t = 0; t < n_tris; ++t)
        if (hits(t, o, d, t_min, limit, th)) return true;
      return false;
    }
    const float inv[3] = {safe_inv(d[0]), safe_inv(d[1]), safe_inv(d[2])};
    for (int c = 0; c < n_chunks; ++c) {
      if (!box_hit(c, o, inv, limit)) continue;
#pragma unroll 4
      for (int j = 0; j < kChunk; ++j)
        if (hits(c * kChunk + j, o, d, t_min, limit, th)) return true;
    }
    return false;
  }
};

template <bool kChunked, int kHome>
__global__ void __launch_bounds__(kMegaBlock, kMegaMinBlocks)
    render_mega_kernel(Params p, const float* __restrict__ sf_g,
                       const float* __restrict__ tri_g,
                       const float* __restrict__ matt_g,
                       const float* __restrict__ lit_g,
                       const float* __restrict__ cbox_g, Tiles tl,
                       float* __restrict__ r, float* __restrict__ g,
                       float* __restrict__ b, float* __restrict__ segs_out) {
  __shared__ float sf[19];
  if (threadIdx.x < 19) sf[threadIdx.x] = sf_g[threadIdx.x];
  const float* matt = matt_g;
  const float* lit = lit_g;
  if (kHome == kShared) {
    // stage the tables block-wide; every thread takes part before any exits
    const float4* t4 = reinterpret_cast<const float4*>(tri_g);
    for (int i = threadIdx.x; i < 3 * p.n_rows; i += blockDim.x)
      mk_smem[i] = t4[4 * (i / 3) + i % 3];
    const float4* c4 = reinterpret_cast<const float4*>(cbox_g);
    for (int i = threadIdx.x; i < 2 * p.n_chunks; i += blockDim.x)
      mk_smem[3 * p.n_rows + i] = c4[i];
    float* s_matt =
        reinterpret_cast<float*>(mk_smem + 3 * p.n_rows + 2 * p.n_chunks);
    float* s_lit = s_matt + 16 * p.n_mat_rows;
    for (int i = threadIdx.x; i < 16 * p.n_mat_rows; i += blockDim.x)
      s_matt[i] = matt_g[i];
    for (int i = threadIdx.x; i < 16 * p.n_lit_rows; i += blockDim.x)
      s_lit[i] = lit_g[i];
    matt = s_matt;
    lit = s_lit;
  }
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.n_lanes) return;
  // lane -> (sample, tile, place in the tile) -> pixel pixel_base + k,
  // whose outputs go to its row-major slot; lanes of a tile's part outside
  // the image or the launch's pixels have no pixel
  const int sample = lane / tl.lanes, j = lane - sample * tl.lanes;
  const int t = j >> 5, x = (t % tl.tiles_x) * 8 + (j & 7);
  const int y = (tl.tile_y0 + t / tl.tiles_x) * 4 + ((j >> 3) & 3);
  const int k = y * p.width + x - p.pixel_base;
  if (x >= p.width || k < 0 || k >= p.n_pixels) return;

  const DenseIsect<kChunked, kHome> isect{tri_g, cbox_g, p.n_tris, p.n_rows,
                                          p.n_chunks};
  render_lane(p, sf, isect, make_shading(p, sf, matt, lit),
              sample * p.n_pixels + k, p.pixel_base + k, r, g, b, segs_out);
}

typedef void (*MegaKernel)(Params, const float*, const float*, const float*,
                           const float*, const float*, Tiles, float*, float*,
                           float*, float*);

inline MegaKernel mega_kernel(int chunked, int home) {
  if (chunked)
    return home == kShared ? render_mega_kernel<true, kShared>
                           : render_mega_kernel<true, kGlobal>;
  return home == kShared ? render_mega_kernel<false, kShared>
                         : render_mega_kernel<false, kGlobal>;
}

}  // namespace mcpt

extern "C" {

// Threads a block of every instantiation.
int mcpt_render_mega_block_threads() { return mcpt::kMegaBlock; }

// Resident blocks an SM of the launch a scene's tables get (0 if it cannot
// run).
int mcpt_render_mega_blocks_per_sm(int n_rows, int n_mat_rows, int n_lit_rows,
                                   int n_chunks, int chunked, int home) {
  const size_t smem = mcpt::mega_smem_bytes(n_rows, n_mat_rows, n_lit_rows,
                                            n_chunks, home);
  const mcpt::MegaKernel kern = mcpt::mega_kernel(chunked, home);
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kern, mcpt::kMegaBlock, smem) != cudaSuccess)
    return 0;
  return blocks;
}

// Launch on `stream`.  si: host int32[14] (width, height, n_tris, max_depth,
// seed, rr, rr_start, n_pixels, n_mats, n_lights, pixel_base, W*H, spp,
// sample_base); sf: device float[19]; tables (tri and cbox 16-byte aligned)
// and outputs (n_pixels a sample in batch, one in regen): device pointers;
// home: where the kernel reads the rows and boxes (0 shared memory, 1 global
// memory).  Returns the cudaError_t of the launch (0 on success).
int mcpt_render_mega(const int* si, const float* sf, const float* tri,
                     const float* matt, const float* lit, const float* cbox,
                     int n_rows, int n_mat_rows, int n_lit_rows, int n_chunks,
                     int chunked, int use_nee, int use_mis, int regen,
                     int home, float* r, float* g, float* b, float* segs,
                     void* stream) {
  mcpt::Params p{};
  p.width = si[0];
  p.height = si[1];
  p.n_tris = si[2];
  p.max_depth = si[3];
  p.seed = static_cast<uint32_t>(si[4]);
  p.rr = si[5];
  p.rr_start = si[6];
  p.n_pixels = si[7];
  p.n_mats = si[8];
  p.n_lights = si[9];
  p.pixel_base = si[10];
  p.total_pixels = si[11];
  p.spp = si[12];
  p.sample_base = si[13];
  p.n_rows = n_rows;
  p.n_mat_rows = n_mat_rows;
  p.n_lit_rows = n_lit_rows;
  p.n_chunks = n_chunks;
  p.use_nee = use_nee;
  p.use_mis = use_mis;
  p.regen = regen;  // smem_tables stays 0: kHome decides here
  if (p.n_pixels <= 0) return 0;
  if ((home != mcpt::kShared && home != mcpt::kGlobal) || p.width <= 0 ||
      p.pixel_base < 0 || p.pixel_base + p.n_pixels > p.width * p.height)
    return static_cast<int>(cudaErrorInvalidValue);
  mcpt::Tiles tl;
  tl.tiles_x = (p.width + 7) / 8;
  tl.tile_y0 = p.pixel_base / p.width / 4;
  const long long lanes =
      32LL * tl.tiles_x *
      ((p.pixel_base + p.n_pixels - 1) / p.width / 4 - tl.tile_y0 + 1);
  const long long n_lanes = regen ? lanes : lanes * p.spp;
  if (n_lanes > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tl.lanes = static_cast<int>(lanes);
  p.n_lanes = static_cast<int>(n_lanes);

  const size_t smem =
      mcpt::mega_smem_bytes(n_rows, n_mat_rows, n_lit_rows, n_chunks, home);
  if (smem > static_cast<size_t>(mcpt::kMaxSmemTables))
    return static_cast<int>(cudaErrorInvalidValue);
  const mcpt::MegaKernel kern = mcpt::mega_kernel(chunked, home);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (p.n_lanes + mcpt::kMegaBlock - 1) / mcpt::kMegaBlock;
  kern<<<blocks, mcpt::kMegaBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      p, sf, tri, matt, lit, cbox, tl, r, g, b, segs);
  return static_cast<int>(cudaGetLastError());
}

const char* mcpt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
