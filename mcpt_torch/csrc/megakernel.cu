// The dense megakernel for Hopper: whole path lifetimes, one thread per lane.
//
// Replaces mcpt/pallas/megakernel.py _render_mega_jit (pallas_call at :1168;
// body _make_render_kernel :140 -> _render_body :721,
// _make_tri_intersectors :175, _make_bounce_core :410).
//
// Design.  The TPU kernel runs 64x128-lane blocks in lockstep, keeps every
// dead lane iterating until the block retires, and reads the triangle table
// as VMEM scalars.  Here each thread owns one lane and stops at its own
// death (a dead lane's update is a no-op, see megakernel.py), the block
// stages the triangle, material, light and chunk-box tables in shared memory
// (64 B a row: cbox 3 KB, veach_mis 42 KB, the 1600-tri furnace 126 KB through
// the opt-in above 48 KB), and the chunk cull is a per-thread branch instead
// of the TPU's block-wide any().  Tables past the 227 KB a block may hold are
// read from global memory (through L1/L2) instead.
//
// Bound.  The work is branchy scalar float code: per segment ~20 flops and
// one 48-byte row read for each triangle tested, all from shared memory, so
// the kernel is bound by issue rate and divergence, not by device memory
// (its only global traffic is 16 B of output per lane).
//
// Schedules (render_body.cuh, shared with the cluster megakernel).  regen:
// one thread per pixel, a finished path starts the pixel's next sample in
// place, capped at spp * max_depth iterations as on the TPU.  batch: one
// thread per (sample, pixel).  Outputs are per-lane r, g, b and live-segment
// counts; the wrapper reduces them.

#include <cuda_runtime.h>

#include <cstdint>

#include "bounce_core.cuh"
#include "render_body.cuh"

namespace mcpt {

constexpr int kChunk = 16;  // rows per chunk (CHUNK_TRIS)

// Dense triangle-table intersectors: every row in order (<= 128 tris) or
// 16-row Morton chunks behind a per-thread slab test of the chunk box.
// Ties keep the first row (strict <), as on the TPU.
struct DenseIsect {
  const float* tri;   // (n_rows, 16)
  const float* cbox;  // (n_chunks, 8)
  int n_tris, n_chunks;
  bool chunked;

  __device__ __forceinline__ static float safe_inv(float x) {
    const float tiny = MCPT_F(1e-30);
    return 1.0f / (fabsf(x) < tiny ? (x < 0.0f ? -tiny : tiny) : x);
  }

  // slab test of chunk c's box, pruned to (0, t_far)
  __device__ __forceinline__ bool box_hit(int c, const float* o,
                                          const float* inv, float t_far) const {
    const float* b = cbox + 8 * c;
    float t0x = (b[0] - o[0]) * inv[0], t1x = (b[3] - o[0]) * inv[0];
    float t0y = (b[1] - o[1]) * inv[1], t1y = (b[4] - o[1]) * inv[1];
    float t0z = (b[2] - o[2]) * inv[2], t1z = (b[5] - o[2]) * inv[2];
    float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    return tf >= fmaxf(tn, 0.0f) && tn < t_far;
  }

  __device__ __forceinline__ void test(int t, const float* o, const float* d,
                                       float t_min, float& best_t,
                                       int& best_i) const {
    float th, u, v;
    wald(tri + 16 * t, o, d, th, u, v);
    if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && th > t_min &&
        th < best_t) {
      best_t = th;
      best_i = t;
    }
  }

  __device__ __forceinline__ const float* closest(const float* o,
                                                  const float* d, float t_min,
                                                  float& best_t) const {
    best_t = kMiss;
    int best_i = 0;
    if (!chunked) {
      for (int t = 0; t < n_tris; ++t) test(t, o, d, t_min, best_t, best_i);
    } else {
      float inv[3] = {safe_inv(d[0]), safe_inv(d[1]), safe_inv(d[2])};
      for (int c = 0; c < n_chunks; ++c) {
        if (!box_hit(c, o, inv, best_t)) continue;
        for (int j = 0; j < kChunk; ++j)
          test(c * kChunk + j, o, d, t_min, best_t, best_i);
      }
    }
    return tri + 16 * best_i;
  }

  __device__ __forceinline__ bool occluded(const float* o, const float* d,
                                           float t_min, float limit) const {
    auto blocks = [&](int t) {
      float th, u, v;
      wald(tri + 16 * t, o, d, th, u, v);
      return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && th > t_min &&
             th < limit;
    };
    if (!chunked) {
      for (int t = 0; t < n_tris; ++t)
        if (blocks(t)) return true;
      return false;
    }
    float inv[3] = {safe_inv(d[0]), safe_inv(d[1]), safe_inv(d[2])};
    for (int c = 0; c < n_chunks; ++c) {
      if (!box_hit(c, o, inv, limit)) continue;
      for (int j = 0; j < kChunk; ++j)
        if (blocks(c * kChunk + j)) return true;
    }
    return false;
  }
};

__global__ void __launch_bounds__(kBlock)
    render_mega_kernel(Params p, const float* __restrict__ sf_g,
                       const float* __restrict__ tri_g,
                       const float* __restrict__ matt_g,
                       const float* __restrict__ lit_g,
                       const float* __restrict__ cbox_g, float* __restrict__ r,
                       float* __restrict__ g, float* __restrict__ b,
                       float* __restrict__ segs_out) {
  extern __shared__ float smem[];
  __shared__ float sf[19];
  const float* tri = tri_g;
  const float* matt = matt_g;
  const float* lit = lit_g;
  const float* cbox = cbox_g;
  if (threadIdx.x < 19) sf[threadIdx.x] = sf_g[threadIdx.x];
  if (p.smem_tables) {
    // stage the tables block-wide; every thread takes part before any exits
    float* s_tri = smem;
    float* s_matt = s_tri + 16 * p.n_rows;
    float* s_lit = s_matt + 16 * p.n_mat_rows;
    float* s_cbox = s_lit + 16 * p.n_lit_rows;
    for (int i = threadIdx.x; i < 16 * p.n_rows; i += blockDim.x)
      s_tri[i] = tri_g[i];
    for (int i = threadIdx.x; i < 16 * p.n_mat_rows; i += blockDim.x)
      s_matt[i] = matt_g[i];
    for (int i = threadIdx.x; i < 16 * p.n_lit_rows; i += blockDim.x)
      s_lit[i] = lit_g[i];
    for (int i = threadIdx.x; i < 8 * p.n_chunks; i += blockDim.x)
      s_cbox[i] = cbox_g[i];
    tri = s_tri;
    matt = s_matt;
    lit = s_lit;
    cbox = s_cbox;
  }
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.n_lanes) return;

  DenseIsect isect{tri, cbox, p.n_tris, p.n_chunks, p.chunked != 0};
  render_lane(p, sf, isect, make_shading(p, sf, matt, lit), lane,
              p.pixel_base + lane % p.n_pixels, r, g, b, segs_out);
}

}  // namespace mcpt

extern "C" {

// Launch on `stream`.  si: host int32[14] (width, height, n_tris, max_depth,
// seed, rr, rr_start, n_pixels, n_mats, n_lights, pixel_base, W*H, spp,
// sample_base); sf: device float[19]; tables and outputs: device pointers.
// Returns the cudaError_t of the launch (0 on success).
int mcpt_render_mega(const int* si, const float* sf, const float* tri,
                     const float* matt, const float* lit, const float* cbox,
                     int n_rows, int n_mat_rows, int n_lit_rows, int n_chunks,
                     int chunked, int use_nee, int use_mis, int regen,
                     int n_lanes, float* r, float* g, float* b, float* segs,
                     void* stream) {
  mcpt::Params p;
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
  p.chunked = chunked;
  p.use_nee = use_nee;
  p.use_mis = use_mis;
  p.regen = regen;
  p.n_lanes = n_lanes;
  if (n_lanes <= 0) return 0;

  size_t smem =
      mcpt::table_smem_bytes(n_rows, n_mat_rows, n_lit_rows, n_chunks);
  p.smem_tables = smem > 0;
  cudaError_t err = cudaFuncSetAttribute(
      mcpt::render_mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = (n_lanes + mcpt::kBlock - 1) / mcpt::kBlock;
  mcpt::render_mega_kernel<<<blocks, mcpt::kBlock, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      p, sf, tri, matt, lit, cbox, r, g, b, segs);
  return static_cast<int>(cudaGetLastError());
}

// 1 when the tables of a scene fit a block's shared memory.
int mcpt_tables_in_smem(int n_rows, int n_mat_rows, int n_lit_rows,
                        int n_chunks) {
  return mcpt::table_smem_bytes(n_rows, n_mat_rows, n_lit_rows, n_chunks) > 0;
}

const char* mcpt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
