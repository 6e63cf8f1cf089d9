// The hybrid engine's fused bounce for Hopper: one bounce of every live ray
// of the flat pool, one thread per ray.
//
// Replaces mcpt/pallas/cluster_megakernel.py _fused_bounce_jit (:563,
// pallas_call at :586; body _make_bounce_kernel :481 with
// _make_cluster_intersectors.walk :106 and megakernel._make_bounce_core).
//
// Per ray: the closest-hit walk of the 8-wide cluster tree (cluster_walk.cuh),
// the material resolve, emission with the MIS discount, BSDF sampling, the
// NEE any-hit walk and Russian roulette -- bounce_core.cuh's bounce<Isect>,
// the estimator the dense megakernel runs too.  A ray with alive == 0 exits
// at once with its planes untouched and 0 segments: the TPU kernel's
// all-dead-block pass-through, done per lane.
//
// State: 16 float32 planes of n lanes each, plane-major (origin xyz,
// direction xyz, throughput rgb, radiance rgb, alive, inside, prev_sc,
// prev_pdf), read and written coalesced.  The kernel updates the planes IN
// PLACE: each thread reads and writes only its own lane.  rid holds each
// lane's RNG stream id; segs receives the segments each lane traced.
//
// What the card showed (NVIDIA H100 80GB HBM3, 700 W; PERF.md): at config
// 8's 3,686,400-ray pool the kernel took 2.0 ms at depth 0 and 5.0 ms at
// depth 1 against bounds of 0.19 ms, waiting on the walk's dependent loads
// (the coherence sort between bounces, cluster_megakernel.py, keeps a
// warp's rays on the same nodes), with 96 registers and 5 blocks an SM.
// This design, each part measured against the others (chip_smoke.py
// --kernel-ab; PERF.md §6):
//   - the walk of cluster_walk.cuh: live rows only, while-while, the stack
//     in shared memory;
//   - __launch_bounds__(kBounceBlock, 8): 64 registers, 8 blocks (32 warps)
//     an SM; 6 and 7 blocks were slower, 10 no faster;
//   - persistent threads: the grid is the blocks resident on the card, and
//     a thread takes its next ray of the sorted pool from a global counter
//     (fetch_next; the wrapper zeroes one for each launch) as soon as it
//     is done with one.  Against one thread a ray it was 5-6% faster on the
//     re-sorted depth-1 pool and ~5% slower on the primary one; seven of a
//     step's eight bounces run re-sorted pools.

#include <cuda_runtime.h>

#include <cstdint>

#include "bounce_core.cuh"
#include "cluster_walk.cuh"

namespace mcpt {

constexpr int kBounceBlock = 128;    // threads per block
constexpr int kBounceMinBlocks = 8;  // resident blocks an SM (64 registers)

__global__ void __launch_bounds__(kBounceBlock, kBounceMinBlocks)
    fused_bounce_kernel(const float* __restrict__ wnodes,
                        const float* __restrict__ tri16,
                        const int* __restrict__ live,
                        const float* __restrict__ matt,
                        const float* __restrict__ lit, int n_wide,
                        int leaf_size, int cap, int n_lights, float eps,
                        float t_min, float area_l, float clamp, uint32_t seed,
                        int depth, int max_depth, int rr, int rr_start,
                        int use_nee, int use_mis, float* __restrict__ state,
                        const int* __restrict__ rid, float* __restrict__ segs,
                        int n, int* __restrict__ flag,
                        int* __restrict__ next) {
  extern __shared__ StackEntry stack_smem[];
  const ClusterIsect isect{wnodes, tri16, live, n_wide, leaf_size,
                           stack_smem + threadIdx.x,
                           static_cast<int>(blockDim.x), cap, flag};
  Shading sh;
  sh.matt = matt;
  sh.lit = lit;
  sh.n_lights = n_lights;
  sh.use_nee = use_nee != 0;
  sh.use_mis = use_mis != 0;
  sh.seed = seed;
  sh.eps = eps;
  sh.t_min = t_min;
  sh.area_l = area_l;
  sh.clampv = clamp > 0.0f ? clamp : kMiss;
  const float depth_ok = depth + 1 < max_depth ? 1.0f : 0.0f;
  const float rr_on = (rr && depth >= rr_start) ? 1.0f : 0.0f;
  const size_t stride = static_cast<size_t>(n);

  for (int lane = fetch_next(next); lane < n; lane = fetch_next(next)) {
    float* p = state + lane;
    const float alive = p[12 * stride];
    if (!(alive > 0.0f)) {  // dead: pass through
      segs[lane] = 0.0f;
      continue;
    }
    PathState s;
    for (int j = 0; j < 3; ++j) {
      s.o[j] = p[j * stride];
      s.d[j] = p[(3 + j) * stride];
      s.t[j] = p[(6 + j) * stride];
      s.rad[j] = p[(9 + j) * stride];
    }
    s.alive = alive;
    s.inside = p[13 * stride];
    s.prev_sc = p[14 * stride];
    s.prev_pdf = p[15 * stride];
    s.segs = 0.0f;

    bounce(s, isect, sh, 8u * static_cast<uint32_t>(depth) + 3u,
           static_cast<uint32_t>(rid[lane]), depth_ok, rr_on);

    for (int j = 0; j < 3; ++j) {
      p[j * stride] = s.o[j];
      p[(3 + j) * stride] = s.d[j];
      p[(6 + j) * stride] = s.t[j];
      p[(9 + j) * stride] = s.rad[j];
    }
    p[12 * stride] = s.alive;
    p[13 * stride] = s.inside;
    p[14 * stride] = s.prev_sc;
    p[15 * stride] = s.prev_pdf;
    segs[lane] = s.segs;
  }
}

inline size_t bounce_smem_bytes(int cap) {
  return sizeof(StackEntry) * static_cast<size_t>(cap) * kBounceBlock;
}

}  // namespace mcpt

extern "C" {

// Resident blocks an SM of fused_bounce_kernel at kBounceBlock threads and
// a stack of `cap` entries a thread (0 if it cannot run).
int mcpt_fused_bounce_blocks_per_sm(int cap) {
  const size_t smem = mcpt::bounce_smem_bytes(cap);
  if (cudaFuncSetAttribute(mcpt::fused_bounce_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, mcpt::fused_bounce_kernel, mcpt::kBounceBlock, smem) !=
      cudaSuccess)
    return 0;
  return blocks;
}

// One bounce over n lanes on `stream`.  Tables, state (16 x n floats), rid
// (n ints), segs (n floats), flag (1 int, set to 1 on a stack overflow and
// never cleared, so launches may share one) and next (1 int, the lane
// counter, zeroed by the caller for each launch) are device pointers; wnodes
// and tri16 must be 16-byte aligned; cap: stack entries a thread.  The grid
// is the blocks resident on the card.  Returns the cudaError_t of the launch
// (0 on success).
int mcpt_fused_bounce(const float* wnodes, const float* tri16,
                      const int* live, const float* matt, const float* lit,
                      int n_wide, int leaf_size, int cap, int n_lights,
                      float eps, float t_min, float area_l, float clamp,
                      unsigned int seed, int depth, int max_depth, int rr,
                      int rr_start, int use_nee, int use_mis, float* state,
                      const int* rid, float* segs, int n, int* flag,
                      int* next, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = mcpt::bounce_smem_bytes(cap);
  cudaError_t e = cudaFuncSetAttribute(
      mcpt::fused_bounce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0, device = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mcpt::fused_bounce_kernel, mcpt::kBounceBlock, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int needed = (n + mcpt::kBounceBlock - 1) / mcpt::kBounceBlock;
  const int blocks = per_sm * sms < needed ? per_sm * sms : needed;
  mcpt::fused_bounce_kernel<<<blocks, mcpt::kBounceBlock, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      wnodes, tri16, live, matt, lit, n_wide, leaf_size, cap, n_lights, eps,
      t_min, area_l, clamp, seed, depth, max_depth, rr, rr_start, use_nee,
      use_mis, state, rid, segs, n, flag, next);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
