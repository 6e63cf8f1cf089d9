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
// Bound (from the design, not yet measured): latency of dependent L2 reads
// along divergent per-ray walks -- each pop is a 256-byte node read whose
// address depends on the previous pop, and the 32 rows of a cluster are
// 2 KB.  The coherence sort between bounces (cluster_megakernel.py) is what
// keeps a warp's rays on the same nodes.  Making it fast (wide-node tests by
// a warp, a treelet layout, a persistent ray queue) is later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "bounce_core.cuh"
#include "cluster_walk.cuh"

namespace mcpt {

constexpr int kBounceBlock = 128;  // threads per block

__global__ void __launch_bounds__(kBounceBlock)
    fused_bounce_kernel(const float* __restrict__ wnodes,
                        const float* __restrict__ tri16,
                        const float* __restrict__ matt,
                        const float* __restrict__ lit, int n_wide,
                        int leaf_size, int n_lights, float eps, float t_min,
                        float area_l, float clamp, uint32_t seed, int depth,
                        int max_depth, int rr, int rr_start, int use_nee,
                        int use_mis, float* __restrict__ state,
                        const int* __restrict__ rid, float* __restrict__ segs,
                        int n, int* __restrict__ err) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const size_t stride = static_cast<size_t>(n);
  float* p = state + lane;
  const float alive = p[12 * stride];
  if (!(alive > 0.0f)) {  // dead: pass through
    segs[lane] = 0.0f;
    return;
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

  ClusterIsect isect{wnodes, tri16, n_wide, leaf_size, err};
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

}  // namespace mcpt

extern "C" {

// One bounce over n lanes on `stream`.  Tables, state (16 x n floats), rid
// (n ints), segs (n floats) and err (1 int, zeroed by the caller) are device
// pointers; wnodes and tri16 must be 16-byte aligned.  Returns the
// cudaError_t of the launch (0 on success).
int mcpt_fused_bounce(const float* wnodes, const float* tri16,
                      const float* matt, const float* lit, int n_wide,
                      int leaf_size, int n_lights, float eps, float t_min,
                      float area_l, float clamp, unsigned int seed, int depth,
                      int max_depth, int rr, int rr_start, int use_nee,
                      int use_mis, float* state, const int* rid, float* segs,
                      int n, int* err, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + mcpt::kBounceBlock - 1) / mcpt::kBounceBlock;
  mcpt::fused_bounce_kernel<<<blocks, mcpt::kBounceBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      wnodes, tri16, matt, lit, n_wide, leaf_size, n_lights, eps, t_min,
      area_l, clamp, seed, depth, max_depth, rr, rr_start, use_nee, use_mis,
      state, rid, segs, n, err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
