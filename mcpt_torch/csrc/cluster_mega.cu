// The cluster megakernel for Hopper: whole path lifetimes through the 8-wide
// cluster walk, one thread per lane (engine=cluster-mega).
//
// Replaces mcpt/pallas/cluster_megakernel.py _render_cluster_jit (:360,
// pallas_call at :418; body _make_cluster_kernel :294 = megakernel
// _render_body + _make_cluster_intersectors :106).
//
// Reuse, not a copy: each thread runs render_lane<ClusterIsect>
// (render_body.cuh, the dense megakernel's lane body) with the walk of
// cluster_walk.cuh (the hybrid fused bounce's).  Lane l renders pixel
// pix[l % n_pixels], the tile permutation (mcpt's pixel_override), with the
// dense RNG counter (sample_base + sample) * W*H + pixel, so this kernel, the
// dense megakernel and the hybrid draw the same streams.
//
// Tables.  matt, lit and sf are staged in shared memory when they fit a
// block (they always do for the repo's scenes); wnodes and tri16 (9-12 MB
// for the large configs) stay in global memory, read through __ldg, and sit
// in the 50 MB L2.  Each thread keeps its own 128-entry stack in local
// memory; an overflow sets *err and the wrapper raises.
//
// Hit rule: the closest hit keeps the lowest (t, tri16 row), and a child is
// pruned only when its t-near exceeds the bound, so the result does not
// depend on the visit order (cluster_walk.cuh).
//
// Bound (from the design, not measured): latency of dependent L2 reads
// along divergent walks.  Unlike the hybrid, nothing re-sorts the rays
// between bounces: after the first bounce a warp's 32 rays walk unrelated
// nodes, and in regen a warp's lanes are at different depths of different
// samples.  The H100 A/B against the hybrid (chip_smoke.py --engine-ab)
// measures what that costs.

#include <cuda_runtime.h>

#include <cstdint>

#include "bounce_core.cuh"
#include "cluster_walk.cuh"
#include "render_body.cuh"

namespace mcpt {

__global__ void __launch_bounds__(kBlock)
    render_cluster_kernel(Params p, const float* __restrict__ sf_g,
                          const float* __restrict__ wnodes,
                          const float* __restrict__ tri16, int n_wide,
                          int leaf_size, const float* __restrict__ matt_g,
                          const float* __restrict__ lit_g,
                          const int* __restrict__ pix, float* __restrict__ r,
                          float* __restrict__ g, float* __restrict__ b,
                          float* __restrict__ segs_out, int* err) {
  extern __shared__ float smem[];
  __shared__ float sf[19];
  const float* matt = matt_g;
  const float* lit = lit_g;
  if (threadIdx.x < 19) sf[threadIdx.x] = sf_g[threadIdx.x];
  if (p.smem_tables) {
    // stage the shading tables block-wide before any thread exits
    float* s_matt = smem;
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

  ClusterIsect isect{wnodes, tri16, n_wide, leaf_size, err};
  render_lane(p, sf, isect, make_shading(p, sf, matt, lit), lane,
              pix[lane % p.n_pixels], r, g, b, segs_out);
}

}  // namespace mcpt

extern "C" {

// Launch on `stream`.  si: host int32[14] (the dense megakernel's; n_tris and
// pixel_base unused); sf: device float[19]; wnodes (n_wide, 64) and tri16
// (16-byte aligned), matt, lit, pix (n_pixels int32), the four (n_lanes)
// outputs and err (1 int, zeroed by the caller): device pointers.  Returns
// the cudaError_t of the launch (0 on success).
int mcpt_render_cluster(const int* si, const float* sf, const float* wnodes,
                        const float* tri16, int n_wide, int leaf_size,
                        const float* matt, const float* lit, int n_mat_rows,
                        int n_lit_rows, int use_nee, int use_mis, int regen,
                        const int* pix, int n_lanes, float* r, float* g,
                        float* b, float* segs, int* err, void* stream) {
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
  p.n_rows = 0;
  p.n_mat_rows = n_mat_rows;
  p.n_lit_rows = n_lit_rows;
  p.n_chunks = 0;
  p.chunked = 0;
  p.use_nee = use_nee;
  p.use_mis = use_mis;
  p.regen = regen;
  p.n_lanes = n_lanes;
  if (n_lanes <= 0) return 0;

  size_t smem = mcpt::table_smem_bytes(0, n_mat_rows, n_lit_rows, 0);
  p.smem_tables = smem > 0;
  cudaError_t e = cudaFuncSetAttribute(
      mcpt::render_cluster_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (n_lanes + mcpt::kBlock - 1) / mcpt::kBlock;
  mcpt::render_cluster_kernel<<<blocks, mcpt::kBlock, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      p, sf, wnodes, tri16, n_wide, leaf_size, matt, lit, pix, r, g, b, segs,
      err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
