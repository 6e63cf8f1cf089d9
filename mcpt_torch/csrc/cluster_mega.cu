// The cluster megakernel for Hopper: whole path lifetimes through the 8-wide
// cluster walk, one thread per lane at a time (engine=cluster-mega).
//
// Replaces mcpt/pallas/cluster_megakernel.py _render_cluster_jit (:360,
// pallas_call at :418; body _make_cluster_kernel :294 = megakernel
// _render_body + _make_cluster_intersectors :106).
//
// Reuse, not a copy: each lane runs render_lane<ClusterIsect>
// (render_body.cuh, the dense megakernel's lane body) with the walk of
// cluster_walk.cuh (the hybrid fused bounce's).  Lane l renders pixel
// pix[l % n_pixels], the tile permutation (mcpt's pixel_override), with the
// dense RNG counter (sample_base + sample) * W*H + pixel, so this kernel, the
// dense megakernel and the hybrid draw the same streams.
//
// What the card showed (NVIDIA H100 80GB HBM3, 700 W; PERF.md): at config
// 7's 4-spp regen step the kernel took 40 ms against a 1 ms bound, 82-86% of
// the engine's device time, waiting on the walk's loads; one thread rendered
// one pixel whole, so a warp ran until its slowest lane had finished all its
// samples; and at 96 registers only 5 blocks (20 warps) fitted an SM.  This
// design, each part measured against the others (chip_smoke.py
// --kernel-ab; PERF.md §6):
//   - the walk of cluster_walk.cuh: live rows only, while-while, the stack
//     in shared memory;
//   - occupancy: 256 threads a block and __launch_bounds__(256, 4) hold
//     the kernel to 64 registers, so 32 warps fit an SM; the spills this
//     costs (ptxas: chip_smoke.py phase 12) cost less than the latency the
//     extra warps hide (20, 24, 28 and 40 warps were slower; 64- and
//     128-thread blocks at 32 warps were 1-2% slower);
//   - persistent threads: the grid is as many blocks as are resident on the
//     card, and a warp whose lanes have all finished render_lane (a pixel's
//     spp samples in regen, one path in batch) takes its next 32 lanes
//     together from a global counter (fetch_next: a warp-aggregated
//     atomicAdd; the wrapper zeroes the counter with the error flag before
//     each launch), so its lanes stay neighbouring pixels in tile order.
//     Refilling each lane as it finished kept the warp busier but scattered
//     its rays, and was 4-6% slower than this;
//   - each lane is still rendered whole by one thread and written to its own
//     r/g/b/segs slot: no atomics on radiance, so the sums are the plain
//     version's bits and the same from run to run.
//
// Shared memory: matt, lit (when they fit beside the stacks; they always do
// for the repo's scenes) and each thread's stack column of cap entries.  An
// overflow sets *err and the wrapper raises.
//
// Hit rule: the closest hit keeps the lowest (t, tri16 row), and a child is
// pruned only when its t-near exceeds the bound (cluster_walk.cuh).

#include <cuda_runtime.h>

#include <cstdint>

#include "bounce_core.cuh"
#include "cluster_walk.cuh"
#include "render_body.cuh"

namespace mcpt {

constexpr int kClusterBlock = 256;    // threads per block
constexpr int kClusterMinBlocks = 4;  // resident blocks an SM (64 registers)

__global__ void __launch_bounds__(kClusterBlock, kClusterMinBlocks)
    render_cluster_kernel(Params p, const float* __restrict__ sf_g,
                          const float* __restrict__ wnodes,
                          const float* __restrict__ tri16,
                          const int* __restrict__ live, int n_wide,
                          int leaf_size, int cap,
                          const float* __restrict__ matt_g,
                          const float* __restrict__ lit_g,
                          const int* __restrict__ pix, float* __restrict__ r,
                          float* __restrict__ g, float* __restrict__ b,
                          float* __restrict__ segs_out, int* err) {
  extern __shared__ float smem[];
  __shared__ float sf[19];
  const float* matt = matt_g;
  const float* lit = lit_g;
  int table_floats = 0;
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
    table_floats = 16 * (p.n_mat_rows + p.n_lit_rows);
  }
  __syncthreads();  // the last barrier: threads leave the loop one by one

  StackEntry* stack =
      reinterpret_cast<StackEntry*>(smem + table_floats) + threadIdx.x;
  const ClusterIsect isect{wnodes, tri16, live, n_wide, leaf_size, stack,
                           static_cast<int>(blockDim.x), cap, err};
  const Shading sh = make_shading(p, sf, matt, lit);

  // the warp reconverges where render_lane returns, so it asks for its next
  // lanes together once all of them are done
  int* next = err + 1;
  for (int lane = fetch_next(next); lane < p.n_lanes; lane = fetch_next(next))
    render_lane(p, sf, isect, sh, lane, pix[lane % p.n_pixels], r, g, b,
                segs_out);
}

// Dynamic shared memory of a launch: the stacks, and the staged tables when
// they fit beside them (else 0 table floats: they stay in global memory).
inline size_t cluster_smem_bytes(int cap, int n_mat_rows, int n_lit_rows,
                                  bool* tables) {
  const size_t tb = sizeof(float) * 16u * (n_mat_rows + n_lit_rows);
  const size_t st =
      sizeof(StackEntry) * static_cast<size_t>(cap) * kClusterBlock;
  *tables = tb + st + 19 * sizeof(float) <= kMaxSmem;
  return (*tables ? tb : 0) + st;
}

}  // namespace mcpt

extern "C" {

// Resident blocks an SM of render_cluster_kernel at kClusterBlock threads
// and the launch's shared memory (0 if it cannot run).
int mcpt_render_cluster_blocks_per_sm(int cap, int n_mat_rows,
                                      int n_lit_rows) {
  bool tables;
  const size_t smem =
      mcpt::cluster_smem_bytes(cap, n_mat_rows, n_lit_rows, &tables);
  if (cudaFuncSetAttribute(mcpt::render_cluster_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, mcpt::render_cluster_kernel, mcpt::kClusterBlock, smem) !=
      cudaSuccess)
    return 0;
  return blocks;
}

// Launch on `stream`.  si: host int32[14] (the dense megakernel's; n_tris and
// pixel_base unused); sf: device float[19]; wnodes (n_wide, 64) and tri16
// (16-byte aligned), live, matt, lit, pix (n_pixels int32), the four
// (n_lanes) outputs and err (2 ints: the overflow flag and the lane
// counter, zeroed by the caller): device pointers; cap: stack entries a
// thread.  The grid is the blocks resident on the card.  Returns the
// cudaError_t of the launch (0 on success).
int mcpt_render_cluster(const int* si, const float* sf, const float* wnodes,
                        const float* tri16, const int* live, int n_wide,
                        int leaf_size, int cap, const float* matt,
                        const float* lit, int n_mat_rows, int n_lit_rows,
                        int use_nee, int use_mis, int regen, const int* pix,
                        int n_lanes, float* r, float* g, float* b,
                        float* segs, int* err, void* stream) {
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
  p.use_nee = use_nee;
  p.use_mis = use_mis;
  p.regen = regen;
  p.n_lanes = n_lanes;
  if (n_lanes <= 0) return 0;

  bool tables;
  const size_t smem =
      mcpt::cluster_smem_bytes(cap, n_mat_rows, n_lit_rows, &tables);
  p.smem_tables = tables;
  cudaError_t e = cudaFuncSetAttribute(
      mcpt::render_cluster_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0, device = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mcpt::render_cluster_kernel, mcpt::kClusterBlock, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int needed =
      (n_lanes + mcpt::kClusterBlock - 1) / mcpt::kClusterBlock;
  const int blocks = per_sm * sms < needed ? per_sm * sms : needed;
  mcpt::render_cluster_kernel<<<blocks, mcpt::kClusterBlock, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      p, sf, wnodes, tri16, live, n_wide, leaf_size, cap, matt, lit, pix, r,
      g, b, segs, err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
