// The wavefront engine's cluster-BVH traversal for Hopper: the closest hit
// or the any-hit of every active ray of a pool, one thread per ray.
//
// Replaces mcpt/pallas/traverse_kernel.py _traverse_jit (:303, pallas_call
// at :333; body _make_traverse_kernel :77; public intersect_clusters :394
// and occluded_clusters :423).
//
// The walk is ClusterIsect::walk (cluster_walk.cuh), the one the hybrid and
// the cluster megakernel run (live rows only, while-while, the stack in
// shared memory); nothing here walks a second way.  Its launch, one thread
// a ray at 128 threads a block, is not redesigned yet.  The TPU
// walks one stack per 32x128-ray block and retires the block once all its
// lanes are occluded (traverse_kernel.py:273-281); here each thread walks
// its own stack, and the any-hit walk of a ray ends at its first hit.  An
// inactive ray writes a miss and exits (the TPU poisons its origin instead).
//
// Per ray in: origin and direction as the pool's (R, 3) rows, active (one
// byte), limit.  Closest hit out: t (3e38 on a miss), row (int32, -1 on a
// miss) and the normal tri16[row, 12:15] (0 on a miss); any-hit out: a 0/1
// byte.  Hits are the lowest (t, tri16 row) in (t_min, limit).
//
// Bound: per ray 32 B read (origin, direction, active, limit) and 20 B
// written (t, row, normal), about 190 MB at config 8's 3,686,400-ray pool,
// 57 us at 3.35 TB/s; the work is ~23 flops per child box and ~40 per live
// triangle row tested.  What the card showed (NVIDIA H100 80GB HBM3, 700
// W; PERF.md): 0.6-2.8 ms at that pool, 5-20x its bound, waiting on the
// walk's dependent loads; the shared walk took 2-30% off.  The wavefront
// re-sorts its pool between bounces (RenderOptions.resort), which keeps a
// warp's rays on the same nodes.

#include <cuda_runtime.h>

#include <cstdint>

#include "bounce_core.cuh"
#include "cluster_walk.cuh"

namespace mcpt {

constexpr int kTraverseBlock = 128;  // threads per block

template <bool kAnyHit>
__global__ void __launch_bounds__(kTraverseBlock)
    traverse_kernel(const float* __restrict__ wnodes,
                    const float* __restrict__ tri16,
                    const int* __restrict__ live, int n_wide, int leaf_size,
                    int cap, const float* __restrict__ origin,
                    const float* __restrict__ direction,
                    const uint8_t* __restrict__ active,
                    const float* __restrict__ limit, float t_min,
                    float* __restrict__ t_out, int* __restrict__ row_out,
                    float* __restrict__ normal_out,
                    uint8_t* __restrict__ occ_out, int n, int* err) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n) return;
  if (!active[ray]) {
    if (kAnyHit) {
      occ_out[ray] = 0;
    } else {
      t_out[ray] = kMiss;
      row_out[ray] = -1;
      for (int j = 0; j < 3; ++j) normal_out[3 * ray + j] = 0.0f;
    }
    return;
  }
  const float o[3] = {origin[3 * ray], origin[3 * ray + 1],
                      origin[3 * ray + 2]};
  const float d[3] = {direction[3 * ray], direction[3 * ray + 1],
                      direction[3 * ray + 2]};
  extern __shared__ StackEntry stack_smem[];
  const ClusterIsect isect{wnodes, tri16, live, n_wide, leaf_size,
                           stack_smem + threadIdx.x,
                           static_cast<int>(blockDim.x), cap, err};
  if (kAnyHit) {
    occ_out[ray] = isect.occluded(o, d, t_min, limit[ray]) ? 1 : 0;
    return;
  }
  float best_t;
  const int row = isect.closest_row(o, d, t_min, limit[ray], best_t);
  t_out[ray] = row >= 0 ? best_t : kMiss;
  row_out[ray] = row;
  for (int j = 0; j < 3; ++j)
    normal_out[3 * ray + j] =
        row >= 0 ? __ldg(tri16 + 16 * static_cast<size_t>(row) + 12 + j)
                 : 0.0f;
}

inline size_t traverse_smem_bytes(int cap) {
  return sizeof(StackEntry) * static_cast<size_t>(cap) * kTraverseBlock;
}

template <bool kAnyHit>
int blocks_per_sm(int cap) {
  const size_t smem = traverse_smem_bytes(cap);
  if (cudaFuncSetAttribute(traverse_kernel<kAnyHit>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, traverse_kernel<kAnyHit>, kTraverseBlock, smem) !=
      cudaSuccess)
    return 0;
  return blocks;
}

}  // namespace mcpt

extern "C" {

// Resident blocks an SM of the closest-hit (any_hit 0) or any-hit kernel at
// kTraverseBlock threads and a stack of `cap` entries a thread.
int mcpt_traverse_blocks_per_sm(int any_hit, int cap) {
  return any_hit ? mcpt::blocks_per_sm<true>(cap)
                 : mcpt::blocks_per_sm<false>(cap);
}

// One traversal of n rays on `stream`.  any_hit selects the any-hit walk
// (occ_out written; t_out, row_out and normal_out may be null) or the
// closest hit (occ_out may be null).  Tables, rays and outputs are device
// pointers; wnodes and tri16 must be 16-byte aligned; cap: stack entries a
// thread; err (1 int, zeroed by the caller) is set on a stack overflow.
// Returns the cudaError_t of the launch (0 on success).
int mcpt_traverse(const float* wnodes, const float* tri16, const int* live,
                  int n_wide, int leaf_size, int cap, const float* origin,
                  const float* direction, const unsigned char* active,
                  const float* limit, float t_min, int any_hit, float* t_out,
                  int* row_out, float* normal_out, unsigned char* occ_out,
                  int n, int* err, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + mcpt::kTraverseBlock - 1) / mcpt::kTraverseBlock;
  const size_t smem = mcpt::traverse_smem_bytes(cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (any_hit) {
    e = cudaFuncSetAttribute(mcpt::traverse_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    mcpt::traverse_kernel<true><<<blocks, mcpt::kTraverseBlock, smem, s>>>(
        wnodes, tri16, live, n_wide, leaf_size, cap, origin, direction,
        active, limit, t_min, t_out, row_out, normal_out, occ_out, n, err);
  } else {
    e = cudaFuncSetAttribute(mcpt::traverse_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    mcpt::traverse_kernel<false><<<blocks, mcpt::kTraverseBlock, smem, s>>>(
        wnodes, tri16, live, n_wide, leaf_size, cap, origin, direction,
        active, limit, t_min, t_out, row_out, normal_out, occ_out, n, err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
