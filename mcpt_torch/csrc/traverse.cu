// The wavefront engine's cluster-BVH traversal for Hopper: the closest hit
// or the any-hit of every active ray of a pool, one thread per ray.
//
// Replaces mcpt/pallas/traverse_kernel.py _traverse_jit (:303, pallas_call
// at :333; body _make_traverse_kernel :77; public intersect_clusters :394
// and occluded_clusters :423).
//
// The walk is ClusterWalk::walk (cluster_walk.cuh), the one the hybrid and
// the cluster megakernel run (live rows only, while-while); nothing here
// walks a second way.  The TPU walks one stack per 32x128-ray block and
// retires the block once all its lanes are occluded
// (traverse_kernel.py:273-281); here each thread walks its own stack, and
// the any-hit walk of a ray ends at its first hit.  An inactive ray writes
// a miss and exits (the TPU poisons its origin instead).
//
// Per ray in: origin and direction as the pool's (R, 3) rows, active (one
// byte), limit (null for a closest hit without one).  Closest hit out:
// types.Hit's fields, so no torch op follows the launch: t (inf on a
// miss), tri = tri_map[row] (-1 on a miss), point = origin + direction * t
// (t read as 0 on a miss; a product and a sum, each rounded, as torch
// computes it) and the normal tri16[row, 12:15] (0 on a miss).  Any-hit
// out: a 0/1 byte, 0 for an inactive ray.  Hits are the lowest (t, tri16
// row) in (t_min, limit).
//
// Bound: per ray 32 B read (origin, direction, active, limit) and 32 B
// written (t, tri, point, normal) by a closest hit, ~240 MB at config 8's
// 3,686,400-ray pool, 0.07 ms at 3.35 TB/s; the work is ~23 flops per child
// box and ~40 per live triangle row tested, 0.06-0.11 ms at that pool.
// What the card showed (NVIDIA H100 80GB HBM3, 700 W; PERF.md): 0.5-1.8 ms
// at that pool, 6-16x its bound, waiting on the walk's dependent loads.
// Each part of this launch was timed alone against the one before it
// (chip_smoke.py --kernel-ab, PERF.md §6):
//   - 16 stack entries in shared memory and the rest in a thread-local
//     array: the whole stack in shared memory held the SM to 32 warps,
//     now registers set it (48-51: 36-40 warps); 2-6% faster, and 8 or
//     24 entries within 1% of 16;
//   - 64 threads a block: 1-2% faster than 128 (finer blocks at the pool's
//     tail), 256 was 4-6% slower;
//   - the Hit written here: the closest hit's call lost its 6-8 torch ops
//     (12-25% of the call's device time);
//   - tried and dropped: persistent warps taking 32-ray chunks from a
//     counter (-4% to +2%).
// The overflow flag may be shared by many launches (the wrapper reads it
// once a bounce loop): the kernel only ever sets it.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "bounce_core.cuh"
#include "cluster_walk.cuh"

namespace mcpt {

constexpr int kTraverseBlock = 64;  // threads per block
constexpr int kTraverseShared = 16;  // stack entries in shared memory
typedef ClusterWalk<kTraverseShared> TraverseWalk;

template <bool kAnyHit>
__global__ void __launch_bounds__(kTraverseBlock)
    traverse_kernel(const float* __restrict__ wnodes,
                    const float* __restrict__ tri16,
                    const int* __restrict__ live,
                    const int* __restrict__ tri_map, int n_wide,
                    int leaf_size, int cap, const float* __restrict__ origin,
                    const float* __restrict__ direction,
                    const uint8_t* __restrict__ active,
                    const float* __restrict__ limit, float t_min,
                    float* __restrict__ t_out, int* __restrict__ tri_out,
                    float* __restrict__ point_out,
                    float* __restrict__ normal_out,
                    uint8_t* __restrict__ occ_out, int n, int* err) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n) return;
  const bool act = active[ray];
  if (kAnyHit && !act) {
    occ_out[ray] = 0;
    return;
  }
  const float o[3] = {origin[3 * ray], origin[3 * ray + 1],
                      origin[3 * ray + 2]};
  const float d[3] = {direction[3 * ray], direction[3 * ray + 1],
                      direction[3 * ray + 2]};
  extern __shared__ StackEntry stack_smem[];
  StackEntry spill[kMaxStack - kTraverseShared];
  const TraverseWalk isect{wnodes, tri16, live, n_wide, leaf_size,
                           stack_smem + threadIdx.x,
                           static_cast<int>(blockDim.x), cap, err, spill};
  const float lim = limit != nullptr ? limit[ray] : kMiss;
  if (kAnyHit) {
    occ_out[ray] = isect.occluded(o, d, t_min, lim) ? 1 : 0;
    return;
  }
  float best_t = 0.0f;
  const int row = act ? isect.closest_row(o, d, t_min, lim, best_t) : -1;
  const bool hit = row >= 0;
  const float tv = hit ? best_t : 0.0f;
  t_out[ray] = hit ? best_t : CUDART_INF_F;
  tri_out[ray] = hit ? __ldg(tri_map + row) : -1;
  for (int j = 0; j < 3; ++j) {
    point_out[3 * ray + j] = __fadd_rn(o[j], __fmul_rn(d[j], tv));
    normal_out[3 * ray + j] =
        hit ? __ldg(tri16 + 16 * static_cast<size_t>(row) + 12 + j) : 0.0f;
  }
}

inline size_t traverse_smem_bytes() {
  return sizeof(StackEntry) * static_cast<size_t>(kTraverseShared) *
         kTraverseBlock;
}

template <bool kAnyHit>
int blocks_per_sm() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, traverse_kernel<kAnyHit>, kTraverseBlock,
          traverse_smem_bytes()) != cudaSuccess)
    return 0;
  return blocks;
}

}  // namespace mcpt

extern "C" {

// Resident blocks an SM of the closest-hit (any_hit 0) or any-hit kernel at
// kTraverseBlock threads (the shared part of the stack does not depend on
// the tree; `cap` is the walks' bound, at most kMaxStack).
int mcpt_traverse_blocks_per_sm(int any_hit, int cap) {
  if (cap > mcpt::kMaxStack) return 0;
  return any_hit ? mcpt::blocks_per_sm<true>() : mcpt::blocks_per_sm<false>();
}

// One traversal of n rays on `stream`.  any_hit selects the any-hit walk
// (occ_out written; the closest hit's outputs and tri_map may be null) or
// the closest hit (t_out, tri_out, point_out, normal_out written; occ_out
// may be null, and limit too: no limit).  Tables, rays and outputs are
// device pointers; wnodes and tri16 must be 16-byte aligned; cap: stack
// entries a thread, at most kMaxStack; err (1 int, zeroed by the caller,
// and only ever set here) is set on a stack overflow.  Returns the
// cudaError_t of the launch (0 on success).
int mcpt_traverse(const float* wnodes, const float* tri16, const int* live,
                  const int* tri_map, int n_wide, int leaf_size, int cap,
                  const float* origin, const float* direction,
                  const unsigned char* active, const float* limit,
                  float t_min, int any_hit, float* t_out, int* tri_out,
                  float* point_out, float* normal_out,
                  unsigned char* occ_out, int n, int* err, void* stream) {
  if (n <= 0) return 0;
  if (cap > mcpt::kMaxStack) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + mcpt::kTraverseBlock - 1) / mcpt::kTraverseBlock;
  const size_t smem = mcpt::traverse_smem_bytes();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    mcpt::traverse_kernel<true><<<blocks, mcpt::kTraverseBlock, smem, s>>>(
        wnodes, tri16, live, tri_map, n_wide, leaf_size, cap, origin,
        direction, active, limit, t_min, t_out, tri_out, point_out,
        normal_out, occ_out, n, err);
  else
    mcpt::traverse_kernel<false><<<blocks, mcpt::kTraverseBlock, smem, s>>>(
        wnodes, tri16, live, tri_map, n_wide, leaf_size, cap, origin,
        direction, active, limit, t_min, t_out, tri_out, point_out,
        normal_out, occ_out, n, err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
