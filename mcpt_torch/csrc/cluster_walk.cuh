// The 8-wide cluster walk: closest hit and any-hit for one ray per thread.
// The intersector the hybrid fused bounce (fused_bounce.cu) and the cluster
// megakernel (cluster_mega.cu) plug into bounce_core.cuh's bounce<Isect>,
// and the walk the wavefront engine's traversal kernel (traverse.cu) runs
// on its own.
//
// Replaces mcpt/pallas/cluster_megakernel.py _make_cluster_intersectors.walk
// (:106).  The TPU walks ONE scalar stack per 32x128-ray block, because a
// lane cannot gather its own node row (traverse_kernel.py:1-24): the block
// visits the union of its rays' node sets and orders children by the
// block's mean direction.  A GPU thread can gather, so here every ray walks
// its own stack and orders children by its own direction octant.
//
// Tables (layouts in mcpt_torch/bvh/cluster.py ClusterBVH):
//   wnodes (n_wide, 64): child k's box at [6k, 6k+6) (empty slots NaN),
//     its stack code at [48 + k] (wide node, or n_wide + cluster id), the
//     far-to-near slot order for octant o at [56 + o] (3-bit digits);
//   tri16 (n_clusters * leaf_size, 16): Wald rows (0:9 A, 9:12 b, 12:15
//     normal, 15 material id); padding rows never hit and sit last in
//     their cluster;
//   live (n_clusters): a cluster's real rows, the ones a leaf tests.
// wnodes and tri16 stay in global memory (9-12 MB for the large configs: in
// the 50 MB L2, far past a block's 227 KB of shared memory) and are read
// through the read-only path as float4s.
//
// What the card showed (NVIDIA H100 80GB HBM3, 700 W; PERF.md): the walk
// waits on loads, not arithmetic.  Config 7's 4-spp step tested 1.35 G
// triangle rows (48 B each) and 703 M child boxes in 40 ms, ~82 GB through
// L1/L2, while its float work bounds it at 1 ms; a third to two fifths of
// those rows were padding; and one loop served both node pops and 32-row
// leaf tests, so while one lane tested a leaf the others waited.  What this
// walk does about it, each part measured on its own against the others
// (chip_smoke.py --kernel-ab; PERF.md §6):
//   - a leaf tests its live rows only and stops at the padding (without
//     it kernel 3's step took 1.7x as long, kernel 2's bounces 1.25-1.35x);
//   - while-while (Aila and Laine, "Understanding the Efficiency of Ray
//     Traversal on GPUs", HPG 2009): a lane pops wide nodes until it holds
//     a leaf, then tests leaves until it pops a wide node, so the lanes of
//     a warp that hold leaves test them together.  Each lane visits its
//     nodes in the plain walk's order.  Their leaf postponement (a lane
//     holds its first leaf and walks on until every lane holds one) was
//     1.2-1.5x slower here: with 32-row leaves a staler bound costs more
//     than the waiting it saves;
//   - the stack is the thread's column of shared memory, 32-bit entries
//     (entry i at stack[i * stride], stride = the block's threads: no bank
//     conflicts), cap = 7 * depth + 8 entries, so 32 warps take ~175-205 KB
//     for the repo's trees; the rest of the SM's 256 KB is L1, which caches
//     wnodes and tri16.  16-bit entries left more L1 and were 2-16% faster,
//     but they hold only 65,536 stack codes (~1.1-1.6 M triangles), and
//     every table collapse_wide accepts must walk; the 128-entry stack in
//     local memory was within 2%.
//
// Hit rule (the plain walk_reference's): the closest hit keeps the lowest t
// and, on an exact tie, the lowest tri16 row; a child is pruned only when its
// t-near exceeds the bound (best t, or the shadow ray's limit).  The result
// is brute force over tri16 in row order.
//
// Stack bound: a pop pushes at most 8, nearest last, so the stack holds at
// most 7 siblings per ancestor level plus 8: sp <= 7 * depth + 8.  The push
// still checks against the cap: an overflow sets *err (the wrapper raises)
// and ends the walk, so even a cyclic table terminates; nothing is clamped
// silently.

#pragma once

#include <cstdint>

#include "bounce_core.cuh"

namespace mcpt {

typedef int StackEntry;  // a wide node, or n_wide + a cluster id

// The next work item of a persistent loop: a warp-aggregated atomicAdd on
// *next (zeroed by the wrapper before the launch) by the lanes that ask
// together; they get consecutive items in lane order.
__device__ __forceinline__ int fetch_next(int* next) {
  const unsigned mask = __activemask();
  const int leader = __ffs(mask) - 1;
  const unsigned me = threadIdx.x & 31u;
  int base = 0;
  if (static_cast<int>(me) == leader) base = atomicAdd(next, __popc(mask));
  base = __shfl_sync(mask, base, leader);
  return base + __popc(mask & ((1u << me) - 1u));
}

struct ClusterIsect {
  const float* wnodes;
  const float* tri16;
  const int* live;
  int n_wide, leaf_size;
  StackEntry* stack;  // this thread's entry i is stack[i * stride]
  int stride, cap;    // cap: entries a thread may push (7 * depth + 8)
  int* err;

  __device__ __forceinline__ static float safe_inv(float x) {
    const float tiny = MCPT_F(1e-30);
    return 1.0f / (fabsf(x) < tiny ? (x < 0.0f ? -tiny : tiny) : x);
  }

  // the first 12 floats of a tri16 row: the Wald transform
  __device__ __forceinline__ void load_wald(int row, float* c) const {
    const float4* p = reinterpret_cast<const float4*>(tri16) + 4 * row;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float4 v = __ldg(p + q);
      c[4 * q] = v.x;
      c[4 * q + 1] = v.y;
      c[4 * q + 2] = v.z;
      c[4 * q + 3] = v.w;
    }
  }

  __device__ __forceinline__ int pop(int& sp) const {
    return sp > 0 ? stack[--sp * stride] : -1;
  }

  // Slab-test the 8 children of wide node `node` against bound `b` and push
  // the hit ones far-to-near in this ray's octant order (the nearest pops
  // first).  False after an overflow (*err set).
  __device__ __forceinline__ bool expand(int node, const float* o,
                                         const float* inv, int oct, float b,
                                         int& sp) const {
    const float* w = wnodes + 64 * static_cast<size_t>(node);
    const float4* w4 = reinterpret_cast<const float4*>(w);
    float box[48];
#pragma unroll
    for (int q = 0; q < 12; ++q) {
      float4 v = __ldg(w4 + q);
      box[4 * q] = v.x;
      box[4 * q + 1] = v.y;
      box[4 * q + 2] = v.z;
      box[4 * q + 3] = v.w;
    }
    // a NaN slot gives tf = NaN: no hit
    unsigned hits = 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float* c = box + 6 * k;
      float t0x = (c[0] - o[0]) * inv[0], t1x = (c[3] - o[0]) * inv[0];
      float t0y = (c[1] - o[1]) * inv[1], t1y = (c[4] - o[1]) * inv[1];
      float t0z = (c[2] - o[2]) * inv[2], t1z = (c[5] - o[2]) * inv[2];
      float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                       fminf(t0z, t1z));
      float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                       fmaxf(t0z, t1z));
      if (tf >= fmaxf(tn, 0.0f) && tn <= b) hits |= 1u << k;
    }
    const int code = static_cast<int>(__ldg(w + 56 + oct));
    for (int j = 0; j < 8; ++j) {
      const int k = (code >> (3 * j)) & 7;
      if (!((hits >> k) & 1u)) continue;
      if (sp >= cap) {  // never on a table collapse_wide accepts
        *err = 1;
        return false;
      }
      stack[sp++ * stride] = static_cast<int>(__ldg(w + 48 + k));
    }
    return true;
  }

  // Walk from the root; leaf(first_row, n_rows) tests one cluster's live
  // rows and returns true to end the walk.  `bound` is read at every
  // expansion (the closest hit tightens it as the walk goes).  Lanes pop in
  // the plain walk's order.
  template <class Leaf>
  __device__ __forceinline__ void walk(const float* o, const float* d,
                                       const float& bound, Leaf leaf) const {
    const float inv[3] = {safe_inv(d[0]), safe_inv(d[1]), safe_inv(d[2])};
    const int oct = (d[0] > 0.0f ? 1 : 0) + (d[1] > 0.0f ? 2 : 0) +
                    (d[2] > 0.0f ? 4 : 0);
    int sp = 0;
    int node = 0;  // the entry in hand (the root first); -1: stack dry
    while (node >= 0) {
      // wide nodes, until this lane pops a leaf or runs dry ...
      while (node >= 0 && node < n_wide) {
        if (!expand(node, o, inv, oct, bound, sp)) return;
        node = pop(sp);
      }
      // ... then leaves, until it pops a wide node: the lanes of a warp
      // that hold leaves test them together
      while (node >= n_wide) {
        const int c = node - n_wide;
        if (leaf(c * leaf_size, __ldg(live + c))) return;
        node = pop(sp);
      }
    }
  }

  // closest hit in (t_min, limit) -> its tri16 row index, -1 on a miss;
  // best_t is the hit's t, or `limit` on a miss.  Starting the bound at
  // `limit` also prunes every box beyond it.
  __device__ __forceinline__ int closest_row(const float* o, const float* d,
                                             float t_min, float limit,
                                             float& best_t) const {
    best_t = limit;
    int best_row = -1;
    walk(o, d, best_t, [&](int row0, int n_rows) {
      for (int r = 0; r < n_rows; ++r) {
        const int row = row0 + r;
        float c[12], th, u, v;
        load_wald(row, c);
        wald(c, o, d, th, u, v);
        if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && th > t_min &&
            (th < best_t || (th == best_t && row < best_row))) {
          best_t = th;
          best_row = row;
        }
      }
      return false;
    });
    return best_row;
  }

  // closest hit -> its tri16 row (row 0 on a miss), best_t = kMiss on a miss
  __device__ __forceinline__ const float* closest(const float* o,
                                                  const float* d, float t_min,
                                                  float& best_t) const {
    const int row = closest_row(o, d, t_min, kMiss, best_t);
    return tri16 + 16 * static_cast<size_t>(row < 0 ? 0 : row);
  }

  // any hit in (t_min, limit)
  __device__ __forceinline__ bool occluded(const float* o, const float* d,
                                           float t_min, float limit) const {
    bool occ = false;
    walk(o, d, limit, [&](int row0, int n_rows) {
      for (int r = 0; r < n_rows; ++r) {
        float c[12], th, u, v;
        load_wald(row0 + r, c);
        wald(c, o, d, th, u, v);
        if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && th > t_min &&
            th < limit) {
          occ = true;
          return true;
        }
      }
      return false;
    });
    return occ;
  }
};

}  // namespace mcpt
