// The 8-wide cluster walk: closest hit and any-hit for one ray per thread,
// each thread with its own stack.  The intersector the hybrid fused bounce
// (fused_bounce.cu) plugs into bounce_core.cuh's bounce<Isect>.
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
//     normal, 15 material id); padding rows never hit.
// Both stay in global memory (9-12 MB for the large configs: in the 50 MB
// L2, far past a block's 227 KB of shared memory) and are read through the
// read-only path as float4s.
//
// Hit rule (the plain walk_reference's): the closest hit keeps the lowest t
// and, on an exact tie, the lowest tri16 row; a child is pruned only when its
// t-near exceeds the bound (best t, or the shadow ray's limit).  The result
// is brute force over tri16 in row order, whatever the visit order.
//
// Stack bound: a pop pushes at most 8, nearest last, so the stack holds at
// most 7 siblings per ancestor level plus 8: sp <= 7 * depth + 8, and
// collapse_wide rejects trees with 7 * depth + 8 > kStackCap.  The push
// still checks: an overflow sets *err (the wrapper raises) and ends the
// walk, so even a cyclic table terminates; nothing is clamped silently.

#pragma once

#include <cstdint>

#include "bounce_core.cuh"

namespace mcpt {

constexpr int kStackCap = 128;  // STACK_CAP, mcpt_torch/bvh/cluster.py

struct ClusterIsect {
  const float* wnodes;
  const float* tri16;
  int n_wide, leaf_size;
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

  // Walk from the root; leaf(first_row) tests one cluster and returns true
  // to end the walk.  `bound` is read at every pop (the closest hit tightens
  // it as the walk goes).
  template <class Leaf>
  __device__ __forceinline__ void walk(const float* o, const float* d,
                                       const float& bound, Leaf leaf) const {
    const float inv[3] = {safe_inv(d[0]), safe_inv(d[1]), safe_inv(d[2])};
    const int oct = (d[0] > 0.0f ? 1 : 0) + (d[1] > 0.0f ? 2 : 0) +
                    (d[2] > 0.0f ? 4 : 0);
    int stack[kStackCap];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const int node = stack[--sp];
      if (node >= n_wide) {
        if (leaf((node - n_wide) * leaf_size)) return;
        continue;
      }
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
      // slab test of the 8 children (a NaN slot gives tf = NaN: no hit)
      unsigned hits = 0u;
      const float b = bound;
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
      // push far-to-near in this ray's octant order: the nearest pops first
      const int code = static_cast<int>(__ldg(w + 56 + oct));
      for (int j = 0; j < 8; ++j) {
        const int k = (code >> (3 * j)) & 7;
        if (!((hits >> k) & 1u)) continue;
        if (sp >= kStackCap) {  // never on a table collapse_wide accepts
          *err = 1;
          return;
        }
        stack[sp++] = static_cast<int>(__ldg(w + 48 + k));
      }
    }
  }

  // closest hit -> its tri16 row (row 0 on a miss), best_t = kMiss on a miss
  __device__ __forceinline__ const float* closest(const float* o,
                                                  const float* d, float t_min,
                                                  float& best_t) const {
    best_t = kMiss;
    int best_row = 0;
    walk(o, d, best_t, [&](int row0) {
      for (int r = 0; r < leaf_size; ++r) {
        const int row = row0 + r;
        float c[12], th, u, v;
        load_wald(row, c);
        wald(c, o, d, th, u, v);
        if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && th > t_min &&
            th < kMiss && (th < best_t || (th == best_t && row < best_row))) {
          best_t = th;
          best_row = row;
        }
      }
      return false;
    });
    return tri16 + 16 * static_cast<size_t>(best_row);
  }

  // any hit in (t_min, limit)
  __device__ __forceinline__ bool occluded(const float* o, const float* d,
                                           float t_min, float limit) const {
    bool occ = false;
    walk(o, d, limit, [&](int row0) {
      for (int r = 0; r < leaf_size; ++r) {
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
