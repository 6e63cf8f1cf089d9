// The per-lane body of a megakernel: the camera ray of the lane's pixel,
// whole paths under the regen or batch schedule through bounce<Isect>, and
// the lane's outputs.  Shared by the dense megakernel (megakernel.cu,
// DenseIsect) and the cluster megakernel (cluster_mega.cu, ClusterIsect).
//
// Port of mcpt/pallas/megakernel.py _render_body (:721), which the TPU
// shares between the same two kernels; the caller supplies the lane's pixel
// id (_render_body's pixel_override, :776-785): the dense kernel maps lanes
// to pixels linearly, the cluster kernel through the tile permutation.
// Either way the RNG counter of a (sample, pixel) is
// (sample_base + sample) * W*H + pixel, so the engines draw the same
// streams.

#pragma once

#include <cstdint>

#include "bounce_core.cuh"

namespace mcpt {

constexpr int kMaxSmem = 232448;  // bytes a block may hold on sm_90

// The launch-wide shading constants (sf: 14 eps, 15 t_min, 16 light area,
// 18 clamp, 0 disables).
__device__ __forceinline__ Shading make_shading(const Params& p,
                                                const float* sf,
                                                const float* matt,
                                                const float* lit) {
  Shading sh;
  sh.matt = matt;
  sh.lit = lit;
  sh.n_lights = p.n_lights;
  sh.use_nee = p.use_nee != 0;
  sh.use_mis = p.use_mis != 0;
  sh.seed = p.seed;
  sh.eps = sf[14];
  sh.t_min = sf[15];
  sh.area_l = sf[16];
  sh.clampv = sf[18] > 0.0f ? sf[18] : kMiss;
  return sh;
}

// Lane `lane` renders `pixel`: in regen one path after another, in place,
// until p.spp samples are done (capped at spp * max_depth iterations, as on
// the TPU); in batch the sample lane / n_pixels.  Writes the lane's radiance
// sum and live-segment count.
template <class Isect>
__device__ __forceinline__ void render_lane(const Params& p, const float* sf,
                                            const Isect& isect,
                                            const Shading& sh, int lane,
                                            int pixel, float* r, float* g,
                                            float* b, float* segs_out) {
  const float pxf = static_cast<float>(pixel % p.width);
  const float pyf = static_cast<float>(pixel / p.width);
  const uint32_t total = static_cast<uint32_t>(p.total_pixels);
  // RNG counter of (sample, pixel): (sample_base + sample) * W*H + pixel, mod 2^32
  auto counter = [&](int sample) {
    return static_cast<uint32_t>(p.sample_base + sample) * total +
           static_cast<uint32_t>(pixel);
  };

  PathState s;
  s.alive = 1.0f;
  s.inside = 0.0f;
  s.segs = 0.0f;
  s.prev_sc = 0.0f;
  s.prev_pdf = 0.0f;
  for (int j = 0; j < 3; ++j) {
    s.t[j] = 1.0f;
    s.rad[j] = 0.0f;
  }

  if (p.regen) {
    cam_ray(sf, p, pxf, pyf, counter(0), s);
    int depth = 0, done = 0;
    for (int it = 0; it < p.spp * p.max_depth && done < p.spp; ++it) {
      uint32_t pidx = counter(done);
      float depth_ok = depth + 1 < p.max_depth ? 1.0f : 0.0f;
      float rr_on = (p.rr && depth >= p.rr_start) ? 1.0f : 0.0f;
      bounce(s, isect, sh, 8u * static_cast<uint32_t>(depth) + 3u, pidx,
             depth_ok, rr_on);
      if (s.alive > 0.0f) {
        ++depth;
        continue;
      }
      // path finished: start the pixel's next sample in place
      if (++done >= p.spp) break;
      cam_ray(sf, p, pxf, pyf, counter(done), s);
      for (int j = 0; j < 3; ++j) s.t[j] = 1.0f;
      s.inside = 0.0f;
      s.prev_sc = 0.0f;
      s.prev_pdf = 0.0f;
      s.alive = 1.0f;
      depth = 0;
    }
  } else {
    const uint32_t ray_idx = counter(lane / p.n_pixels);
    cam_ray(sf, p, pxf, pyf, ray_idx, s);
    for (int depth = 0; depth < p.max_depth && s.alive > 0.0f; ++depth) {
      float depth_ok = depth + 1 < p.max_depth ? 1.0f : 0.0f;
      float rr_on = (p.rr && depth >= p.rr_start) ? 1.0f : 0.0f;
      bounce(s, isect, sh, 8u * static_cast<uint32_t>(depth) + 3u, ray_idx,
             depth_ok, rr_on);
    }
  }
  r[lane] = s.rad[0];
  g[lane] = s.rad[1];
  b[lane] = s.rad[2];
  segs_out[lane] = s.segs;
}

}  // namespace mcpt
