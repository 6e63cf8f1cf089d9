// The path tracer's estimator as device code: the counter-hash RNG, the
// camera ray and one bounce (intersect -> material -> emission with the MIS
// discount -> BSDF sample -> NEE shadow ray -> transparent -> next ray ->
// termination -> Russian roulette).
//
// Port of mcpt/pallas/megakernel.py _make_bounce_core (:410) and the
// cam_ray of _render_body (:799).  The TPU shares that core between the
// dense megakernel and the hybrid fused-bounce kernel; here the core is a
// template over the intersector, so both Hopper kernels call this header.
//
// Arithmetic mirrors the plain PyTorch version (mcpt_torch/kernels/
// megakernel.py _bounce) operation by operation, in the same order, with the
// same float32 constants.  The kernels are built with -fmad=false so that no
// multiply-add is contracted: cbox's glass box stands on the floor, and rays
// inside it hit two coplanar triangles at the same t, where one ulp picks the
// winner.  Without contraction the kernel and PyTorch's elementwise kernels
// round identically and the tie falls the same way.

#pragma once

#include <cstdint>

namespace mcpt {

// Python float constants as PyTorch rounds them (double -> float)
#define MCPT_F(x) (static_cast<float>(x))

constexpr float kMiss = 3.0e38f;
constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kGR = 0x9E3779B1u;
constexpr int kDiffuse = 1, kGlossy = 2, kTransparent = 3, kLight = 4;

// launch-wide scalars (the TPU kernel's si / sf tables)
struct Params {
  int width, height, n_tris, max_depth;
  uint32_t seed;
  int rr, rr_start, n_pixels, n_mats, n_lights, pixel_base, total_pixels;
  int spp, sample_base;
  int n_rows, n_mat_rows, n_lit_rows, n_chunks;
  int use_nee, use_mis, regen, n_lanes, smem_tables;
};

// murmur3 fmix32: uint32 wraps and shifts logically, as mcpt's int32 hash
// with shift_right_logical does
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kC1;
  h ^= h >> 13;
  h *= kC2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float u01(uint32_t seed, uint32_t salt,
                                     uint32_t idx) {
  uint32_t h = fmix32(seed + salt * kGR);
  h = fmix32((idx * kGR) ^ h);
  return static_cast<float>(h & 0x7FFFFFu) * MCPT_F(1.0 / 8388608.0);
}

__device__ __forceinline__ float pow_(float x, float n) {
  return expf(n * logf(fmaxf(x, MCPT_F(1e-12))));
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  float inv = 1.0f / sqrtf(x * x + y * y + z * z + MCPT_F(1e-20));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// branchless orthonormal basis (Duff et al.)
__device__ __forceinline__ void onb(float nx, float ny, float nz, float* t1,
                                    float* t2) {
  float s = nz >= 0.0f ? 1.0f : -1.0f;
  float a = -1.0f / (s + nz);
  float b = nx * ny * a;
  t1[0] = 1.0f + s * nx * nx * a;
  t1[1] = s * b;
  t1[2] = -s * nx;
  t2[0] = b;
  t2[1] = s + ny * ny * a;
  t2[2] = -ny;
}

// per-lane path state (the TPU kernel's loop carry)
struct PathState {
  float o[3], d[3], t[3], rad[3];
  float alive, inside, segs, prev_sc, prev_pdf;
};

// Jittered pinhole/ortho camera ray for pixel (px, py), RNG stream idx
// (rayGenerator.cl:13-27).  sf: 0:3 position, 3:6 forward, 6:9 right,
// 9:12 up, 12 half_w, 13 half_h, 17 is_ortho.
__device__ __forceinline__ void cam_ray(const float* sf, const Params& p,
                                        float pxf, float pyf, uint32_t idx,
                                        PathState& s) {
  float fx = pxf + u01(p.seed, 1u, idx);
  float fy = pyf + u01(p.seed, 2u, idx);
  float sx = fx / static_cast<float>(p.width) - 0.5f;
  float sy = fy / static_cast<float>(p.height) - 0.5f;
  float w_ort = sf[17];
  float off[3];
  for (int j = 0; j < 3; ++j)
    off[j] = 2.0f * sx * sf[12] * sf[6 + j] + 2.0f * sy * sf[13] * sf[9 + j];
  for (int j = 0; j < 3; ++j) {
    s.d[j] = sf[3 + j] + (1.0f - w_ort) * off[j];
    s.o[j] = sf[j] + w_ort * off[j];
  }
  normalize3(s.d[0], s.d[1], s.d[2]);
}

// Wald unit-triangle test of one 16-float row (0:9 A, 9:12 b): the hit
// distance and its (u, v) in the triangle's frame.
__device__ __forceinline__ void wald(const float* c, const float* o,
                                     const float* d, float& th, float& u,
                                     float& v) {
  float opz = c[6] * o[0] + c[7] * o[1] + c[8] * o[2] + c[11];
  float dpz = c[6] * d[0] + c[7] * d[1] + c[8] * d[2];
  th = -opz / dpz;
  float opx = c[0] * o[0] + c[1] * o[1] + c[2] * o[2] + c[9];
  float dpx = c[0] * d[0] + c[1] * d[1] + c[2] * d[2];
  u = opx + th * dpx;
  float opy = c[3] * o[0] + c[4] * o[1] + c[5] * o[2] + c[10];
  float dpy = c[3] * d[0] + c[4] * d[1] + c[5] * d[2];
  v = opy + th * dpy;
}

// Shading tables and constants shared by every bounce of a launch.
struct Shading {
  const float* matt;  // (M_pad, 16): kd, ks, ka, ns, ni, mtype
  const float* lit;   // (L, 16): v0, e1, e2, emission, normal, cdf
  int n_lights;
  bool use_nee, use_mis;
  uint32_t seed;
  float eps, t_min, area_l, clampv;
};

// One bounce of a live lane.  Isect provides
//   closest(o, d, t_min, &best_t, &best_row) -> row pointer (16 floats) with
//     best_t = kMiss on a miss, and
//   occluded(o, d, t_min, limit) -> bool.
// depth_ok and rr_on are 0/1 gates from the schedule.  The caller stops
// iterating a lane once alive == 0: its updates would add nothing.
template <class Isect>
__device__ __forceinline__ void bounce(PathState& s, const Isect& isect,
                                       const Shading& sh, uint32_t salt0,
                                       uint32_t pidx, float depth_ok,
                                       float rr_on) {
  const float inv_pi = MCPT_F(1.0 / 3.141592653589793);
  const float inv_2pi = MCPT_F(0.15915494);
  float best_t;
  const float* row = isect.closest(s.o, s.d, sh.t_min, best_t);
  bool hit = (best_t < kMiss) && (s.alive > 0.0f);
  s.segs = s.segs + s.alive;
  float nx = row[12], ny = row[13], nz = row[14];
  const float* m = sh.matt + 16 * static_cast<int>(row[15]);
  float kd[3] = {m[0], m[1], m[2]};
  float ks[3] = {m[3], m[4], m[5]};
  float ns_ = m[9], ni_ = m[10], mtype = m[11];

  float ndotd = nx * s.d[0] + ny * s.d[1] + nz * s.d[2];
  float flip = ndotd < 0.0f ? 1.0f : -1.0f;
  float n[3] = {nx * flip, ny * flip, nz * flip};
  float h[3];
  for (int j = 0; j < 3; ++j) h[j] = s.o[j] + best_t * s.d[j];

  bool is_lite = hit && mtype == static_cast<float>(kLight);
  bool is_diff = hit && mtype == static_cast<float>(kDiffuse);
  bool is_glos = hit && mtype == static_cast<float>(kGlossy);
  bool is_tran = hit && mtype == static_cast<float>(kTransparent);

  if (is_lite) {
    // emission; with NEE it is MIS-discounted after a reflective bounce (or
    // dropped without MIS)
    float lmask = 1.0f;
    if (sh.use_nee) {
      float pdf_lh = best_t * best_t /
                     fmaxf(fabsf(ndotd) * sh.area_l, MCPT_F(1e-12));
      float w_hit = 0.0f;
      if (sh.use_mis) {
        float rat = pdf_lh / fmaxf(s.prev_pdf, MCPT_F(1e-12));
        w_hit = 1.0f / (1.0f + rat * rat);
      }
      lmask = lmask * (1.0f - s.prev_sc * (1.0f - w_hit));
    }
    for (int j = 0; j < 3; ++j)
      s.rad[j] = s.rad[j] + fminf(lmask * s.t[j] * m[6 + j], sh.clampv);
  }
  if (!hit || is_lite) {  // the path ends here (dead = ~hit | is_lite)
    s.alive = 0.0f;
    return;
  }

  float u1 = u01(sh.seed, salt0, pidx);
  float u2 = u01(sh.seed, salt0 + 1u, pidx);
  float u3 = u01(sh.seed, salt0 + 2u, pidx);
  float u4 = u01(sh.seed, salt0 + 3u, pidx);

  // diffuse / glossy: cosine or phong-lobe sample
  float t1[3], t2[3];
  onb(n[0], n[1], n[2], t1, t2);
  float r_ = sqrtf(u1);
  float phi = MCPT_F(6.2831853) * u2;
  float cphi = cosf(phi);
  float sphi = sinf(phi);
  float zc = sqrtf(fmaxf(1.0f - u1, 0.0f));
  float wd[3], md[3];
  for (int j = 0; j < 3; ++j)
    wd[j] = r_ * cphi * t1[j] + r_ * sphi * t2[j] + zc * n[j];
  for (int j = 0; j < 3; ++j) md[j] = s.d[j] - 2.0f * ndotd * flip * n[j];
  float p1[3], p2[3];
  onb(md[0], md[1], md[2], p1, p2);
  float cos_a = pow_(fmaxf(u1, MCPT_F(1e-12)), 1.0f / (ns_ + 1.0f));
  float sin_a = sqrtf(fmaxf(1.0f - cos_a * cos_a, 0.0f));
  bool pick_phong = is_glos && (u3 < 0.5f);
  float sd[3];
  for (int j = 0; j < 3; ++j)
    sd[j] = pick_phong
                ? sin_a * cphi * p1[j] + sin_a * sphi * p2[j] + cos_a * md[j]
                : wd[j];

  float cos_i = sd[0] * n[0] + sd[1] * n[1] + sd[2] * n[2];
  bool up_ok = cos_i > 0.0f;
  float cos_ar = fmaxf(sd[0] * md[0] + sd[1] * md[1] + sd[2] * md[2], 0.0f);
  float pow_ns = pow_(cos_ar, ns_);
  float pdf_d = fmaxf(cos_i, 0.0f) * inv_pi;
  float pdf_p = (ns_ + 1.0f) * inv_2pi * pow_ns;
  float pdf_mix = 0.5f * pdf_d + 0.5f * pdf_p;
  float phong_f = (ns_ + 2.0f) * inv_2pi * pow_ns;
  float scale_g = fmaxf(cos_i, 0.0f) / fmaxf(pdf_mix, MCPT_F(1e-12));
  float ok_f = up_ok ? 1.0f : 0.0f;
  float wr[3];
  for (int j = 0; j < 3; ++j)
    wr[j] = (is_glos ? (kd[j] * inv_pi + ks[j] * phong_f) * scale_g : kd[j]) *
            ok_f;

  if (sh.use_nee && (is_diff || is_glos)) {
    // next-event estimation: pick a light triangle ∝ area — the first CDF
    // bin above ul (binary search); the numeric tail ul >= last cdf takes
    // the last light
    float ul = u01(sh.seed, salt0 + 5u, pidx);
    float ua = u01(sh.seed, salt0 + 6u, pidx);
    float ub = u01(sh.seed, salt0 + 7u, pidx);
    int lo = 0, hi = sh.n_lights;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (sh.lit[16 * mid + 15] > ul)
        hi = mid;
      else
        lo = mid + 1;
    }
    const float* L = sh.lit + 16 * min(lo, sh.n_lights - 1);
    float su_ = sqrtf(ua);
    float b1 = su_ * (1.0f - ub);
    float b2 = su_ * ub;
    float to[3];
    for (int j = 0; j < 3; ++j)
      to[j] = L[j] + b1 * L[3 + j] + b2 * L[6 + j] - h[j];
    float dist2 = to[0] * to[0] + to[1] * to[1] + to[2] * to[2];
    float dist = sqrtf(fmaxf(dist2, MCPT_F(1e-20)));
    float iw[3] = {to[0] / dist, to[1] / dist, to[2] / dist};
    float cos_s = iw[0] * n[0] + iw[1] * n[1] + iw[2] * n[2];
    float cos_l = fabsf(iw[0] * L[12] + iw[1] * L[13] + iw[2] * L[14]);
    if (cos_s > 0.0f && cos_l > MCPT_F(1e-6)) {  // a shadow-ray candidate
      float pdf_sa = dist2 / fmaxf(cos_l * sh.area_l, MCPT_F(1e-12));
      float cos_ar2 =
          fmaxf(iw[0] * md[0] + iw[1] * md[1] + iw[2] * md[2], 0.0f);
      float pw2 = pow_(cos_ar2, ns_);
      float gmask = is_glos ? 1.0f : 0.0f;
      float pdf_d2 = fmaxf(cos_s, 0.0f) * inv_pi;
      float pdf_b2 = (1.0f - 0.5f * gmask) * pdf_d2 +
                     0.5f * gmask * ((ns_ + 1.0f) * inv_2pi * pw2);
      float so[3];
      for (int j = 0; j < 3; ++j) so[j] = h[j] + sh.eps * iw[j];
      s.segs = s.segs + 1.0f;
      if (!isect.occluded(so, iw, sh.t_min, dist - 2.0f * sh.eps)) {
        float w_nee = 1.0f;
        if (sh.use_mis) {
          float rat2 = pdf_b2 / fmaxf(pdf_sa, MCPT_F(1e-12));
          w_nee = 1.0f / (1.0f + rat2 * rat2);
        }
        float gain = 1.0f * (cos_s * w_nee / fmaxf(pdf_sa, MCPT_F(1e-12)));
        for (int j = 0; j < 3; ++j) {
          float f = kd[j] * inv_pi +
                    gmask * ks[j] * (ns_ + 2.0f) * inv_2pi * pw2;
          s.rad[j] = s.rad[j] + fminf(s.t[j] * f * L[9 + j] * gain, sh.clampv);
        }
      }
    }
  }

  // transparent: Schlick coin between refraction and mirror
  float nd[3];
  float w_tran = 1.0f;
  if (is_tran) {
    bool in_m = s.inside > 0.0f;
    float eta_i = in_m ? ni_ : 1.0f;
    float eta_t = in_m ? 1.0f : ni_;
    float eta = eta_i / eta_t;
    float n_dot_i = -(n[0] * s.d[0] + n[1] * s.d[1] + n[2] * s.d[2]);
    float k_ = 1.0f - eta * eta * (1.0f - n_dot_i * n_dot_i);
    bool tir = k_ < 0.0f;
    float sq = sqrtf(fmaxf(k_, 0.0f));
    float td[3];
    for (int j = 0; j < 3; ++j) td[j] = (eta * n_dot_i - sq) * n[j] + eta * s.d[j];
    normalize3(td[0], td[1], td[2]);
    float cos_for_f = eta_i <= eta_t
                          ? n_dot_i
                          : -(td[0] * n[0] + td[1] * n[1] + td[2] * n[2]);
    float r0 = (ni_ - 1.0f) / (ni_ + 1.0f);
    r0 = r0 * r0;
    float one_m = fminf(fmaxf(1.0f - fabsf(cos_for_f), 0.0f), 1.0f);
    float p5 = one_m * one_m;
    p5 = p5 * p5 * one_m;
    float fresnel = r0 + (1.0f - r0) * p5;
    bool do_refr = !tir && !(u4 < fresnel);
    float refrf = do_refr ? 1.0f : 0.0f;
    if (do_refr) w_tran = eta * eta;
    s.inside = (1.0f - s.inside) * refrf + s.inside * (1.0f - refrf);
    for (int j = 0; j < 3; ++j) nd[j] = do_refr ? td[j] : md[j];
  } else {
    for (int j = 0; j < 3; ++j) nd[j] = sd[j];
  }

  // compose the next ray
  bool scatterish = is_diff || is_glos || is_tran;
  float smask = scatterish ? 1.0f : 0.0f;
  for (int j = 0; j < 3; ++j) {
    float w = is_tran ? w_tran : wr[j];
    s.t[j] = s.t[j] * (w * smask + (1.0f - smask));
  }
  if (scatterish) {
    for (int j = 0; j < 3; ++j) {
      s.o[j] = h[j] + sh.eps * nd[j];
      s.d[j] = nd[j];
    }
  }
  bool dead = (is_diff || is_glos) && !up_ok;
  s.alive = s.alive * (dead ? 0.0f : 1.0f) * depth_ok;

  // Russian roulette (rr_on = 0 makes p_srv = 1, a no-op)
  float u5 = u01(sh.seed, salt0 + 4u, pidx);
  float p_srv = fminf(fmaxf(fmaxf(s.t[0], fmaxf(s.t[1], s.t[2])), MCPT_F(0.05)),
                      1.0f);
  p_srv = p_srv * rr_on + (1.0f - rr_on);
  s.alive = s.alive * (u5 < p_srv ? 1.0f : 0.0f);
  float inv_p = 1.0f / p_srv;
  for (int j = 0; j < 3; ++j) s.t[j] = s.t[j] * inv_p;
  s.prev_sc = (is_diff || is_glos) ? 1.0f : 0.0f;
  s.prev_pdf = is_glos ? pdf_mix : pdf_d;
}

}  // namespace mcpt
