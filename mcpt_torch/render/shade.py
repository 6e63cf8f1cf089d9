"""BSDF sampling and the path-state update of the wavefront engine (the port
of ``mcpt/render/shade.py``).

One update over the whole ray pool per bounce, every material branch
computed for every ray and selected by mask, as ``mcpt`` does: diffuse
(cosine sampling, weight kd), glossy (a 50/50 mixture of the cosine lobe and
a normalised Phong lobe under the mixture pdf), transparent (a Schlick coin
between refraction and mirror, with the (η_i/η_t)² factor on refraction),
light (emission, then the path ends), and optional Russian roulette.  The
random numbers are one threefry draw ``uniform(key, (R, 6))`` per bounce.

Arithmetic follows ``mcpt``'s operation order.  Where ``mcpt`` divides by a
constant, XLA multiplies by the float32 reciprocal, so this module does too
(``camera.recip_f32``); divisions by tensors stay divisions.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mcpt_torch import rng
from mcpt_torch.render.camera import recip_f32
from mcpt_torch.render.traverse import dot
from mcpt_torch.trace import spanned
from mcpt_torch.types import (DIFFUSE, EPSILON, GLOSSY, LIGHT, TRANSPARENT,
                              Hit, Materials, RayPool)

_INV_PI = recip_f32(math.pi)
_INV_2PI = recip_f32(2.0 * math.pi)
_TWO_PI = 2.0 * math.pi


def build_onb(n: torch.Tensor):
    """Branchless orthonormal basis from a unit vector (Duff et al. 2017)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t1 = torch.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * b,
                      -s * n[..., 0]], dim=-1)
    t2 = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t1, t2


def sample_cosine_hemisphere(n, u1, u2):
    """Cosine-weighted direction about n; pdf = cosθ/π."""
    t1, t2 = build_onb(n)
    r = torch.sqrt(u1)
    phi = _TWO_PI * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    return x[..., None] * t1 + y[..., None] * t2 + z[..., None] * n


def sample_phong_lobe(refl, ns, u1, u2):
    """Sample about the mirror direction with pdf = (Ns+1)/2π · cos^Ns α."""
    t1, t2 = build_onb(refl)
    cos_a = torch.pow(torch.clamp(u1, min=1e-12), 1.0 / (ns + 1.0))
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    phi = _TWO_PI * u2
    return ((sin_a * torch.cos(phi))[..., None] * t1
            + (sin_a * torch.sin(phi))[..., None] * t2
            + cos_a[..., None] * refl)


def mirror(n, d):
    """Mirror reflection (``shade.cl:19-25``)."""
    return d - 2.0 * dot(n, d)[..., None] * n


def refract(n, d, eta_ratio):
    """Snell refraction, n facing the incoming ray → (direction, total
    internal reflection mask)."""
    n_dot_i = -dot(n, d)
    k = 1.0 - eta_ratio * eta_ratio * (1.0 - n_dot_i * n_dot_i)
    tir = k < 0.0
    k_safe = torch.clamp(k, min=0.0)
    t = ((eta_ratio * n_dot_i - torch.sqrt(k_safe))[..., None] * n
         + eta_ratio[..., None] * d)
    norm = torch.sqrt(dot(t, t))
    return t / torch.clamp(norm, min=1e-20)[..., None], tir


def schlick_fresnel(cos_theta, ior):
    """Schlick's approximation (``shade.cl:69-73``)."""
    r0 = (ior - 1.0) / (ior + 1.0)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * torch.pow(
        torch.clamp(1.0 - cos_theta.abs(), 0.0, 1.0), 5.0)


def eval_bsdf(materials: Materials, mat_id, n, wo, wi):
    """f(wo→wi) and the BSDF-sampling pdf for MIS (``wo`` towards the
    camera path, ``wi`` towards the light); only diffuse and glossy are
    nonzero → (f (R, 3), pdf (R,))."""
    mtype = materials.mtype[mat_id]
    kd = materials.kd[mat_id]
    ks = materials.ks[mat_id]
    ns = materials.ns[mat_id]
    cos_i = dot(n, wi)
    up = cos_i > 0.0

    f_diff = kd * _INV_PI
    pdf_diff = torch.clamp(cos_i, min=0.0) * _INV_PI
    refl = mirror(n, -wo)
    cos_a = torch.clamp(dot(refl, wi), min=0.0)
    f_phong = ks * ((ns + 2.0) * _INV_2PI * torch.pow(cos_a, ns))[..., None]
    pdf_phong = (ns + 1.0) * _INV_2PI * torch.pow(cos_a, ns)

    is_diffuse = (mtype == DIFFUSE) & up
    is_glossy = (mtype == GLOSSY) & up
    f = torch.where(is_diffuse[..., None], f_diff,
                    torch.where(is_glossy[..., None], f_diff + f_phong, 0.0))
    pdf = torch.where(is_diffuse, pdf_diff,
                      torch.where(is_glossy, 0.5 * pdf_diff + 0.5 * pdf_phong,
                                  0.0))
    return f, pdf


class ShadeResult(NamedTuple):
    pool: RayPool
    # surface data for NEE at this bounce (valid where ``scatter``)
    n_shade: torch.Tensor  # (R, 3) shading normal, facing the incoming ray
    mat_id: torch.Tensor  # (R,) material index
    scatter: torch.Tensor  # (R,) bool — bounced off a diffuse/glossy surface
    bsdf_pdf: torch.Tensor  # (R,) pdf of the sampled direction (for MIS)


@spanned("mcpt.wavefront.shade")
def shade(materials: Materials, tri_mat_id: torch.Tensor, pool: RayPool,
          hit: Hit, key: rng.Key, depth: int, max_depth: int,
          rr_enabled: bool = False, rr_start_depth: int = 3,
          emission_scale=None, eps=EPSILON) -> ShadeResult:
    """One bounce of the wavefront: consume ``hit``, update the pool.

    ``tri_mat_id`` is ``geom.mat_id``; ``depth`` is this bounce's index, and
    rays leaving bounce ``max_depth - 1`` die (``shade.cl:199-202``).
    ``emission_scale`` discounts light hits after a scatter bounce (MIS)."""
    r = pool.count
    u = rng.uniform(key, (r, 6), pool.origin.device)

    live = pool.alive
    d = pool.direction
    valid = hit.valid
    mat_id = torch.clamp(tri_mat_id[torch.clamp(hit.tri, min=0).long()], 0,
                         materials.count - 1).long()
    mtype = torch.where(valid, materials.mtype[mat_id], 0)
    kd = materials.kd[mat_id]
    ks = materials.ks[mat_id]
    ka = materials.ka[mat_id]
    ns_ = materials.ns[mat_id]
    ni = materials.ni[mat_id]

    # the normal flipped to face the incoming ray (intersect.cl:23-25)
    n_raw = hit.normal
    facing = dot(n_raw, d) < 0.0
    n = torch.where(facing[:, None], n_raw, -n_raw)

    is_diff = live & (mtype == DIFFUSE)
    is_glos = live & (mtype == GLOSSY)
    is_tran = live & (mtype == TRANSPARENT)
    is_lite = live & (mtype == LIGHT)

    # light: emission, then the path ends (shade.cl:155-158)
    emitted = pool.throughput * ka
    if emission_scale is not None:
        emitted = emitted * emission_scale[..., None]
    radiance = pool.radiance + torch.where(is_lite[:, None], emitted, 0.0)

    # diffuse / glossy: one-sample mixture of the cosine and Phong lobes
    refl = mirror(n, d)
    wi_diff = sample_cosine_hemisphere(n, u[:, 0], u[:, 1])
    wi_phong = sample_phong_lobe(refl, ns_, u[:, 0], u[:, 1])
    pick_phong = is_glos & (u[:, 2] < 0.5)
    wi_refl = torch.where(pick_phong[:, None], wi_phong, wi_diff)

    cos_i = dot(n, wi_refl)
    up_ok = cos_i > 0.0
    cos_a = torch.clamp(dot(refl, wi_refl), min=0.0)
    pdf_diff = torch.clamp(cos_i, min=0.0) * _INV_PI
    pdf_phong = (ns_ + 1.0) * _INV_2PI * torch.pow(cos_a, ns_)
    f_diff = kd * _INV_PI
    f_phong = ks * ((ns_ + 2.0) * _INV_2PI * torch.pow(cos_a, ns_))[:, None]
    pdf_mix = 0.5 * pdf_diff + 0.5 * pdf_phong
    w_glos = (f_diff + f_phong) * (
        torch.clamp(cos_i, min=0.0) / torch.clamp(pdf_mix, min=1e-12))[:, None]
    w_refl = torch.where(is_glos[:, None], w_glos, kd)
    w_refl = torch.where(up_ok[:, None], w_refl, 0.0)
    bsdf_pdf = torch.where(is_glos, pdf_mix, pdf_diff)

    # transparent: Fresnel coin between refraction and mirror
    eta_i = torch.where(pool.inside, ni, 1.0)
    eta_t = torch.where(pool.inside, 1.0, ni)
    eta_ratio = eta_i / eta_t
    wi_refr, tir = refract(n, d, eta_ratio)
    cos_for_f = torch.where(eta_i <= eta_t, dot(n, d), dot(-n, wi_refr))
    fresnel = schlick_fresnel(cos_for_f, ni)
    coin_reflect = u[:, 3] < fresnel
    do_refract = is_tran & ~tir & ~coin_reflect
    wi_tran = torch.where(do_refract[:, None], wi_refr, mirror(n, d))
    w_tran = torch.where(do_refract, eta_ratio * eta_ratio, 1.0)[:, None]
    inside_new = torch.where(do_refract, ~pool.inside, pool.inside)

    # compose the next ray
    scatter = is_diff | is_glos
    new_dir = torch.where(is_tran[:, None], wi_tran, wi_refl)
    weight = torch.where(is_tran[:, None], w_tran, w_refl)
    throughput = torch.where((scatter | is_tran)[:, None],
                             pool.throughput * weight, pool.throughput)
    new_origin = hit.point + eps * new_dir

    alive = live & valid & ~is_lite
    alive = alive & ~(scatter & ~up_ok)  # zero-weight continuations die
    if depth + 1 >= max_depth:
        alive = torch.zeros_like(alive)

    # Russian roulette (before rr_start_depth mcpt divides by p = 1: exact)
    if rr_enabled and depth >= rr_start_depth:
        p_survive = torch.clamp(throughput.amax(dim=1), 0.05, 1.0)
        throughput = throughput / p_survive[:, None]
        alive = alive & (u[:, 4] < p_survive)

    new_pool = RayPool(
        origin=torch.where(alive[:, None], new_origin, pool.origin),
        direction=torch.where(alive[:, None], new_dir, d),
        throughput=torch.where(alive[:, None], throughput, pool.throughput),
        radiance=radiance,
        pixel=pool.pixel,
        alive=alive,
        inside=torch.where(is_tran, inside_new, pool.inside),
    )
    return ShadeResult(pool=new_pool, n_shade=n, mat_id=mat_id,
                       scatter=scatter, bsdf_pdf=bsdf_pdf)
