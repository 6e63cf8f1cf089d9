"""The plain reference of one path-traced sample: the counter-hash RNG,
the camera ray, and the bounce estimator (intersect → material → emission with
the MIS discount → BSDF sample → NEE shadow ray → transparent → next ray →
termination → Russian roulette), in plain PyTorch on whatever device its
tensors are.

A frozen copy of the arithmetic the scene format defines and the port's
plain versions perform, operation for operation, so that in float32 one
sample here follows the same path as the same sample in the program.  Every
lane carries its own seed, so the samples of many steps run as one batch.
``dt`` is the working precision of the path state: float32 for the
reference, bfloat16 for the benchmark's control.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_C1, _C2, _GR = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B1
LIGHT, DIFFUSE, GLOSSY, TRANSPARENT = 4.0, 1.0, 2.0, 3.0
MISS = 3.0e38


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a · c) mod 2³² for uint32 values held in int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h & M32
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    return h ^ (h >> 16)


def u01(seed: torch.Tensor, salt, idx: torch.Tensor) -> torch.Tensor:
    """Uniform float32 in [0, 1) from murmur3's finaliser of (seed + salt ·
    GR) mixed with idx · GR; all int64 tensors holding uint32 values."""
    h = _fmix32((seed + _mul32(salt & M32 if isinstance(salt, torch.Tensor)
                               else torch.full_like(seed, salt & M32), _GR))
                & M32)
    h = _fmix32(_mul32(idx & M32, _GR) ^ h)
    return (h & 0x7FFFFF).to(torch.float32) * (1.0 / 8388608.0)


def _pow(x, n):
    return torch.exp(n * torch.log(torch.clamp(x, min=1e-12)))


def _normalize3(x, y, z):
    inv = 1.0 / torch.sqrt(x * x + y * y + z * z + 1e-20)
    return x * inv, y * inv, z * inv


def _onb(nx, ny, nz):
    """Branchless orthonormal basis (Duff et al.)."""
    s = torch.where(nz >= 0.0, 1.0, -1.0).to(nx.dtype)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    return ((1.0 + s * nx * nx * a, s * b, -s * nx),
            (b, s + ny * ny * a, -ny))


def camera_ray(sf, seed, pixel, idx, width: int, height: int, dt):
    """Jittered pinhole ray of each lane's pixel from RNG stream ``idx``."""
    fx = (pixel % width).to(torch.float32) + u01(seed, 1, idx)
    fy = (pixel // width).to(torch.float32) + u01(seed, 2, idx)
    dims = torch.tensor([float(width), float(height)], dtype=torch.float32,
                        device=pixel.device)
    sx = (fx / dims[0] - 0.5).to(dt)
    sy = (fy / dims[1] - 0.5).to(dt)
    half_w, half_h, w_ort = sf[12], sf[13], sf[17]
    off = [2.0 * sx * half_w * sf[6 + j] + 2.0 * sy * half_h * sf[9 + j]
           for j in range(3)]
    d = _normalize3(*[sf[3 + j] + (1.0 - w_ort) * off[j] for j in range(3)])
    o = [sf[j] + w_ort * off[j] for j in range(3)]
    return o, list(d)


def bounce(tab, st: dict, seed, salt0: int, pidx, depth_ok: float,
           rr_on: float, closest, occluded) -> dict:
    """One bounce of the live lanes in ``st``.  ``tab`` holds ``matt``,
    ``lit``, ``cdf``, ``n_lights``, ``sf`` (eps 14, t_min 15, light area
    16, clamp 18) and ``dt``; ``closest(o, d, t_min)`` → (t, (n, 16) rows,
    t = 3e38 on a miss) and ``occluded(o, d, limit, t_min)`` → bool are
    the reference's own intersectors."""
    dt, sf = tab.dt, tab.sf
    eps, t_min, area_l = sf[14], sf[15], sf[16]
    clampv = sf[18] if sf[18] > 0.0 else 3.0e38
    ox, oy, oz, dx, dy, dz = (st[k] for k in ("ox", "oy", "oz", "dx", "dy",
                                               "dz"))
    tr, tg, tb = st["tr"], st["tg"], st["tb"]
    rr, rg, rb = st["rr"], st["rg"], st["rb"]
    alive, inside = st["alive"], st["inside"]
    prev_sc, prev_pdf = st["prev_sc"], st["prev_pdf"]

    def u(k):
        return u01(seed, salt0 + k, pidx).to(dt)

    best_t, row = closest((ox, oy, oz), (dx, dy, dz), t_min)
    nx, ny, nz, mid = row[:, 12], row[:, 13], row[:, 14], row[:, 15]
    hit = (best_t < 3.0e38) & (alive > 0.0)
    segs = st["segs"] + alive

    m = tab.matt[mid.to(torch.int64)]
    kdx, kdy, kdz, ksx, ksy, ksz, kax, kay, kaz, ns_, ni_, mtype = (
        m[:, j] for j in range(12))

    ndotd = nx * dx + ny * dy + nz * dz
    flip = torch.where(ndotd < 0.0, 1.0, -1.0).to(dt)
    nx, ny, nz = nx * flip, ny * flip, nz * flip
    hx = ox + best_t * dx
    hy = oy + best_t * dy
    hz = oz + best_t * dz

    is_lite = hit & (mtype == LIGHT)
    is_diff = hit & (mtype == DIFFUSE)
    is_glos = hit & (mtype == GLOSSY)
    is_tran = hit & (mtype == TRANSPARENT)

    # a light hit: its emission, MIS-discounted after a reflective bounce
    lmask = is_lite.to(dt)
    if tab.use_nee:
        pdf_lh = best_t * best_t / torch.clamp(ndotd.abs() * area_l,
                                               min=1e-12)
        if tab.use_mis:
            rat = pdf_lh / torch.clamp(prev_pdf, min=1e-12)
            w_hit = 1.0 / (1.0 + rat * rat)
        else:
            w_hit = torch.zeros_like(pdf_lh)
        lmask = lmask * (1.0 - prev_sc * (1.0 - w_hit))
    rr = rr + torch.clamp(lmask * tr * kax, max=clampv)
    rg = rg + torch.clamp(lmask * tg * kay, max=clampv)
    rb = rb + torch.clamp(lmask * tb * kaz, max=clampv)

    u1, u2, u3, u4 = u(0), u(1), u(2), u(3)

    # diffuse: cosine sample; glossy: one of cosine and the Phong lobe
    (t1x, t1y, t1z), (t2x, t2y, t2z) = _onb(nx, ny, nz)
    r_ = torch.sqrt(u1)
    phi = 6.2831853 * u2
    cphi = torch.cos(phi)
    sphi = torch.sin(phi)
    zc = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    wdx = r_ * cphi * t1x + r_ * sphi * t2x + zc * nx
    wdy = r_ * cphi * t1y + r_ * sphi * t2y + zc * ny
    wdz = r_ * cphi * t1z + r_ * sphi * t2z + zc * nz

    mdx = dx - 2.0 * ndotd * flip * nx
    mdy = dy - 2.0 * ndotd * flip * ny
    mdz = dz - 2.0 * ndotd * flip * nz
    (p1x, p1y, p1z), (p2x, p2y, p2z) = _onb(mdx, mdy, mdz)
    cos_a = _pow(torch.clamp(u1, min=1e-12), 1.0 / (ns_ + 1.0))
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    wpx = sin_a * cphi * p1x + sin_a * sphi * p2x + cos_a * mdx
    wpy = sin_a * cphi * p1y + sin_a * sphi * p2y + cos_a * mdy
    wpz = sin_a * cphi * p1z + sin_a * sphi * p2z + cos_a * mdz

    pick_phong = is_glos & (u3 < 0.5)
    sxd = torch.where(pick_phong, wpx, wdx)
    syd = torch.where(pick_phong, wpy, wdy)
    szd = torch.where(pick_phong, wpz, wdz)

    cos_i = sxd * nx + syd * ny + szd * nz
    up_ok = cos_i > 0.0
    cos_ar = torch.clamp(sxd * mdx + syd * mdy + szd * mdz, min=0.0)
    pow_ns = _pow(cos_ar, ns_)
    inv_pi = 1.0 / math.pi
    inv_2pi = 0.15915494
    pdf_d = torch.clamp(cos_i, min=0.0) * inv_pi
    pdf_p = (ns_ + 1.0) * inv_2pi * pow_ns
    pdf_mix = 0.5 * pdf_d + 0.5 * pdf_p
    phong_f = (ns_ + 2.0) * inv_2pi * pow_ns
    scale_g = torch.clamp(cos_i, min=0.0) / torch.clamp(pdf_mix, min=1e-12)
    ok_f = up_ok.to(dt)
    wrx = torch.where(is_glos, (kdx * inv_pi + ksx * phong_f) * scale_g,
                      kdx) * ok_f
    wry = torch.where(is_glos, (kdy * inv_pi + ksy * phong_f) * scale_g,
                      kdy) * ok_f
    wrz = torch.where(is_glos, (kdz * inv_pi + ksz * phong_f) * scale_g,
                      kdz) * ok_f

    if tab.use_nee:
        # next-event estimation: a light triangle picked ∝ area
        ul, ua, ub = u(5), u(6), u(7)
        li = torch.searchsorted(tab.cdf, ul, right=True)
        lsel = tab.lit[torch.clamp(li, max=tab.n_lights - 1)]
        L = [lsel[:, j] for j in range(15)]
        su_ = torch.sqrt(ua)
        b1 = su_ * (1.0 - ub)
        b2 = su_ * ub
        tox = L[0] + b1 * L[3] + b2 * L[6] - hx
        toy = L[1] + b1 * L[4] + b2 * L[7] - hy
        toz = L[2] + b1 * L[5] + b2 * L[8] - hz
        dist2 = tox * tox + toy * toy + toz * toz
        dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
        iwx = tox / dist
        iwy = toy / dist
        iwz = toz / dist
        cos_s = iwx * nx + iwy * ny + iwz * nz
        cos_l = (iwx * L[12] + iwy * L[13] + iwz * L[14]).abs()
        pdf_sa = dist2 / torch.clamp(cos_l * area_l, min=1e-12)
        cos_ar2 = torch.clamp(iwx * mdx + iwy * mdy + iwz * mdz, min=0.0)
        pw2 = _pow(cos_ar2, ns_)
        gmask = is_glos.to(dt)
        fx_ = kdx * inv_pi + gmask * ksx * (ns_ + 2.0) * inv_2pi * pw2
        fy_ = kdy * inv_pi + gmask * ksy * (ns_ + 2.0) * inv_2pi * pw2
        fz_ = kdz * inv_pi + gmask * ksz * (ns_ + 2.0) * inv_2pi * pw2
        pdf_d2 = torch.clamp(cos_s, min=0.0) * inv_pi
        pdf_b2 = (1.0 - 0.5 * gmask) * pdf_d2 + 0.5 * gmask * (
            (ns_ + 1.0) * inv_2pi * pw2)
        cand = (is_diff | is_glos) & (cos_s > 0.0) & (cos_l > 1e-6)
        ci = torch.nonzero(cand).squeeze(1)
        occ = torch.zeros_like(cand)
        if ci.numel():
            occ[ci] = occluded(
                ((hx + eps * iwx)[ci], (hy + eps * iwy)[ci],
                 (hz + eps * iwz)[ci]), (iwx[ci], iwy[ci], iwz[ci]),
                (dist - 2.0 * eps)[ci], t_min)
        vis = cand.to(dt) * (1.0 - occ.to(dt))
        segs = segs + cand.to(segs.dtype)
        if tab.use_mis:
            rat2 = pdf_b2 / torch.clamp(pdf_sa, min=1e-12)
            w_nee = 1.0 / (1.0 + rat2 * rat2)
        else:
            w_nee = torch.ones_like(pdf_sa)
        gain = vis * (cos_s * w_nee / torch.clamp(pdf_sa, min=1e-12))
        rr = rr + torch.clamp(tr * fx_ * L[9] * gain, max=clampv)
        rg = rg + torch.clamp(tg * fy_ * L[10] * gain, max=clampv)
        rb = rb + torch.clamp(tb * fz_ * L[11] * gain, max=clampv)

    # transparent: Schlick's coin between refraction and mirror
    inside_m = inside > 0.0
    eta_i = torch.where(inside_m, ni_, 1.0)
    eta_t = torch.where(inside_m, 1.0, ni_)
    eta = eta_i / eta_t
    n_dot_i = -(nx * dx + ny * dy + nz * dz)
    k_ = 1.0 - eta * eta * (1.0 - n_dot_i * n_dot_i)
    tir = k_ < 0.0
    sq = torch.sqrt(torch.clamp(k_, min=0.0))
    txd, tyd, tzd = _normalize3((eta * n_dot_i - sq) * nx + eta * dx,
                                (eta * n_dot_i - sq) * ny + eta * dy,
                                (eta * n_dot_i - sq) * nz + eta * dz)
    cos_for_f = torch.where(eta_i <= eta_t, n_dot_i,
                            -(txd * nx + tyd * ny + tzd * nz))
    r0 = (ni_ - 1.0) / (ni_ + 1.0)
    r0 = r0 * r0
    one_m = torch.clamp(1.0 - cos_for_f.abs(), 0.0, 1.0)
    p5 = one_m * one_m
    p5 = p5 * p5 * one_m
    fresnel = r0 + (1.0 - r0) * p5
    do_refr = is_tran & ~tir & ~(u4 < fresnel)
    refrf = do_refr.to(dt)
    w_tran = torch.where(do_refr, eta * eta, 1.0)
    inside = torch.where(is_tran, (1.0 - inside) * refrf
                         + inside * (1.0 - refrf), inside)

    # the next ray
    ndx = torch.where(is_tran, torch.where(do_refr, txd, mdx), sxd)
    ndy = torch.where(is_tran, torch.where(do_refr, tyd, mdy), syd)
    ndz = torch.where(is_tran, torch.where(do_refr, tzd, mdz), szd)
    scatterish = is_diff | is_glos | is_tran
    smask = scatterish.to(dt)
    tr = tr * (torch.where(is_tran, w_tran, wrx) * smask + (1.0 - smask))
    tg = tg * (torch.where(is_tran, w_tran, wry) * smask + (1.0 - smask))
    tb = tb * (torch.where(is_tran, w_tran, wrz) * smask + (1.0 - smask))
    ox = torch.where(scatterish, hx + eps * ndx, ox)
    oy = torch.where(scatterish, hy + eps * ndy, oy)
    oz = torch.where(scatterish, hz + eps * ndz, oz)
    dx = torch.where(scatterish, ndx, dx)
    dy = torch.where(scatterish, ndy, dy)
    dz = torch.where(scatterish, ndz, dz)

    dead = ~hit | is_lite | ((is_diff | is_glos) & ~up_ok)
    alive = alive * torch.where(dead, 0.0, 1.0).to(dt) * depth_ok

    # Russian roulette (rr_on = 0: survival probability 1)
    u5 = u(4)
    p_srv = torch.clamp(torch.maximum(tr, torch.maximum(tg, tb)), 0.05, 1.0)
    p_srv = p_srv * rr_on + (1.0 - rr_on)
    alive = alive * (u5 < p_srv).to(dt)
    inv_p = 1.0 / p_srv
    return dict(
        ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz,
        tr=tr * inv_p, tg=tg * inv_p, tb=tb * inv_p, rr=rr, rg=rg, rb=rb,
        alive=alive, inside=inside, segs=segs,
        prev_sc=(is_diff | is_glos).to(dt),
        prev_pdf=torch.where(is_glos, pdf_mix, pdf_d),
    )
