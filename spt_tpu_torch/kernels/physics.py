"""One bounce of the forward path tracer, as plain PyTorch ops.

The plain version of the per-bounce math that the CUDA kernel K1 runs
(``csrc/physics.cuh``), and the port of ``spt_tpu.kernels.physics``: nearest
sphere, emission with MIS weighting, NEE with sphere-cone light sampling,
Lambert / GGX metal / smooth dielectric sampling, Russian roulette.  Every
float expression keeps the JAX package's operation order and its float32
constants, so the two agree to rounding.

Layout, on flat component tensors of N lanes:

* ``theta = (spheres, sky, lights)``: ``spheres`` (P, 12) rows
  cx cy cz r ar ag ab er eg eb rough ior, ``sky`` (6,) horizon + zenith rgb,
  ``lights`` (L, 7) rows cx cy cz r er eg eb.
* ``state``: 13 (N,) float32 tensors (o, d, throughput, radiance, prev_pdf).
* ``aux = (active, prev_spec)``: (N,) bool tensors.
* ``u``: dict of (N,) uniforms rr u1 u2 lobe lu1 lu2, the light-cell grid
  ``lsel_lo`` / ``lsel_ext`` (3 float32 0-d tensors each), ``sample``
  (uint32 values as int64) and ``seed``.

Where the JAX package unrolls over spheres in index order, this version
tests all spheres at once as (P, N) tensors and takes the first index of
the least distance, which is the sequential strict ``t < t_best`` scan's
answer.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import rng
from ..core.materials import DIELECTRIC, LAMBERT, METAL
from ..core.scene import SKY_CONSTANT, SKY_GRADIENT

TMIN = 1e-3
EPS = 1e-4
BIG = 1e30

# RNG stream layout shared by every integrator: dim = bounce * N_DIMS + D.
N_DIMS = 8
DIM_RR, DIM_U1, DIM_U2, DIM_LSEL, DIM_LU1, DIM_LU2, DIM_LOBE = range(7)

# The NEE light pick is keyed on the shading-point CELL of a LSEL_CELLS^3
# grid over the scene's primitive bounds: counter_uniform(cell, sample,
# bounce*N_DIMS+DIM_LSEL, seed).  The key point is the hit point at bounce
# 0 and the ray origin (the previous hit) after.  Every backend must use the
# same convention.
LSEL_CELLS = 16

# Light attrs (cx cy cz r er eg eb) as indices into a sphere row.
LIGHT_TO_SPHERE_ATTR = (0, 1, 2, 3, 7, 8, 9)
_H_KEYS = ("cx", "cy", "cz", "r", "ar", "ag", "ab", "er", "eg", "eb",
           "rough", "ior")


class BounceCfg(NamedTuple):
    """Static per-bounce configuration."""
    mtypes: tuple        # per-sphere material type ints (or an int tensor)
    k: int               # bounce index
    rr_depth: int
    use_nee: bool
    use_mis: bool
    sky_mode: int
    n_light_slots: int


def lsel_bounds(centers, radii, valid) -> torch.Tensor:
    """Light-cell grid bounds (lo3, ext3) as one (6,) float32 tensor.

    Min/max of c±r over prims with ``valid & r > 0``: order-free, so every
    backend gets the same bits from the same scene arrays."""
    c = torch.as_tensor(centers, dtype=torch.float32)
    r = torch.as_tensor(radii, dtype=torch.float32, device=c.device)
    ok = torch.as_tensor(valid, dtype=torch.bool, device=c.device) & (r > 0)
    big = 3e38
    lo = torch.where(ok[:, None], c - r[:, None], big).amin(dim=0)
    hi = torch.where(ok[:, None], c + r[:, None], -big).amax(dim=0)
    if not bool(ok.any()):
        return torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0, 1.0],
                            dtype=torch.float32, device=c.device)
    return torch.cat([lo, torch.clamp_min(hi - lo, 1e-5)])


def lsel_cell(hx, hy, hz, lo3, ext3) -> torch.Tensor:
    """Quantized shading-point cell id (uint32 value as int64)."""
    cell = None
    for h, lo, e in zip((hx, hy, hz), lo3, ext3):
        scale = float(LSEL_CELLS) / e        # float32: e is a 0-d tensor
        q = torch.clamp((h - lo) * scale, 0.0, LSEL_CELLS - 1.0).to(torch.int32)
        cell = q if cell is None else cell * LSEL_CELLS + q
    return cell.to(torch.int64) & rng.MASK32


def lsel_uniform(kx, ky, kz, u, k: int) -> torch.Tensor:
    """The cell-keyed light-selection uniform."""
    cell = lsel_cell(kx, ky, kz, u["lsel_lo"], u["lsel_ext"])
    return rng.counter_uniform(cell, u["sample"], k * N_DIMS + DIM_LSEL,
                               u["seed"])


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize(x, y, z):
    inv = 1.0 / torch.sqrt(torch.clamp_min(x * x + y * y + z * z, 1e-20))
    return x * inv, y * inv, z * inv


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def _onb(nx, ny, nz):
    use_z = torch.abs(nz) < 0.999
    ux = torch.where(use_z, 0.0, 1.0)
    uy = torch.zeros_like(nx)
    uz = torch.where(use_z, 1.0, 0.0)
    tx, ty, tz = _cross(ux, uy, uz, nx, ny, nz)
    tx, ty, tz = _normalize(tx, ty, tz)
    bx, by, bz = _cross(nx, ny, nz, tx, ty, tz)
    return tx, ty, tz, bx, by, bz


def _schlick1(cos_i, f0):
    m = torch.clamp(1.0 - cos_i, 0.0, 1.0)
    m2 = m * m
    return f0 + (1.0 - f0) * m2 * m2 * m


def _fresnel_dielectric(cos_i, eta_ti):
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = (1.0 / (eta_ti * eta_ti)) * torch.clamp_min(1.0 - cos_i * cos_i,
                                                         0.0)
    tir = sin2_t >= 1.0
    safe = torch.where(tir, 1.0, 1.0 - sin2_t)
    cos_t = torch.where(tir, 0.0, torch.sqrt(torch.clamp_min(safe, 1e-12)))
    rs = (cos_i - eta_ti * cos_t) / torch.clamp_min(cos_i + eta_ti * cos_t,
                                                    1e-8)
    rp = (eta_ti * cos_i - cos_t) / torch.clamp_min(eta_ti * cos_i + cos_t,
                                                    1e-8)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(tir, 1.0, f)


def sky_radiance(sky, dx, dy, dz, sky_mode: int):
    """Sky -> per-lane radiance; sky = (6,) horizon rgb, zenith rgb."""
    if sky_mode == SKY_GRADIENT:
        t = 0.5 * (dy + 1.0)
        return (sky[0] * (1.0 - t) + sky[3] * t,
                sky[1] * (1.0 - t) + sky[4] * t,
                sky[2] * (1.0 - t) + sky[5] * t)
    if sky_mode == SKY_CONSTANT:
        one = torch.ones_like(dx)
        return sky[0] * one, sky[1] * one, sky[2] * one
    z = torch.zeros_like(dx)
    return z, z, z


def _sphere_t(spheres, ox, oy, oz, dx, dy, dz):
    """(P, N) entry distances and their validity (disc > 0)."""
    cx, cy, cz, r = (spheres[:, a:a + 1] for a in range(4))
    ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
    b = _dot(dx, dy, dz, ocx, ocy, ocz)
    c = _dot(ocx, ocy, ocz, ocx, ocy, ocz) - r * r
    disc = b * b - c
    pos = disc > 0.0
    sq = torch.where(pos, torch.sqrt(torch.clamp_min(
        torch.where(pos, disc, 1.0), 1e-12)), 0.0)
    t0 = b - sq
    t1 = b + sq
    tj = torch.where(t0 > TMIN, t0, t1)
    return tj, pos & (tj > TMIN)


def intersect_spheres_unrolled(spheres, mtypes, ox, oy, oz, dx, dy, dz,
                               tmax=None):
    """Nearest hit over all spheres; ties go to the lowest index."""
    tj, ok = _sphere_t(spheres, ox, oy, oz, dx, dy, dz)
    if tmax is not None:
        ok = ok & (tj < tmax)
    t_best, j = torch.where(ok, tj, BIG).min(dim=0)
    found = t_best < BIG
    h = {}
    for a, key in enumerate(_H_KEYS):
        default = 1.5 if key == "ior" else 0.0
        h[key] = torch.where(found, spheres[j, a], default)
    mt = torch.as_tensor(mtypes, dtype=torch.int32, device=ox.device)[j]
    m_lam = found & (mt == LAMBERT)
    m_met = found & (mt == METAL)
    m_die = found & (mt == DIELECTRIC)
    j_best = torch.where(found, j.to(torch.float32), 0.0)
    return t_best, h, m_lam, m_met, m_die, j_best


def occluded_unrolled(spheres, ox, oy, oz, dx, dy, dz, tmax):
    tj, ok = _sphere_t(spheres, ox, oy, oz, dx, dy, dz)
    return (ok & (tj < tmax)).any(dim=0)


def nee_shadow_setup(ox, oy, oz, hx, hy, hz, nsx, nsy, nsz, u, lights, nl,
                     nlf, k):
    """Light pick + sphere-cone sample + shadow-ray construction.

    Returns (pox, poy, poz, ldx, ldy, ldz, t_l, pdf_l, inside_l,
    ler, leg, leb)."""
    if k == 0:
        ul = lsel_uniform(hx, hy, hz, u, k)
    else:   # (ox, oy, oz) hold the bounce's INPUT ray origins
        ul = lsel_uniform(ox, oy, oz, u, k)
    lu1, lu2 = u["lu1"], u["lu2"]
    li = torch.clamp_max((ul * nlf).to(torch.int32), nl - 1)
    zero = torch.zeros_like(ox)
    lcx, lcy, lcz, lrr = zero, zero, zero, zero
    ler, leg, leb = zero, zero, zero
    for l in range(lights.shape[0]):
        if l >= nl:
            break
        sel = li == l
        lat = lights[l]
        lcx = torch.where(sel, lat[0], lcx)
        lcy = torch.where(sel, lat[1], lcy)
        lcz = torch.where(sel, lat[2], lcz)
        lrr = torch.where(sel, lat[3], lrr)
        ler = torch.where(sel, lat[4], ler)
        leg = torch.where(sel, lat[5], leg)
        leb = torch.where(sel, lat[6], leb)
    pox = hx + EPS * nsx
    poy = hy + EPS * nsy
    poz = hz + EPS * nsz
    tocx, tocy, tocz = lcx - pox, lcy - poy, lcz - poz
    d2 = torch.clamp_min(_dot(tocx, tocy, tocz, tocx, tocy, tocz), 1e-12)
    dist = torch.sqrt(d2)
    inside_l = dist <= lrr
    sin2m = torch.clamp(lrr * lrr / d2, 0.0, 1.0)
    degm = sin2m >= 1.0
    cosm_l = torch.where(degm, 0.0,
                         torch.sqrt(torch.where(degm, 1.0, 1.0 - sin2m)))
    ctl = 1.0 - lu1 * (1.0 - cosm_l)
    stl = torch.sqrt(torch.clamp_min(1.0 - ctl * ctl, 1e-12))
    phil = (2.0 * math.pi) * lu2
    wlx, wly, wlz = tocx / dist, tocy / dist, tocz / dist
    ltx, lty, ltz, lbx, lby, lbz = _onb(wlx, wly, wlz)
    cpl = torch.cos(phil)
    spl = torch.sin(phil)
    ldx = stl * cpl * ltx + stl * spl * lbx + ctl * wlx
    ldy = stl * cpl * lty + stl * spl * lby + ctl * wly
    ldz = stl * cpl * ltz + stl * spl * lbz + ctl * wlz
    pdf_l = 1.0 / torch.clamp_min(2.0 * math.pi * (1.0 - cosm_l), 1e-9)
    pdf_l = pdf_l / nlf
    bl = _dot(ldx, ldy, ldz, tocx, tocy, tocz)
    cl = _dot(tocx, tocy, tocz, tocx, tocy, tocz) - lrr * lrr
    discl = torch.clamp_min(bl * bl - cl, 0.0)
    t_l = bl - torch.sqrt(torch.clamp_min(discl, 1e-20))
    return (pox, poy, poz, ldx, ldy, ldz, t_l, pdf_l, inside_l,
            ler, leg, leb)


def trace_bounce(theta, state, aux, u, nl: int, cfg: BounceCfg):
    """One bounce: (state, aux) -> (new_state, new_aux)."""
    spheres, sky, lights = theta
    (ox, oy, oz, dx, dy, dz, th_r, th_g, th_b,
     rad_r, rad_g, rad_b, prev_pdf) = state
    active, prev_spec = aux
    k = cfg.k
    use_nee = cfg.use_nee and cfg.n_light_slots > 0
    use_mis = cfg.use_mis

    t, h, m_lam, m_met, m_die, _ = intersect_spheres_unrolled(
        spheres, cfg.mtypes, ox, oy, oz, dx, dy, dz)
    found = t < BIG
    hit = active & found
    miss = active & ~found

    sk_r, sk_g, sk_b = sky_radiance(sky, dx, dy, dz, cfg.sky_mode)
    rad_r = torch.where(miss, rad_r + th_r * sk_r, rad_r)
    rad_g = torch.where(miss, rad_g + th_g * sk_g, rad_g)
    rad_b = torch.where(miss, rad_b + th_b * sk_b, rad_b)

    t_safe = torch.where(hit, t, 1.0)
    hx = ox + t_safe * dx
    hy = oy + t_safe * dy
    hz = oz + t_safe * dz
    ngx, ngy, ngz = _normalize(hx - h["cx"], hy - h["cy"], hz - h["cz"])
    wox, woy, woz = -dx, -dy, -dz

    emitting = hit & ((h["er"] + h["eg"] + h["eb"]) > 0.0) \
        & (_dot(wox, woy, woz, ngx, ngy, ngz) > 0.0)
    nlf = max(float(nl), 1.0)
    if use_nee and use_mis:
        tocx, tocy, tocz = h["cx"] - ox, h["cy"] - oy, h["cz"] - oz
        d2 = torch.clamp_min(_dot(tocx, tocy, tocz, tocx, tocy, tocz), 1e-12)
        sin2 = torch.clamp(h["r"] * h["r"] / d2, 0.0, 1.0)
        deg = sin2 >= 1.0
        cosm = torch.where(deg, 0.0,
                           torch.sqrt(torch.where(deg, 1.0, 1.0 - sin2)))
        pdf_lh = 1.0 / torch.clamp_min(2.0 * math.pi * (1.0 - cosm), 1e-9)
        pdf_lh = pdf_lh / nlf
        pp2 = prev_pdf * prev_pdf
        w_b = pp2 / torch.clamp_min(pp2 + pdf_lh * pdf_lh, 1e-20)
        w_emit = torch.where(prev_spec, 1.0, w_b)
    elif use_nee:
        w_emit = torch.where(prev_spec, 1.0, 0.0)
    else:
        w_emit = torch.ones_like(prev_pdf)
    if nl <= 0:
        w_emit = torch.ones_like(prev_pdf)
    rad_r = torch.where(emitting, rad_r + th_r * h["er"] * w_emit, rad_r)
    rad_g = torch.where(emitting, rad_g + th_g * h["eg"] * w_emit, rad_g)
    rad_b = torch.where(emitting, rad_b + th_b * h["eb"] * w_emit, rad_b)

    front = _dot(wox, woy, woz, ngx, ngy, ngz) > 0.0
    sgn = torch.where(front, 1.0, -1.0)
    nsx, nsy, nsz = ngx * sgn, ngy * sgn, ngz * sgn

    u_lobe, u1, u2 = u["lobe"], u["u1"], u["u2"]
    tx, ty, tz, bx, by, bz = _onb(nsx, nsy, nsz)

    # Lambert cosine sample.
    ct = torch.sqrt(u1)
    st = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    phi = (2.0 * math.pi) * u2
    cphi = torch.cos(phi)
    sphi = torch.sin(phi)
    dl_x = st * cphi * tx + st * sphi * bx + ct * nsx
    dl_y = st * cphi * ty + st * sphi * by + ct * nsy
    dl_z = st * cphi * tz + st * sphi * bz + ct * nsz
    pdf_lam = torch.clamp_min(_dot(nsx, nsy, nsz, dl_x, dl_y, dl_z), 0.0) \
        * (1.0 / math.pi)

    # GGX metal.
    alpha = torch.clamp_min(h["rough"] * h["rough"], 1e-4)
    a2g = alpha * alpha
    cos2h = (1.0 - u1) / (1.0 + (a2g - 1.0) * u1)
    cth = torch.sqrt(torch.clamp_min(cos2h, 0.0))
    sth = torch.sqrt(torch.clamp_min(1.0 - cos2h, 1e-12))
    hwx = sth * cphi * tx + sth * sphi * bx + cth * nsx
    hwy = sth * cphi * ty + sth * sphi * by + cth * nsy
    hwz = sth * cphi * tz + sth * sphi * bz + cth * nsz
    odoth = torch.clamp_min(_dot(wox, woy, woz, hwx, hwy, hwz), 1e-6)
    dm_x = 2.0 * odoth * hwx - wox
    dm_y = 2.0 * odoth * hwy - woy
    dm_z = 2.0 * odoth * hwz - woz
    ndotl_m = _dot(nsx, nsy, nsz, dm_x, dm_y, dm_z)
    ndotv = torch.clamp_min(_dot(nsx, nsy, nsz, wox, woy, woz), 1e-6)
    ndoth = torch.clamp_min(_dot(nsx, nsy, nsz, hwx, hwy, hwz), 1e-6)
    kg = alpha * 0.5
    g1v = ndotv / (ndotv * (1.0 - kg) + kg)
    ndotl_mc = torch.clamp_min(ndotl_m, 1e-6)
    g1l = ndotl_mc / (ndotl_mc * (1.0 - kg) + kg)
    gterm = g1v * g1l
    met_ok = ndotl_m > 1e-6
    f_met_r = _schlick1(odoth, h["ar"])
    f_met_g = _schlick1(odoth, h["ag"])
    f_met_b = _schlick1(odoth, h["ab"])
    w_met_scale = torch.where(met_ok, gterm * odoth / (ndotv * ndoth), 0.0)
    q = ndoth * ndoth * (a2g - 1.0) + 1.0
    dggx = a2g / torch.clamp_min(math.pi * (q * q), 1e-12)
    pdf_met = dggx * ndoth / (4.0 * odoth)

    # Dielectric.
    ior = torch.clamp_min(h["ior"], 1.001)
    eta = torch.where(front, 1.0 / ior, ior)
    cos_i = torch.clamp_min(_dot(wox, woy, woz, nsx, nsy, nsz), 1e-6)
    f_die = _fresnel_dielectric(cos_i, 1.0 / eta)
    dr_x = 2.0 * cos_i * nsx - wox
    dr_y = 2.0 * cos_i * nsy - woy
    dr_z = 2.0 * cos_i * nsz - woz
    sin2_t = eta * eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t >= 1.0
    safe = torch.where(tir, 1.0, 1.0 - sin2_t)
    cos_t = torch.where(tir, 0.0, torch.sqrt(torch.clamp_min(safe, 1e-12)))
    dt_x = eta * (-wox) + (eta * cos_i - cos_t) * nsx
    dt_y = eta * (-woy) + (eta * cos_i - cos_t) * nsy
    dt_z = eta * (-woz) + (eta * cos_i - cos_t) * nsz
    dt_x, dt_y, dt_z = _normalize(dt_x, dt_y, dt_z)
    refl = (u_lobe < f_die) | tir
    dd_x = torch.where(refl, dr_x, dt_x)
    dd_y = torch.where(refl, dr_y, dt_y)
    dd_z = torch.where(refl, dr_z, dt_z)

    nd_x = torch.where(m_lam, dl_x, torch.where(m_met, dm_x, dd_x))
    nd_y = torch.where(m_lam, dl_y, torch.where(m_met, dm_y, dd_y))
    nd_z = torch.where(m_lam, dl_z, torch.where(m_met, dm_z, dd_z))
    w_r = torch.where(m_lam, h["ar"], torch.where(
        m_met, f_met_r * w_met_scale, torch.where(refl, 1.0, h["ar"])))
    w_g = torch.where(m_lam, h["ag"], torch.where(
        m_met, f_met_g * w_met_scale, torch.where(refl, 1.0, h["ag"])))
    w_b2 = torch.where(m_lam, h["ab"], torch.where(
        m_met, f_met_b * w_met_scale, torch.where(refl, 1.0, h["ab"])))
    pdf_new = torch.where(m_lam, pdf_lam, torch.where(m_met, pdf_met, 0.0))
    spec_new = m_die
    dead = m_met & ~met_ok
    off_sign = torch.where(m_die & ~refl, -1.0, 1.0)

    # -- next-event estimation ---------------------------------------------
    if use_nee:
        (pox, poy, poz, ldx, ldy, ldz, t_l, pdf_l, inside_l,
         ler, leg, leb) = nee_shadow_setup(ox, oy, oz, hx, hy, hz, nsx, nsy,
                                           nsz, u, lights, nl, nlf, k)
        blocked = occluded_unrolled(spheres, pox, poy, poz, ldx, ldy, ldz,
                                    t_l - 1e-3)
        lit = ~blocked & ~inside_l & (t_l > TMIN)
        ndotl = torch.clamp_min(_dot(nsx, nsy, nsz, ldx, ldy, ldz), 0.0)
        pdf_b_lam = ndotl * (1.0 / math.pi)
        hsx, hsy, hsz = wox + ldx, woy + ldy, woz + ldz
        hlen2 = hsx * hsx + hsy * hsy + hsz * hsz
        h_ok = hlen2 > 1e-12
        hinv = 1.0 / torch.sqrt(torch.where(h_ok, hlen2, 1.0))
        hhx = torch.where(h_ok, hsx, 0.0) * hinv
        hhy = torch.where(h_ok, hsy, 0.0) * hinv
        hhz = torch.where(h_ok, hsz, 0.0) * hinv
        ndoth_e = torch.clamp_min(_dot(nsx, nsy, nsz, hhx, hhy, hhz), 1e-6)
        odoth_e = torch.clamp_min(_dot(wox, woy, woz, hhx, hhy, hhz), 1e-6)
        qe = ndoth_e * ndoth_e * (a2g - 1.0) + 1.0
        dggx_e = a2g / torch.clamp_min(math.pi * (qe * qe), 1e-12)
        ndotl_c = torch.clamp_min(ndotl, 1e-6)
        g1l_e = ndotl_c / (ndotl_c * (1.0 - kg) + kg)
        g_e = g1v * g1l_e
        fmr = _schlick1(odoth_e, h["ar"])
        fmg = _schlick1(odoth_e, h["ag"])
        fmb = _schlick1(odoth_e, h["ab"])
        spec_e = torch.where(h_ok, dggx_e * g_e / (4.0 * ndotv * ndotl_c),
                             0.0)
        fl = 1.0 / math.pi
        fcos_r = torch.where(m_lam, h["ar"] * fl,
                             torch.where(m_met, fmr * spec_e, 0.0)) * ndotl
        fcos_g = torch.where(m_lam, h["ag"] * fl,
                             torch.where(m_met, fmg * spec_e, 0.0)) * ndotl
        fcos_b = torch.where(m_lam, h["ab"] * fl,
                             torch.where(m_met, fmb * spec_e, 0.0)) * ndotl
        pdf_b_at_l = torch.where(m_lam, pdf_b_lam, torch.where(
            m_met, torch.where(h_ok, dggx_e * ndoth_e / (4.0 * odoth_e), 0.0),
            0.0))
        if use_mis:
            pl2 = pdf_l * pdf_l
            w_nee = pl2 / torch.clamp_min(pl2 + pdf_b_at_l * pdf_b_at_l,
                                          1e-20)
        else:
            w_nee = torch.ones_like(pdf_l)
        scale = w_nee / torch.clamp_min(pdf_l, 1e-12)
        nee_ok = hit & lit & ~spec_new & (pdf_l > 0.0)
        rad_r = torch.where(nee_ok, rad_r + th_r * fcos_r * ler * scale, rad_r)
        rad_g = torch.where(nee_ok, rad_g + th_g * fcos_g * leg * scale, rad_g)
        rad_b = torch.where(nee_ok, rad_b + th_b * fcos_b * leb * scale, rad_b)

    # -- throughput update + Russian roulette ------------------------------
    th_r_n = th_r * w_r
    th_g_n = th_g * w_g
    th_b_n = th_b * w_b2
    active_n = hit & ~dead
    if k >= cfg.rr_depth:
        p_cont = torch.clamp(torch.maximum(th_r_n, torch.maximum(th_g_n,
                                                                 th_b_n)),
                             0.05, 0.95)
        active_n = active_n & ~(u["rr"] > p_cont)
        inv_p = 1.0 / p_cont
        th_r_n = th_r_n * inv_p
        th_g_n = th_g_n * inv_p
        th_b_n = th_b_n * inv_p

    ox = torch.where(active_n, hx + EPS * off_sign * nsx, ox)
    oy = torch.where(active_n, hy + EPS * off_sign * nsy, oy)
    oz = torch.where(active_n, hz + EPS * off_sign * nsz, oz)
    dx = torch.where(active_n, nd_x, dx)
    dy = torch.where(active_n, nd_y, dy)
    dz = torch.where(active_n, nd_z, dz)
    th_r = torch.where(active_n, th_r_n, th_r)
    th_g = torch.where(active_n, th_g_n, th_g)
    th_b = torch.where(active_n, th_b_n, th_b)
    prev_pdf = torch.where(active_n, pdf_new, prev_pdf)
    prev_spec = (active_n & spec_new) | (~active_n & prev_spec)

    new_state = (ox, oy, oz, dx, dy, dz, th_r, th_g, th_b,
                 rad_r, rad_g, rad_b, prev_pdf)
    return new_state, (active_n, prev_spec)
