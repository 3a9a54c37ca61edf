"""The hand-written reverse mode of one bounce: ``trace_bounce_vjp``.

The JAX package differentiates ``trace_bounce`` with ``jax.vjp`` inside its
fused forward+backward kernel (``spt_tpu/kernels/megakernel_grad.py``).  A
CUDA kernel has no autodiff, so the port writes the adjoint by hand, once,
here in plain PyTorch; K2 (``csrc/physics_adj.cuh``) transcribes it term for
term.  It is JAX's ``vjp`` of the same bounce:

* The forward is recomputed from the bounce's entry state
  (``physics.trace_bounce_tape``, which names the intermediates it
  keeps), then run in reverse.
* Discrete choices carry no gradient: the nearest hit, the material lobe,
  reflect or refract (and TIR), the Russian-roulette kill, the light pick
  and its cell, the shadow verdict, the light-cell bounds.  ``p_cont`` is
  detached only for the kill test; ``inv_p = 1/p_cont`` is differentiated.
* ``maximum`` / ``minimum`` / ``clip`` split the cotangent at an exact tie
  (``_dmax``, ``_dclip``), as ``jax.vjp`` does, and the floors and double
  ``where`` guards of the forward bound every local derivative.
* An inactive lane's adjoint is the identity on the state and zero on
  theta.  A branch that ``where`` did not select contributes exactly zero:
  where ``jax.vjp`` meets 0 * inf in such a branch it can give NaN, and
  that NaN is not copied.

Layout as in ``physics``; inside, 3-vectors are (3, N) tensors.  Returns
``theta_ct = (spheres_ct (P, 12), sky_ct (6,), lights_ct (L, 7))`` and the
cotangents of the 13 entry-state channels.
"""

from __future__ import annotations

import math

import torch

from ..core.scene import SKY_CONSTANT, SKY_GRADIENT
from . import physics as P

_FL = 1.0 / math.pi
_TWO_PI = 2.0 * math.pi


def _v(x, y, z):
    return torch.stack((x, y, z))


def _dot3(a, b):
    """Dot product of (3, N) tensors, summed in ``physics._dot``'s order (so
    a tie test on it sees the forward's bits)."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3(a, b):
    return _v(a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
              a[0] * b[1] - a[1] * b[0])


def _dmax(x, c):
    """d maximum(x, c) / dx as JAX takes it: 1 above c, 0.5 at c, 0 below."""
    return torch.where(x > c, 1.0, torch.where(x == c, 0.5, 0.0))


def _dmin(x, c):
    return torch.where(x < c, 1.0, torch.where(x == c, 0.5, 0.0))


def _dclip(x, lo: float, hi: float):
    """d clip(x, lo, hi) / dx, clip = minimum(maximum(x, lo), hi)."""
    return _dmax(x, lo) * _dmin(P._max(x, lo), hi)


def _sqrt_adj(y, y_b):
    """Cotangent of x for y = sqrt(x), as ``jax.vjp`` forms it."""
    return y_b * (0.5 / y)


def _normalize_adj(v, n_b, floor: float | None = 1e-20):
    """Cotangent of v for n = v * rsqrt(max(v.v, floor)); ``floor=None``
    for a plain rsqrt (the caller guards zero lengths)."""
    n2 = _dot3(v, v)
    m = n2 if floor is None else P._max(n2, floor)
    inv = torch.rsqrt(m)
    k = inv / m * _dot3(v, n_b)
    if floor is not None:
        k = k * _dmax(n2, floor)
    return inv * n_b - v * k


def _onb_adj(n, t_b, b_b):
    """Cotangent of n for (t, b) = ``physics._onb(n)``: t = normalize(u x n)
    with u = +z (or +x near the pole), b = n x t."""
    use_z = torch.abs(n[2]) < 0.999
    zero = torch.zeros_like(n[0])
    u = _v(torch.where(use_z, 0.0, 1.0), zero, torch.where(use_z, 1.0, 0.0))
    t_raw = _cross3(u, n)
    t = t_raw * torch.rsqrt(P._max(_dot3(t_raw, t_raw), 1e-20))
    traw_b = _normalize_adj(t_raw, t_b + _cross3(b_b, n))
    return _cross3(t, b_b) + _cross3(traw_b, u)


def _schlick_adj(c, f0, f_b):
    """(f0_b, c_b) for f = f0 + (1 - f0) m^5, m = clip(1 - c, 0, 1); f0 and
    f_b are (3, N), c is (N,)."""
    x = 1.0 - c
    m = P._clip(x, 0.0, 1.0)
    m2 = m * m
    m_b = f_b * (1.0 - f0) * (5.0 * m2 * m2)
    return f_b * (1.0 - m2 * m2 * m), -(m_b[0] + m_b[1] + m_b[2]) \
        * _dclip(x, 0.0, 1.0)


def _g1_adj(x, kg, g_b):
    """(x_b, kg_b) for the Smith-Schlick term g1 = x / (x (1 - kg) + kg)."""
    den = x * (1.0 - kg) + kg
    den2 = den * den
    return g_b * kg / den2, -g_b * x * (1.0 - x) / den2


def _ggx_d_adj(nh, a2g, d_b):
    """(nh_b, a2g_b) for D = a2g / max(pi q^2, 1e-12), q = nh^2 (a2g-1) + 1."""
    q = nh * nh * (a2g - 1.0) + 1.0
    qq = math.pi * (q * q)
    m = P._max(qq, 1e-12)
    q_b = (-d_b * a2g / (m * m)) * _dmax(qq, 1e-12) * (2.0 * math.pi) * q
    return q_b * 2.0 * nh * (a2g - 1.0), d_b / m + q_b * nh * nh


def _cone_adj(r, d2, cosm, deg, pdf_b, cosm_b, nlf: float):
    """(r_b, d2_b) for the sphere-cone pdf 1 / max(2 pi (1 - cosm), 1e-9)
    / nlf, cosm = sqrt(1 - clip(r r / d2, 0, 1)) (0 where the clip reaches
    1), given the pdf's cotangent and a further cotangent of cosm."""
    x = _TWO_PI * (1.0 - cosm)
    m = P._max(x, 1e-9)
    cosm_b = cosm_b + _TWO_PI * (pdf_b / nlf) / (m * m) * _dmax(x, 1e-9)
    sin2_b = torch.where(deg, 0.0, -_sqrt_adj(cosm, cosm_b))
    q = r * r / d2
    q_b = sin2_b * _dclip(q, 0.0, 1.0)
    return 2.0 * r * q_b / d2, -q_b * q / d2


def trace_bounce_vjp(theta, state, aux, u, nl: int, cfg: P.BounceCfg,
                     state_ct, geometry=None):
    """Reverse mode of ``physics.trace_bounce`` at (theta, state, aux, u):
    the cotangent ``state_ct`` of the 13 output channels ->
    ``(theta_ct, state_in_ct)``.

    ``geometry = (intersect_fn, occluded_fn)``, where given, replaces the
    sphere list as in ``trace_bounce``; the winner's row then belongs to
    no table, so ``theta_ct[0]`` is its cotangent per lane, (N, 12) in the
    row's order (cx cy cz r ar ag ab er eg eb rough ior; zero where a lane
    hits nothing), and ``theta[0]`` is not read."""
    with torch.no_grad():
        return _bounce_vjp(theta, state, aux, u, nl, cfg, state_ct,
                           geometry or (None, None))


def _bounce_vjp(theta, state, aux, u, nl, cfg, state_ct, geometry):
    spheres, sky, lights = theta
    _, _, f = P.trace_bounce_tape(theta, state, aux, u, nl, cfg, *geometry)

    o, d, th = _v(*state[0:3]), _v(*state[3:6]), _v(*state[6:9])
    prev_pdf = state[12]
    o_o, d_o, th_o, rad_o = (_v(*state_ct[i:i + 3]) for i in (0, 3, 6, 9))
    pdf_o = state_ct[12]
    active, prev_spec = aux
    hit, miss, an = f.hit, f.miss, f.active_n
    lam, met, die, refl = f.m_lam, f.m_met, f.m_die, f.refl
    rt = die & ~refl                       # refracted through a dielectric
    hd = f.h
    C, r = _v(hd["cx"], hd["cy"], hd["cz"]), hd["r"]
    alb, emi = _v(hd["ar"], hd["ag"], hd["ab"]), _v(hd["er"], hd["eg"],
                                                     hd["eb"])
    h, ns, wo = _v(*f.hp), _v(*f.ns), _v(*f.wo)
    T, B = _v(*f.tb), _v(*f.bb)
    nlf = f.nlf
    z = torch.zeros_like(prev_pdf)
    z3 = torch.zeros_like(o)

    # -- the outputs: set from this hit where the path goes on, else passed
    o_ct = torch.where(an, 0.0, o_o)
    d_ct = torch.where(an, 0.0, d_o)
    th_ct = torch.where(an, 0.0, th_o)
    pdf_ct = torch.where(an, 0.0, pdf_o)
    h_b = torch.where(an, o_o, 0.0)
    ns_b = torch.where(an, (P.EPS * f.off_sign) * o_o, 0.0)
    nd_b = torch.where(an, d_o, 0.0)
    thn_b = torch.where(an, th_o, 0.0)
    pdfn_b = torch.where(an, pdf_o, 0.0)

    # -- throughput update and Russian roulette -----------------------------
    w = _v(*f.w)
    thn = th * w
    if cfg.k >= cfg.rr_depth:
        p = f.p_cont
        p_b = -_dot3(thn_b, thn) / (p * p)
        thn_b = thn_b * f.inv_p
        m1 = torch.maximum(thn[1], thn[2])
        m0_b = p_b * _dclip(torch.maximum(thn[0], m1), 0.05, 0.95)
        m1_b = m0_b * _dmax(m1, thn[0])
        thn_b = thn_b + _v(m0_b * _dmax(thn[0], m1),
                           m1_b * _dmax(thn[1], thn[2]),
                           m1_b * _dmax(thn[2], thn[1]))
    th_ct = th_ct + thn_b * w
    w_b = thn_b * th

    # -- seeds of each material's branch --------------------------------------
    a_b = torch.where(lam | rt, w_b, 0.0)
    f_met = _v(*f.f_met)
    fmet_b = torch.where(met, w_b * f.w_met_scale, 0.0)
    wms_b = torch.where(met & f.met_ok, _dot3(w_b, f_met), 0.0)
    dl_b = torch.where(lam, nd_b, 0.0)
    dm_b = torch.where(met, nd_b, 0.0)
    dr_b = torch.where(die & refl, nd_b, 0.0)
    dt_b = torch.where(rt, nd_b, 0.0)
    T_b, B_b, wo_b, C_b, e_b = z3, z3, z3, z3, z3
    r_b, ior_b, a2g_b, kg_b, g1v_b, ndotv_b = z, z, z, z, z, z
    light_b = None

    # -- next-event estimation ------------------------------------------------
    if f.nee is not None and nl > 0:
        n = f.nee
        fn = n.light
        g = torch.where(n.nee_ok, rad_o, 0.0)
        fcos, le = _v(*n.fcos), _v(*n.le)
        scale, pdf_l, w_nee = n.scale, n.pdf_l, n.w_nee
        th_ct = th_ct + g * fcos * le * scale
        fcos_b = g * th * le * scale
        le_b = g * th * fcos * scale
        scale_b = _dot3(g * th * fcos, le)
        ml = P._max(pdf_l, 1e-12)
        wnee_b = scale_b / ml
        pdfl_b = -scale_b * w_nee / (ml * ml) * _dmax(pdf_l, 1e-12)
        pb, pb_b = n.pdf_b_at_l, z
        if cfg.use_mis:
            s2 = n.pl2 + pb * pb
            den = P._max(s2, 1e-20)
            den_b = -wnee_b * w_nee / den * _dmax(s2, 1e-20)
            pdfl_b = pdfl_b + 2.0 * pdf_l * (wnee_b / den + den_b)
            pb_b = 2.0 * pb * den_b
        ndotl, spec_e = n.ndotl, n.spec_e
        fm = _v(*n.fm)
        base = torch.where(lam, alb * _FL, torch.where(met, fm * spec_e, 0.0))
        base_b = fcos_b * ndotl
        ndotl_b = _dot3(fcos_b, base) + torch.where(lam, pb_b * _FL, 0.0)
        a_b = a_b + torch.where(lam, base_b * _FL, 0.0)
        # GGX at the light direction (metal hits).
        ndoth_e, odoth_e, dggx_e = n.ndoth_e, n.odoth_e, n.dggx_e
        ndotl_c, ndotv = n.ndotl_c, f.ndotv
        mh = met & n.h_ok
        pbm_b = torch.where(mh, pb_b, 0.0)
        spec_b = torch.where(mh, _dot3(base_b, fm), 0.0)
        a_m, odothe_b = _schlick_adj(odoth_e, alb,
                                     torch.where(met, base_b * spec_e, 0.0))
        a_b = a_b + a_m
        dggxe_b = pbm_b * ndoth_e / (4.0 * odoth_e)
        ndothe_b = pbm_b * dggx_e / (4.0 * odoth_e)
        odothe_b = odothe_b - pbm_b * pb / odoth_e
        den = 4.0 * ndotv * ndotl_c
        dggxe_b = dggxe_b + spec_b * n.g_e / den
        ge_b = spec_b * dggx_e / den
        den_b = -spec_b * spec_e / den
        ndotv_b = ndotv_b + den_b * 4.0 * ndotl_c
        g1v_b = g1v_b + ge_b * n.g1l_e
        x_b, k_b = _g1_adj(ndotl_c, f.kg, ge_b * f.g1v)
        kg_b = kg_b + k_b
        ndotl_b = ndotl_b + (den_b * 4.0 * ndotv + x_b) * _dmax(ndotl, 1e-6)
        nh_b, a_b2 = _ggx_d_adj(ndoth_e, f.a2g, dggxe_b)
        a2g_b = a2g_b + a_b2
        hh = _v(*n.hh)
        x = (ndothe_b + nh_b) * _dmax(_dot3(ns, hh), 1e-6)
        y = odothe_b * _dmax(_dot3(wo, hh), 1e-6)
        ns_b = ns_b + hh * x
        hs_b = torch.where(n.h_ok, _normalize_adj(
            _v(*n.hs), ns * x + wo * y, None), 0.0)
        wo_b = wo_b + hh * y + hs_b
        ld = _v(*n.ld)
        x = ndotl_b * _dmax(_dot3(ns, ld), 0.0)
        ns_b = ns_b + ld * x
        ld_b = hs_b + ns * x
        # The cone sample and its pdf, back to the light and the point.
        stl, ctl, cpl, spl = fn.stl, fn.ctl, fn.cpl, fn.spl
        lt, lb, wl = _v(*fn.lt), _v(*fn.lb), _v(*fn.wl)
        stl_b = cpl * _dot3(lt, ld_b) + spl * _dot3(lb, ld_b)
        ctl_b = _dot3(wl, ld_b) - 2.0 * ctl * _sqrt_adj(stl, stl_b) \
            * _dmax(1.0 - ctl * ctl, 1e-12)
        wl_b = ctl * ld_b + _onb_adj(wl, (stl * cpl) * ld_b,
                                     (stl * spl) * ld_b)
        lrr_b, d2_b = _cone_adj(fn.lrr, fn.d2, fn.cosm_l, fn.degm, pdfl_b,
                                ctl_b * fn.lu1, nlf)
        toc, dist = _v(*fn.toc), fn.dist
        d2_b = d2_b + _sqrt_adj(dist, -_dot3(toc, wl_b) / (dist * dist))
        toc_b = wl_b / dist + 2.0 * toc * (d2_b * _dmax(_dot3(toc, toc),
                                                        1e-12))
        h_b = h_b - toc_b                   # toc = light center - (h + EPS ns)
        ns_b = ns_b - P.EPS * toc_b
        light_b = torch.where(n.nee_ok, torch.cat([toc_b, lrr_b[None],
                                                      le_b]), 0.0)

    # -- Lambert: cosine sample and its pdf -----------------------------------
    dl = _v(*f.dl)
    x = torch.where(lam, pdfn_b, 0.0) * _FL * _dmax(_dot3(ns, dl), 0.0)
    dl_b = dl_b + ns * x
    ns_b = ns_b + dl * x + f.ct * dl_b
    T_b = T_b + (f.st * f.cphi) * dl_b
    B_b = B_b + (f.st * f.sphi) * dl_b

    # -- GGX metal: sampled half-vector, weight, pdf --------------------------
    cphi, sphi, kg = f.cphi, f.sphi, f.kg
    odoth, ndotv, ndoth = f.odoth, f.ndotv, f.ndoth
    hw, dm = _v(*f.hw), _v(*f.dm)
    den = ndotv * ndoth
    gterm_b = wms_b * odoth / den
    odoth_b = wms_b * f.gterm / den
    den_b = -wms_b * f.w_met_scale / den
    ndotv_b = ndotv_b + den_b * ndoth
    ndoth_b = den_b * ndotv
    a_m, c_b = _schlick_adj(odoth, alb, fmet_b)
    a_b = a_b + a_m
    pm_b = torch.where(met, pdfn_b, 0.0)
    nh_b, a_b2 = _ggx_d_adj(ndoth, f.a2g, pm_b * ndoth / (4.0 * odoth))
    a2g_b = a2g_b + a_b2
    ndoth_b = ndoth_b + nh_b + pm_b * f.dggx / (4.0 * odoth)
    odoth_b = odoth_b + c_b - pm_b * f.pdf_met / odoth
    g1v_b = g1v_b + gterm_b * f.g1l
    x_b, k_b = _g1_adj(f.ndotl_mc, kg, gterm_b * f.g1v)
    ndotlm_b = x_b * _dmax(f.ndotl_m, 1e-6)
    x_b, k_b2 = _g1_adj(ndotv, kg, g1v_b)
    ndotv_b = ndotv_b + x_b
    kg_b = kg_b + k_b + k_b2
    ns_b = ns_b + dm * ndotlm_b
    dm_b = dm_b + ns * ndotlm_b
    odoth_b = odoth_b + 2.0 * _dot3(hw, dm_b)
    x = ndotv_b * _dmax(_dot3(ns, wo), 1e-6)
    y = ndoth_b * _dmax(_dot3(ns, hw), 1e-6)
    zz = odoth_b * _dmax(_dot3(wo, hw), 1e-6)
    ns_b = ns_b + wo * x + hw * y
    wo_b = wo_b - dm_b + ns * x + hw * zz
    hw_b = (2.0 * odoth) * dm_b + ns * y + wo * zz
    sth, cth, cos2h = f.sth, f.cth, f.cos2h
    sth_b = cphi * _dot3(T, hw_b) + sphi * _dot3(B, hw_b)
    T_b = T_b + (sth * cphi) * hw_b
    B_b = B_b + (sth * sphi) * hw_b
    ns_b = ns_b + cth * hw_b
    cos2h_b = torch.where(cth > 0.0, _sqrt_adj(cth, _dot3(ns, hw_b)), 0.0) \
        * _dmax(cos2h, 0.0) \
        - _sqrt_adj(sth, sth_b) * _dmax(1.0 - cos2h, 1e-12)
    a2g = f.a2g
    a2g_b = a2g_b - cos2h_b * cos2h / (1.0 + (a2g - 1.0) * f.u1) * f.u1
    alpha = f.alpha
    alpha_b = 0.5 * kg_b + 2.0 * alpha * a2g_b
    rough = hd["rough"]
    rough_b = torch.where(met, alpha_b * 2.0 * rough
                          * _dmax(rough * rough, 1e-4), 0.0)

    # -- smooth dielectric: mirror or refracted direction ---------------------
    cos_i, eta, cos_t = f.cos_i, f.eta, f.cos_t
    kk = eta * cos_i - cos_t
    dtr_b = _normalize_adj(eta * (-wo) + kk * ns, dt_b)
    kk_b = _dot3(ns, dtr_b)
    sin2t_b = torch.where(rt, _sqrt_adj(cos_t, kk_b), 0.0) \
        * _dmax(f.safe, 1e-12)
    mm_arg = 1.0 - cos_i * cos_i
    eta_b = -_dot3(wo, dtr_b) + cos_i * kk_b \
        + sin2t_b * P._max(mm_arg, 0.0) * 2.0 * eta
    cosi_b = 2.0 * _dot3(ns, dr_b) + eta * kk_b \
        - 2.0 * cos_i * (sin2t_b * eta * eta) * _dmax(mm_arg, 0.0)
    ior = f.ior
    ior_b = torch.where(rt, torch.where(f.front, -eta_b / (ior * ior),
                                        eta_b), 0.0) * _dmax(hd["ior"], 1.001)
    x = torch.where(die, cosi_b, 0.0) * _dmax(_dot3(wo, ns), 1e-6)
    ns_b = ns_b + (2.0 * cos_i) * dr_b + kk * dtr_b + wo * x
    wo_b = wo_b - dr_b - eta * dtr_b + ns * x

    # -- the shading frame ----------------------------------------------------
    ns_b = ns_b + _onb_adj(ns, T_b, B_b)

    # -- emission, MIS-weighted against the last light sample -----------------
    g = torch.where(f.emitting, rad_o, 0.0)
    w_emit = f.w_emit
    th_ct = th_ct + g * emi * w_emit
    e_b = g * th * w_emit
    if f.mis is not None and nl > 0:
        m = f.mis
        wb_b = torch.where(prev_spec, 0.0, _dot3(g * th, emi))
        pp2, pl = m.pp2, m.pdf_lh
        s2 = pp2 + pl * pl
        den = P._max(s2, 1e-20)
        den_b = -wb_b * m.w_b / den * _dmax(s2, 1e-20)
        pdf_ct = pdf_ct + 2.0 * prev_pdf * (wb_b / den + den_b)
        r_b2, d2_b = _cone_adj(r, m.d2, m.cosm, m.deg,
                               2.0 * pl * den_b, z, nlf)
        r_b = r_b + r_b2
        toc = _v(*m.toc)
        toc_b = 2.0 * toc * (d2_b * _dmax(_dot3(toc, toc), 1e-12))
        C_b = C_b + toc_b
        o_ct = o_ct - toc_b

    # -- normal, hit point, and the winner's distance -------------------------
    v_b = _normalize_adj(h - C, ns_b * f.sgn)
    h_b = h_b + v_b
    C_b = C_b - v_b
    d_ct = d_ct - wo_b
    t = torch.where(hit, f.t, 0.0)
    t_b = torch.where(hit, _dot3(h_b, d), 0.0)
    o_ct = o_ct + torch.where(hit, h_b, 0.0)
    d_ct = d_ct + t * h_b
    oc = C - o
    b = _dot3(d, oc)
    disc = b * b - (_dot3(oc, oc) - r * r)
    sq = torch.sqrt(P._max(disc, 1e-12))
    sgn_sq = torch.where(b - sq > P.TMIN, -1.0, 1.0)
    disc_b = torch.where(hit, _sqrt_adj(sq, sgn_sq * t_b), 0.0) \
        * _dmax(disc, 1e-12)
    b_b = t_b + 2.0 * b * disc_b
    oc_b = -2.0 * oc * disc_b + d * b_b
    r_b = r_b + 2.0 * r * disc_b
    d_ct = d_ct + oc * b_b
    C_b = C_b + oc_b
    o_ct = o_ct - oc_b

    # -- sky, on a miss -------------------------------------------------------
    sky_ct = torch.zeros_like(sky)
    if cfg.sky_mode in (SKY_GRADIENT, SKY_CONSTANT):
        g = torch.where(miss, rad_o, 0.0)
        th_ct = th_ct + g * _v(*f.sk)
        sk_b = g * th
        if cfg.sky_mode == SKY_GRADIENT:
            ts = 0.5 * (d[1] + 1.0)
            sky_ct = torch.cat([(sk_b * (1.0 - ts)).sum(1),
                                (sk_b * ts).sum(1)])
            ts_b = _dot3(sk_b, sky[3:6, None] - sky[0:3, None])
            d_ct = d_ct + _v(z, 0.5 * ts_b, z)
        else:
            sky_ct = torch.cat([sk_b.sum(1), sky.new_zeros(3)])

    # -- theta: the winner's row, the picked light's row, the sky -------------
    row = torch.where(hit, torch.cat([C_b, r_b[None], a_b, e_b, rough_b[None],
                                      ior_b[None]]), 0.0)
    if geometry[0] is None:
        spheres_ct = torch.zeros_like(spheres).index_add_(
            0, f.j_best.long(), row.T)
    else:
        spheres_ct = row.T
    lights_ct = torch.zeros_like(lights)
    if light_b is not None:
        lights_ct.index_add_(0, f.nee.light.li.long(), light_b.T)

    o_ct, d_ct, th_ct = (torch.where(active, a, b) for a, b in
                         ((o_ct, o_o), (d_ct, d_o), (th_ct, th_o)))
    pdf_ct = torch.where(active, pdf_ct, pdf_o)
    return (spheres_ct, sky_ct, lights_ct), (*o_ct, *d_ct, *th_ct, *rad_o,
                                             pdf_ct)


# A padding slot's winner takes K1's row of an invalid sphere: black
# Lambert, ior 1.5 (``megakernel_bvh._resolve``).  The rebuilt-winner
# tables carry it as material ``n_mats``.
_INVALID_ROW = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.5)


def winner_tables(mats, mtypes):
    """The material table (n_mats, 8) and its types with the invalid row
    appended as material ``n_mats``: where K4 records a padding winner."""
    from ..core.materials import LAMBERT
    inv = torch.tensor(_INVALID_ROW, dtype=mats.dtype, device=mats.device)
    return (torch.cat([mats, inv[None]]),
            torch.cat([mtypes.long(), mtypes.new_full((1,), LAMBERT).long()]))


def rebuilt_bounce_vjp(sky, mats, mtypes, lights, res, state, aux, u,
                       nl: int, cfg: P.BounceCfg, state_ct):
    """Reverse mode of a bounce whose nearest hit is a saved winner and
    whose shadow verdict is a saved mask: the plain version of K4's and
    K10's per-lane adjoint.

    ``res`` (8, N): the winner's centre and radius, material id (-1: no
    hit; ``n_mats``: a padding slot, see ``winner_tables``), leaf block,
    slot and the NEE blocked mask, as K6 and K9 record them.  The hit is
    ``wavefront._rebuilt_intersect`` on that record.  Returns ``(sky_ct
    (6,), mats_ct (n_mats, 8), lights_ct (L, 7), dgeo (4, N), state_in_ct)``:
    ``dgeo`` is each lane's cotangent of its winner's centre and radius,
    zero for a padding winner, which no prim owns."""
    from .wavefront import _rebuilt_intersect
    n_mats = mats.shape[0]
    mats_x, mtypes_x = winner_tables(mats, mtypes)
    blocked = res[7] > 0.5
    geometry = (_rebuilt_intersect(mats_x, mtypes_x, res),
                lambda *a: blocked)
    (row, sky_ct, lights_ct), st_ct = trace_bounce_vjp(
        (mats.new_zeros((0, 12)), sky, lights), state, aux, u, nl, cfg,
        state_ct, geometry)
    m = torch.clamp(res[4], 0.0, float(n_mats)).long()
    mats_ct = torch.zeros((n_mats + 1, 8), dtype=row.dtype,
                          device=row.device).index_add_(0, m, row[:, 4:12])
    dgeo = torch.where(res[4] < n_mats, row[:, 0:4].T, 0.0)
    return sky_ct, mats_ct[:n_mats], lights_ct, dgeo, st_ct
