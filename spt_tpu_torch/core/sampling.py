"""Sampling math: orthonormal bases, cosine-hemisphere, GGX, light sampling.

The port of ``spt_tpu/core/sampling.py`` as torch functions on tensors:
the same formulas, each broadcasting over leading batch axes, on the
tensors' device.  So that the card and the CPU give the same bits, every
operation here rounds as IEEE float32 does on both: a vec3's components
are summed left to right in separate ops (``_sum3``; a reduction kernel
may associate otherwise, and a fused kernel such as ``linalg.cross`` may
contract a multiply-add), and sin and cos are taken in float64 and rounded
once (``_cos``, ``_sin``; the float32 libraries of the two devices part by
an ulp).  The cosine-hemisphere routine is the reference
renderer's formulation (cos t = sqrt(u1), sin t = sqrt(1 - u1), phi =
2 pi u2, an ONB from a z-up-else-x-up pick), so reference-parity renders
take the same directions from the same uniforms.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    """A 0-d tensor of ``value`` on ``like``'s device and dtype: ``where``,
    ``maximum`` and divisions take it as JAX takes a weak scalar."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.maximum(x, _full(x, c))


def _sum3(v):
    """(..., 3) -> (..., 1): the components summed left to right."""
    return (v[..., 0:1] + v[..., 1:2]) + v[..., 2:3]


def _cos(x):
    """cos of float32 ``x`` taken in float64, rounded once."""
    return torch.cos(x.double()).to(x.dtype)


def _sin(x):
    """sin of float32 ``x`` taken in float64, rounded once."""
    return torch.sin(x.double()).to(x.dtype)


def dot(a, b):
    """Batched vec3 dot product over the trailing axis, keepdims."""
    return _sum3(a * b)


def normalize(v, eps=1e-20):
    return v * torch.reciprocal(torch.sqrt(_maximum(_sum3(v * v), eps)))


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def reflect(d, n):
    """Mirror reflection of direction ``d`` about normal ``n``."""
    return d - 2.0 * dot(d, n) * n


def refract(d, n, eta):
    """Refract ``d`` through normal ``n`` with relative IOR ``eta`` (n_i/n_t).

    Returns (refracted_dir, total_internal_reflection_mask).  ``d`` points
    into the surface; ``n`` points against ``d``.
    """
    cos_i = -dot(d, n)
    sin2_t = eta * eta * _maximum(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t >= 1.0
    # Double-where: sqrt'(0) = inf at the TIR boundary would NaN the
    # backward pass even though TIR lanes select the reflection branch.
    safe = torch.where(tir, _full(sin2_t, 1.0), 1.0 - sin2_t)
    cos_t = torch.where(tir, _full(safe, 0.0),
                        torch.sqrt(_maximum(safe, 1e-12)))
    refr = eta * d + (eta * cos_i - cos_t) * n
    return refr, tir[..., 0]


def build_onb_reference(n):
    """ONB about normal ``n`` with the reference's up-vector pick.

    up = +z unless |n.z| >= 0.999, else +x; tangent = normalize(up x n);
    bitangent = n x tangent.
    """
    nz = n[..., 2:3]
    up_z = torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype,
                        device=n.device).expand(n.shape)
    up_x = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype,
                        device=n.device).expand(n.shape)
    up = torch.where(torch.abs(nz) < 0.999, up_z, up_x)
    tangent = normalize(cross(up, n))
    bitangent = cross(n, tangent)
    return tangent, bitangent


def cosine_hemisphere(n, u1, u2):
    """Cosine-weighted direction about normal ``n`` (reference formulation).

    u1, u2 have shape n.shape[:-1]; returns unit directions, pdf = cos/pi.
    """
    u1 = u1[..., None]
    u2 = u2[..., None]
    cos_t = torch.sqrt(u1)
    sin_t = torch.sqrt(_maximum(1.0 - u1, 0.0))
    phi = TWO_PI * u2
    x = sin_t * _cos(phi)
    y = sin_t * _sin(phi)
    tangent, bitangent = build_onb_reference(n)
    return x * tangent + y * bitangent + cos_t * n


def cosine_hemisphere_pdf(n, d):
    """pdf of cosine-hemisphere sampling: max(n.d, 0)/pi."""
    return _maximum(dot(n, d)[..., 0], 0.0) * INV_PI


# ---------------------------------------------------------------------------
# GGX (Trowbridge-Reitz) microfacet distribution, isotropic.
# ---------------------------------------------------------------------------


def ggx_sample_half(n, roughness, u1, u2):
    """Sample a microfacet half-vector from the GGX NDF about ``n``.

    NDF sampling: tan^2 t = alpha^2 u / (1 - u).  roughness is perceptual
    (alpha = roughness^2), the Disney convention.
    """
    alpha = _maximum(roughness * roughness, 1e-4)[..., None]
    u1 = u1[..., None]
    u2 = u2[..., None]
    phi = TWO_PI * u2
    cos2 = (1.0 - u1) / (1.0 + (alpha * alpha - 1.0) * u1)
    cos_t = torch.sqrt(_maximum(cos2, 0.0))
    # 1e-12 floor: sqrt'(0) at u1==0 would poison roughness gradients.
    sin_t = torch.sqrt(_maximum(1.0 - cos2, 1e-12))
    hx = sin_t * _cos(phi)
    hy = sin_t * _sin(phi)
    tangent, bitangent = build_onb_reference(n)
    return hx * tangent + hy * bitangent + cos_t * n


def ggx_ndf(n, h, roughness):
    """GGX normal distribution function D(h)."""
    alpha = _maximum(roughness * roughness, 1e-4)
    a2 = alpha * alpha
    ndoth = _maximum(dot(n, h)[..., 0], 0.0)
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    return a2 / _maximum(math.pi * denom * denom, 1e-12)


def ggx_g1(n, v, roughness):
    """Smith masking term G1 (Schlick-GGX form)."""
    alpha = _maximum(roughness * roughness, 1e-4)
    k = alpha * 0.5
    ndotv = _maximum(dot(n, v)[..., 0], 1e-6)
    return ndotv / (ndotv * (1.0 - k) + k)


def ggx_smith_g(n, wo, wi, roughness):
    return ggx_g1(n, wo, roughness) * ggx_g1(n, wi, roughness)


def half_vector(wo, wi, eps=1e-12):
    """Gradient-safe normalize(wo + wi).

    Returns (h, ok); when wi ~ -wo the half vector is undefined: ok is
    False and h is a placeholder whose gradient is fully masked (double
    where), so eval results must be gated on ok.
    """
    s = wo + wi
    len2 = _sum3(s * s)
    ok = len2[..., 0] > eps
    safe = torch.where(ok[..., None], len2, _full(len2, 1.0))
    h = torch.where(ok[..., None], s, torch.zeros_like(s)) \
        * torch.rsqrt(safe)
    return h, ok


def ggx_pdf_from_half(n, wo, h, roughness):
    """pdf of NDF-sampled GGX reflection given the half vector:
    D(h)(n.h)/(4(wo.h))."""
    d = ggx_ndf(n, h, roughness)
    ndoth = _maximum(dot(n, h)[..., 0], 0.0)
    odoth = _maximum(dot(wo, h)[..., 0], 1e-6)
    return d * ndoth / (4.0 * odoth)


def ggx_pdf(n, wo, wi, roughness):
    """pdf of NDF-sampled GGX reflection in solid angle:
    D(h)(n.h)/(4(wo.h))."""
    h, ok = half_vector(wo, wi)
    pdf = ggx_pdf_from_half(n, wo, h, roughness)
    return torch.where(ok, pdf, _full(pdf, 0.0))


def schlick_fresnel(cos_i, f0):
    """Schlick approximation; f0 broadcastable to cos_i[..., None]*3."""
    m = torch.clamp(1.0 - cos_i, 0.0, 1.0)
    return f0 + (1.0 - f0) * (m * m) * (m * m) * m


def fresnel_dielectric(cos_i, eta):
    """Exact unpolarized dielectric Fresnel reflectance (scalar eta=n_t/n_i)."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = (1.0 / (eta * eta)) * _maximum(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t >= 1.0
    # Double-where for the sqrt at grazing/TIR (see refract).
    safe = torch.where(tir, _full(sin2_t, 1.0), 1.0 - sin2_t)
    cos_t = torch.where(tir, _full(safe, 0.0),
                        torch.sqrt(_maximum(safe, 1e-12)))
    rs = (cos_i - eta * cos_t) / _maximum(cos_i + eta * cos_t, 1e-8)
    rp = (eta * cos_i - cos_t) / _maximum(eta * cos_i + cos_t, 1e-8)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(tir, _full(f, 1.0), f)


# ---------------------------------------------------------------------------
# Light (sphere) sampling for next-event estimation.
# ---------------------------------------------------------------------------


def _cos_max(sin2_max):
    """cos of the cone's half angle; double-where: on or inside the sphere
    sin2_max == 1 and sqrt'(0) = inf would NaN the backward pass of these
    (masked) lanes."""
    deg = sin2_max >= 1.0
    return torch.where(deg, _full(sin2_max, 0.0), torch.sqrt(
        torch.where(deg, _full(sin2_max, 1.0), 1.0 - sin2_max)))


def sample_sphere_cone(p, center, radius, u1, u2):
    """Sample a direction toward sphere (center, radius) from point ``p``
    uniformly within the subtended cone.

    Returns (dir, pdf_solid_angle, inside_mask).  When ``p`` is inside the
    sphere the cone is the full sphere; callers should mask those lanes.
    """
    to_c = center - p
    d2 = _sum3(to_c * to_c)
    dist = torch.sqrt(_maximum(d2, 1e-20))
    inside = dist[..., 0] <= radius
    sin2_max = torch.clamp((radius * radius)[..., None]
                           / _maximum(d2, 1e-12), 0.0, 1.0)
    cos_max = _cos_max(sin2_max)
    u1 = u1[..., None]
    u2 = u2[..., None]
    cos_t = 1.0 - u1 * (1.0 - cos_max)
    sin_t = torch.sqrt(_maximum(1.0 - cos_t * cos_t, 1e-12))
    phi = TWO_PI * u2
    w = to_c / _maximum(dist, 1e-12)
    tangent, bitangent = build_onb_reference(w)
    direction = (sin_t * _cos(phi)) * tangent \
        + (sin_t * _sin(phi)) * bitangent + cos_t * w
    pdf = 1.0 / _maximum(TWO_PI * (1.0 - cos_max[..., 0]), 1e-9)
    return direction, pdf, inside


def sphere_cone_pdf(p, center, radius):
    """Solid-angle pdf of cone sampling (uniform within the cone, so
    direction-independent) for directions that hit the sphere."""
    to_c = center - p
    d2 = _sum3(to_c * to_c)[..., 0]
    sin2_max = torch.clamp(radius * radius / _maximum(d2, 1e-12), 0.0, 1.0)
    cos_max = _cos_max(sin2_max)
    return 1.0 / _maximum(TWO_PI * (1.0 - cos_max), 1e-9)


def power_heuristic(pdf_a, pdf_b):
    """MIS power heuristic (beta = 2) weight for strategy a."""
    a2 = pdf_a * pdf_a
    return a2 / _maximum(a2 + pdf_b * pdf_b, 1e-20)
