"""Batched ray-sphere intersection as torch ops.

The port of ``spt_tpu/core/intersect.py``: every ray of a batch against
every sphere at once, in a (rays x spheres) broadcast, with the compact
``oc = c - o`` form of the quadratic (a = |d|^2, b = d.oc, c = |oc|^2 -
r^2), each vec3 sum left to right in separate ops (``sampling._sum3``), so
the card and the CPU give the same bits.  The expanded form ``intersect_spheres_mxu`` (two (T,3)x(3,P)
matmuls) loses bits to cancellation when coordinates are large against
hit distances and is kept for parity with the JAX package.

Convention: directions need not be unit length (``a = |d|^2`` is kept), a
hit distance must satisfy t > tmin (the reference's tnear = 1e-3), missing
rays get hit_id = -1 and t = inf.
"""

from __future__ import annotations

import math

import torch

from .sampling import _full, _sum3

TMIN = 1e-3  # the reference renderer's tnear


def _quadratic_t(b, a, c, tmin):
    """Smallest valid root of a t^2 - 2b t + c = 0 (ray-sphere form).

    Returns (t, valid).  Gradient-safe at disc == 0 via double-where.
    """
    disc = b * b - a * c
    pos = disc > 0.0
    # 1e-12 floor bounds the grazing-incidence gradient.
    sq = torch.where(pos, torch.sqrt(torch.maximum(
        torch.where(pos, disc, _full(disc, 1.0)), _full(disc, 1e-12))),
        _full(disc, 0.0))
    inv_a = torch.reciprocal(a)
    t0 = (b - sq) * inv_a
    t1 = (b + sq) * inv_a
    t = torch.where(t0 > tmin, t0, t1)
    return t, pos & (t > tmin)


def _nearest(t, hit):
    """(t_best, hit_id) over the last axis of a (..., T, P) grid."""
    t = torch.where(hit, t, _full(t, math.inf))
    t_best = torch.amin(t, dim=-1)
    hit_id = torch.argmin(t, dim=-1).to(torch.int32)   # first of equals
    hit_id = torch.where(torch.isfinite(t_best), hit_id,
                         torch.full((), -1, dtype=torch.int32,
                                    device=t.device))
    return t_best, hit_id


def intersect_spheres(o, d, centers, radii, valid, tmin=TMIN, tmax=math.inf):
    """Nearest hit of a ray batch against a sphere set.

    Args:
      o, d: (..., T, 3) ray origins / directions.
      centers: (P, 3); radii: (P,); valid: (P,) bool padding mask.
    Returns:
      t: (..., T) hit distance (inf on miss)
      hit_id: (..., T) int32 primitive index (-1 on miss; the lowest index
      among equal nearest distances)
    """
    oc = centers - o[..., None, :]                        # (T, P, 3)
    a = _sum3(d * d)                                      # (T, 1)
    b = _sum3(d[..., None, :] * oc)[..., 0]               # (T, P)
    c = _sum3(oc * oc)[..., 0] - radii * radii            # (T, P)
    t, ok = _quadratic_t(b, a, c, tmin)
    return _nearest(t, ok & (t < tmax) & valid)


def intersect_spheres_mxu(o, d, centers, radii, valid, tmin=TMIN,
                          tmax=math.inf):
    """Expanded-form variant whose inner products are (T,3)x(3,P) matmuls;
    same contract as ``intersect_spheres``.  Without re-centering the
    coordinates first it flips grazing hits when |coords|^2 >> r^2."""
    d_dot_c = torch.matmul(d, centers.T)
    o_dot_c = torch.matmul(o, centers.T)
    a = torch.sum(d * d, dim=-1, keepdim=True)
    o2 = torch.sum(o * o, dim=-1, keepdim=True)
    c2r2 = torch.sum(centers * centers, dim=-1) - radii * radii
    b = d_dot_c - torch.sum(d * o, dim=-1, keepdim=True)
    c = o2 - 2.0 * o_dot_c + c2r2
    t, ok = _quadratic_t(b, a, c, tmin)
    return _nearest(t, ok & (t < tmax) & valid)


def occluded(o, d, centers, radii, valid, tmax, tmin=TMIN):
    """Any-hit (shadow ray) test: True where something blocks (tmin, tmax).

    Same quadratic as intersect_spheres but an any-reduce in place of the
    nearest.  ``tmax``: (..., T).
    """
    oc = centers - o[..., None, :]
    a = _sum3(d * d)
    b = _sum3(d[..., None, :] * oc)[..., 0]
    c = _sum3(oc * oc)[..., 0] - radii * radii
    t, ok = _quadratic_t(b, a, c, tmin)
    blocked = ok & (t < tmax[..., None]) & valid
    return torch.any(blocked, dim=-1)


def sphere_normal(p, center):
    """Outward geometric normal of a sphere at surface point ``p``:
    (p - center) / |p - center|."""
    n = p - center
    return n * torch.reciprocal(torch.sqrt(torch.maximum(
        _sum3(n * n), _full(n, 1e-20))))
