"""The port's ``core.sampling`` and ``core.intersect`` against the JAX
package's, on the same seeded inputs (256 lanes, as the other JAX-side
cases).

Tolerance: rtol 2e-6, atol 2e-6 on floating-point outputs (torch's and
XLA's CPU sin, cos, sqrt and rsqrt may round a few ulp apart; JAX's rsqrt
is not 1/sqrt, ROADMAP.md §3), and masks and hit ids equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spt_tpu.core import intersect as ji
from spt_tpu.core import sampling as js
from spt_tpu_torch.core import intersect as ti
from spt_tpu_torch.core import sampling as ts

torch.set_num_threads(1)

N = 256
RTOL = ATOL = 2e-6


def _inputs(seed=5):
    r = np.random.default_rng(seed)

    def unit(n):
        v = r.normal(size=(n, 3)).astype(np.float32)
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
            np.float32)
    n = unit(N)
    n[:4] = [[0, 0, 1], [0, 0, -1], [0.0, 0.99999, 0.00447], [1, 0, 0]]
    d = unit(N)
    d[4:8] = -n[4:8]                  # wi = -wo: no half vector
    return dict(
        n=n, d=d, wo=unit(N), u1=r.uniform(0, 1, N).astype(np.float32),
        u2=r.uniform(0, 1, N).astype(np.float32),
        rough=r.uniform(0.0, 1.0, N).astype(np.float32),
        cos=r.uniform(-0.2, 1.2, N).astype(np.float32),
        p=r.uniform(-3, 3, (N, 3)).astype(np.float32),
        center=r.uniform(-3, 3, (N, 3)).astype(np.float32),
        radius=r.uniform(0.1, 2.0, N).astype(np.float32),
        pdf_b=r.uniform(0, 3, N).astype(np.float32))


# name -> f(pkg module, arrays as that framework's tensors)
CASES = {
    "dot": lambda m, a: m.dot(a["n"], a["d"]),
    "normalize": lambda m, a: m.normalize(a["p"]),
    "cross": lambda m, a: m.cross(a["n"], a["d"]),
    "reflect": lambda m, a: m.reflect(a["d"], a["n"]),
    "refract": lambda m, a: m.refract(a["d"], a["n"], 1.0 / 1.5),
    "refract_tir": lambda m, a: m.refract(a["d"], a["n"], 1.5),
    "build_onb_reference": lambda m, a: m.build_onb_reference(a["n"]),
    "cosine_hemisphere": lambda m, a: m.cosine_hemisphere(a["n"], a["u1"],
                                                          a["u2"]),
    "cosine_hemisphere_pdf": lambda m, a: m.cosine_hemisphere_pdf(a["n"],
                                                                  a["d"]),
    "ggx_sample_half": lambda m, a: m.ggx_sample_half(a["n"], a["rough"],
                                                      a["u1"], a["u2"]),
    "ggx_ndf": lambda m, a: m.ggx_ndf(a["n"], a["d"], a["rough"]),
    "ggx_g1": lambda m, a: m.ggx_g1(a["n"], a["d"], a["rough"]),
    "ggx_smith_g": lambda m, a: m.ggx_smith_g(a["n"], a["wo"], a["d"],
                                              a["rough"]),
    "half_vector": lambda m, a: m.half_vector(a["wo"], a["d"]),
    "ggx_pdf_from_half": lambda m, a: m.ggx_pdf_from_half(
        a["n"], a["wo"], a["d"], a["rough"]),
    "ggx_pdf": lambda m, a: m.ggx_pdf(a["n"], a["wo"], a["d"], a["rough"]),
    "schlick_fresnel": lambda m, a: m.schlick_fresnel(a["cos"][:, None],
                                                      a["n"] * 0.5 + 0.5),
    "fresnel_dielectric": lambda m, a: m.fresnel_dielectric(a["cos"], 1.5),
    "fresnel_dielectric_inv": lambda m, a: m.fresnel_dielectric(a["cos"],
                                                                1 / 1.5),
    "sample_sphere_cone": lambda m, a: m.sample_sphere_cone(
        a["p"], a["center"], a["radius"], a["u1"], a["u2"]),
    "sphere_cone_pdf": lambda m, a: m.sphere_cone_pdf(a["p"], a["center"],
                                                      a["radius"]),
    "power_heuristic": lambda m, a: m.power_heuristic(a["u1"] * 4,
                                                      a["pdf_b"]),
}


def _flat(out):
    return list(out) if isinstance(out, tuple) else [out]


def _same(got, want):
    for g, w in zip(_flat(got), _flat(want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == np.bool_:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sampling_matches_jax(name):
    a = _inputs()
    got = CASES[name](ts, {k: torch.from_numpy(v) for k, v in a.items()})
    want = CASES[name](js, {k: jnp.asarray(v) for k, v in a.items()})
    _same(got, want)


def _rays_and_spheres(seed=6, p=16):
    r = np.random.default_rng(seed)
    o = r.uniform(-4, 4, (N, 3)).astype(np.float32)
    o[:, 2] -= 8.0
    d = r.normal(size=(N, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.7
    c = r.uniform(-4, 4, (p, 3)).astype(np.float32)
    rad = r.uniform(0.3, 1.5, p).astype(np.float32)
    valid = np.ones(p, bool)
    valid[-3:] = False
    tmax = r.uniform(2.0, 14.0, N).astype(np.float32)
    return o, d, c, rad, valid, tmax


@pytest.mark.parametrize("name", ["intersect_spheres", "intersect_spheres_mxu",
                                  "occluded", "sphere_normal",
                                  "_quadratic_t"])
def test_intersect_matches_jax(name):
    arrays = _rays_and_spheres()
    tt = [torch.from_numpy(x) for x in arrays]
    jj = [jnp.asarray(x) for x in arrays]
    if name == "occluded":
        got = ti.occluded(*tt[:5], tt[5])
        want = ji.occluded(*jj[:5], jj[5])
        assert 0 < int(got.sum()) < N
    elif name == "sphere_normal":
        got = ti.sphere_normal(tt[0], tt[2][:1])
        want = ji.sphere_normal(jj[0], jj[2][:1])
    elif name == "_quadratic_t":
        b, a, c = (tt[5] - 8.0, tt[5] * 0 + 1.0, tt[5] - 5.0)
        got = ti._quadratic_t(b, a, c, ti.TMIN)
        want = ji._quadratic_t(*(jnp.asarray(x.numpy()) for x in (b, a, c)),
                               ji.TMIN)
    else:
        got = getattr(ti, name)(*tt[:5])
        want = getattr(ji, name)(*jj[:5])
        assert got[1].dtype == torch.int32
        assert 0 < int((got[1] >= 0).sum()) < N
        assert (got[1] >= 0).numpy()[~np.isfinite(np.asarray(want[0]))] \
            .sum() == 0
        got = (torch.where(got[1] >= 0, got[0], 0.0), got[1])
        want = (jnp.where(want[1] >= 0, want[0], 0.0), want[1])
    _same(got, want)


@pytest.mark.parametrize("sky", ["gradient", "constant", "envmap", "none"])
def test_sample_sky_matches_jax(sky):
    """``engine.integrator.sample_sky`` (and ``sample_env_map``, the
    bilinear equirectangular lookup) against JAX's on 256 directions."""
    import spt_tpu
    import spt_tpu_torch
    from spt_tpu.engine import integrator_jax as jint
    from spt_tpu_torch.engine import integrator as tint
    env = np.random.default_rng(8).uniform(0, 3, (6, 10, 3)).astype(
        np.float32)
    sds = []
    for pkg in (spt_tpu, spt_tpu_torch):
        scene = pkg.Scene()
        scene.create_sphere("s", (0, 0, 5), 1.0)
        if sky == "envmap":
            scene.set_environment_map(env)
        else:
            mode = dict(gradient=pkg.SKY_GRADIENT, constant=pkg.SKY_CONSTANT,
                        none=pkg.SKY_NONE)[sky]
            scene.set_sky(mode, horizon=(0.9, 0.8, 0.7), zenith=(0.2, 0.4, 1))
        sds.append(scene.compile(**({} if pkg is spt_tpu
                                    else {"device": "cpu"})))
    d = _inputs()["d"]
    d[:2] = [[0, 1, 0], [0, -1, 0]]      # the poles
    got = tint.sample_sky(torch.from_numpy(d), sds[1])
    want = jint.sample_sky(jnp.asarray(d), sds[0])
    _same(got, want)
