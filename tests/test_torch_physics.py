"""One bounce of the port's plain physics against ``spt_tpu`` physics.

Both get the same numpy-seeded state, uniforms and scene uniforms; the JAX
side is plain jnp (not jitted).  Tolerance: every state channel allclose
(rtol 1e-4, atol 1e-5) and both masks equal on at least 99.5% of lanes —
sin/cos/sqrt may differ by an ulp between the frameworks, and a lane on a
knife edge (an RR or Fresnel draw next to its threshold) may then branch
the other way.  The light-cell keys and uniforms are integer streams and
must be equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spt_tpu
import spt_tpu_torch
from spt_tpu.kernels import megakernel as jmega
from spt_tpu.kernels import physics as jp
from spt_tpu_torch.kernels import megakernel as tmega
from spt_tpu_torch.kernels import physics as tp

N = 1024
SEED = 3
RR_DEPTH = 3
RTOL, ATOL, MIN_CLOSE = 1e-4, 1e-5, 0.995


def _open_scene(pkg, sky_mode):
    """Every material, two lights, and open sky so rays both hit and miss."""
    s = pkg.Scene()
    s.set_sky(sky_mode, horizon=(0.9, 0.9, 1.0), zenith=(0.3, 0.5, 1.0))
    diff = s.add_material("lambert", albedo=(0.7, 0.6, 0.5))
    metal = s.add_material("metal", albedo=(0.9, 0.8, 0.6), roughness=0.3)
    glass = s.add_material("glass", albedo=(0.95, 0.97, 1.0), ior=1.5)
    lamp = s.add_material("lambert", albedo=(0.8,) * 3, emission=(8.0,) * 3)
    warm = s.add_material("lambert", albedo=(0.5,) * 3,
                          emission=(4.0, 3.0, 2.0))
    for name, pos, r, m in [
            ("ground", (0, -101, 3), 100.0, diff),
            ("ball", (-1.2, 0.0, 3.0), 0.6, diff),
            ("mirror", (0.0, 0.0, 3.5), 0.5, metal),
            ("glass", (1.2, 0.0, 3.0), 0.5, glass),
            ("lamp", (0.0, 2.5, 3.0), 0.5, lamp),
            ("warm", (-2.0, 1.5, 4.0), 0.3, warm)]:
        s.create_sphere(name, pos, r, m)
    return s


def _inputs(sky_mode, seed=0):
    sdj = _open_scene(spt_tpu, sky_mode).compile()
    cam = spt_tpu.Camera.look_at((0, 1, -1.5), (0, 1, 3))
    blob, mtypes, lprims = jmega.pack_scene(sdj, cam)
    P = sdj.capacity
    sph = blob[21:21 + 12 * P].reshape(P, 12)
    lights = sph[lprims][:, list(jp.LIGHT_TO_SPHERE_ATTR)]
    lsb = np.asarray(jp.lsel_bounds(sdj.centers, sdj.radii, sdj.prim_valid))

    r = np.random.default_rng(seed)
    o = np.stack([r.uniform(-2.5, 2.5, N), r.uniform(-0.5, 2.5, N),
                  r.uniform(0.5, 5.0, N)])
    d = r.normal(size=(3, N))
    d /= np.linalg.norm(d, axis=0)
    th = r.uniform(0.2, 1.0, (3, N))
    rad = r.uniform(0.0, 1.0, (3, N))
    prev_pdf = np.where(r.random(N) < 0.2, 0.0, r.uniform(0.0, 2.0, N))
    state = [a.astype(np.float32) for a in (*o, *d, *th, *rad, prev_pdf)]
    aux = [r.random(N) < 0.9, r.random(N) < 0.3]
    uni = {k: r.random(N).astype(np.float32)
           for k in ("rr", "u1", "u2", "lobe", "lu1", "lu2")}
    sample = r.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    return dict(sph=sph, sky=blob[15:21], lights=lights, lsb=lsb,
                mtypes=tuple(mtypes), nl=len(lprims), state=state, aux=aux,
                uni=uni, sample=sample)


def _jax_args(x):
    f = jnp.float32
    theta = (tuple(tuple(f(v) for v in row) for row in x["sph"]),
             tuple(f(v) for v in x["sky"]),
             tuple(tuple(f(v) for v in row) for row in x["lights"]))
    u = {k: jnp.asarray(v) for k, v in x["uni"].items()}
    u.update(lsel_lo=tuple(f(v) for v in x["lsb"][:3]),
             lsel_ext=tuple(f(v) for v in x["lsb"][3:]),
             sample=jnp.asarray(x["sample"]), seed=jnp.uint32(SEED))
    return (theta, tuple(jnp.asarray(a) for a in x["state"]),
            tuple(jnp.asarray(a) for a in x["aux"]), u)


def _torch_args(x):
    theta = (torch.from_numpy(x["sph"].copy()), torch.from_numpy(x["sky"].copy()),
             torch.from_numpy(np.ascontiguousarray(x["lights"])))
    lsb = torch.from_numpy(x["lsb"].copy())
    u = {k: torch.from_numpy(v) for k, v in x["uni"].items()}
    u.update(lsel_lo=tuple(lsb[:3]), lsel_ext=tuple(lsb[3:]),
             sample=torch.from_numpy(x["sample"].astype(np.int64)), seed=SEED)
    return (theta, tuple(torch.from_numpy(a) for a in x["state"]),
            tuple(torch.from_numpy(a) for a in x["aux"]), u)


def _lane_close(got, want):
    return np.isclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("sky_mode", [spt_tpu.SKY_GRADIENT, spt_tpu.SKY_NONE])
@pytest.mark.parametrize("use_nee,use_mis", [(True, True), (True, False),
                                             (False, False)])
@pytest.mark.parametrize("k", [0, RR_DEPTH])
def test_trace_bounce_matches_jax(k, use_nee, use_mis, sky_mode):
    x = _inputs(sky_mode, seed=10 * k + 2 * use_nee + use_mis + sky_mode)
    kw = dict(mtypes=x["mtypes"], k=k, rr_depth=RR_DEPTH, use_nee=use_nee,
              use_mis=use_mis, sky_mode=sky_mode,
              n_light_slots=len(x["lights"]))
    theta, state, aux, u = _jax_args(x)
    sj, aj = jp.trace_bounce(theta, state, aux, u, jnp.int32(x["nl"]),
                             jp.BounceCfg(**kw))
    theta, state, aux, u = _torch_args(x)
    st, at = tp.trace_bounce(theta, state, aux, u, x["nl"],
                             tp.BounceCfg(**kw))
    ok = np.ones(N, bool)
    for c, (a, b) in enumerate(zip(st, sj)):
        close = _lane_close(a.numpy(), np.asarray(b))
        assert close.mean() >= MIN_CLOSE, f"state channel {c}"
        ok &= close
    for m, (a, b) in enumerate(zip(at, aj)):
        assert (a.numpy() == np.asarray(b)).mean() >= MIN_CLOSE, f"mask {m}"
        ok &= a.numpy() == np.asarray(b)
    assert ok.mean() >= MIN_CLOSE
    # The bounce did real work: some lanes hit, some gained radiance.
    assert at[0].any() and (st[9] != state[9]).any()


@pytest.mark.parametrize("tmax", [None, 3.0])
def test_intersect_winner_matches_jax(tmax):
    x = _inputs(spt_tpu.SKY_GRADIENT, seed=7)
    theta_j, state_j, _, _ = _jax_args(x)
    theta_t, state_t, _, _ = _torch_args(x)
    tj, hj, lam_j, met_j, die_j, jb_j = jp.intersect_spheres_unrolled(
        theta_j[0], x["mtypes"], *state_j[:6], tmax=tmax)
    tt, ht, lam_t, met_t, die_t, jb_t = tp.intersect_spheres_unrolled(
        theta_t[0], x["mtypes"], *state_t[:6], tmax=tmax)
    np.testing.assert_array_equal(jb_t.numpy(), np.asarray(jb_j))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-6)
    for key in hj:
        np.testing.assert_array_equal(ht[key].numpy(), np.asarray(hj[key]))
    for a, b in ((lam_t, lam_j), (met_t, met_j), (die_t, die_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    occ_j = jp.occluded_unrolled(theta_j[0], *state_j[:6], jnp.float32(2.0))
    occ_t = tp.occluded_unrolled(theta_t[0], *state_t[:6], 2.0)
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))


@pytest.mark.parametrize("k", [0, 2])
def test_light_cell_uniform_exact(k):
    x = _inputs(spt_tpu.SKY_NONE, seed=11)
    _, state_j, _, u_j = _jax_args(x)
    _, state_t, _, u_t = _torch_args(x)
    want = np.asarray(jp.lsel_uniform(*state_j[:3], u_j, k))
    got = tp.lsel_uniform(*state_t[:3], u_t, k).numpy()
    np.testing.assert_array_equal(got, want)
    cells = tp.lsel_cell(*state_t[:3], u_t["lsel_lo"], u_t["lsel_ext"])
    assert len(np.unique(cells.numpy())) > 1


def test_nee_shadow_setup_matches_jax():
    x = _inputs(spt_tpu.SKY_NONE, seed=13)
    theta_j, state_j, _, u_j = _jax_args(x)
    theta_t, state_t, _, u_t = _torch_args(x)
    n = state_t[3:6]    # any unit vectors serve as shading normals
    out_j = jp.nee_shadow_setup(*state_j[:3], *state_j[:3], *state_j[3:6],
                                u_j, theta_j[2], jnp.int32(x["nl"]),
                                jnp.float32(x["nl"]), 1)
    out_t = tp.nee_shadow_setup(*state_t[:3], *state_t[:3], *n, u_t,
                                theta_t[2], x["nl"], float(x["nl"]), 1)
    for i, (a, b) in enumerate(zip(out_t, out_j)):
        close = _lane_close(a.numpy(), np.asarray(b))
        assert close.mean() >= MIN_CLOSE, f"output {i}"


@pytest.mark.parametrize("mode", [spt_tpu.SKY_NONE, spt_tpu.SKY_GRADIENT,
                                  spt_tpu.SKY_CONSTANT])
def test_sky_radiance_matches_jax(mode):
    x = _inputs(mode, seed=17)
    sky_j = tuple(jnp.float32(v) for v in x["sky"])
    d = [torch.from_numpy(a) for a in x["state"][3:6]]
    got = tp.sky_radiance(torch.from_numpy(x["sky"].copy()), *d, mode)
    want = jp.sky_radiance(sky_j, *(jnp.asarray(a) for a in x["state"][3:6]),
                           mode)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_plain_render_counts_segments():
    """The plain version's per-bounce counters: active >= hit, falling."""
    sd = _open_scene(spt_tpu_torch, spt_tpu.SKY_GRADIENT).compile(device="cpu")
    cam = spt_tpu_torch.Camera.look_at((0, 1, -1.5), (0, 1, 3), device="cpu")
    blob, meta, lsb, static = tmega.pack_uniforms(sd, cam, 0, SEED)
    stats = {}
    img = tmega.render_tiles_plain(
        blob, meta, lsb, width=8, height=8, spp=2, max_bounces=3,
        rr_depth=1, use_nee=True, use_mis=True, sky_mode=sd.sky_mode,
        dof=False, stats=stats, **static)
    assert img.shape == (8, 8, 3) and torch.isfinite(img).all()
    assert stats["active"][0] == 2 * 64
    assert all(a >= h for a, h in zip(stats["active"], stats["hit"]))
    assert stats["active"] == sorted(stats["active"], reverse=True)
