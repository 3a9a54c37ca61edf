"""The hand-written adjoint of one bounce against torch.autograd.

``physics_adjoint.trace_bounce_vjp`` is the plain version of K2's per-bounce
backward.  Inputs are made with numpy from a seed: 256 lanes, most aimed at
a Lambert, metal or glass sphere of ``test_torch_physics``'s open scene,
some in random directions (misses), a quarter of the glass lanes starting
inside the sphere.  Against ``torch.autograd`` through the port's own
``trace_bounce``: in float64 rtol 1e-9; in float32 rtol 1e-4 with an atol
of 1e-4 times the field's largest magnitude.  The adjoint's formulas are
exact (the float64 case) but associate differently, and a metal lane
amplifies rounding through 0.5 / sin(theta_h) at low roughness.  The
comparisons with JAX are in ``test_torch_grad.py``.
"""

import numpy as np
import pytest
import torch

import spt_tpu_torch
from spt_tpu_torch.kernels import megakernel as tmega
from spt_tpu_torch.kernels import physics as tp
from spt_tpu_torch.kernels.physics_adjoint import trace_bounce_vjp
from test_torch_physics import _open_scene

# One intra-op thread: these tests trace small tensors, where torch's
# idle OpenMP workers would only spin against the other test processes.
torch.set_num_threads(1)

N = 256
SEED = 3
RR_DEPTH = 2
TARGET = {"lambert": 1, "metal": 2, "glass": 3}   # sphere rows of the scene


def _scene_uniforms(scene):
    sd = scene.compile(device="cpu")
    cam = spt_tpu_torch.Camera.look_at((0, 1, -1.5), (0, 1, 3), device="cpu")
    blob, mtypes, lprims = tmega.pack_scene(sd, cam)
    P = sd.capacity
    sph = blob[21:21 + 12 * P].reshape(P, 12)
    lights = np.ascontiguousarray(
        sph[lprims][:, list(tp.LIGHT_TO_SPHERE_ATTR)])
    lsb = tp.lsel_bounds(sd.centers, sd.radii, sd.prim_valid).numpy()
    return dict(sph=sph, sky=blob[15:21], lights=lights, lsb=lsb,
                mtypes=tuple(mtypes), nl=len(lprims))


def _lanes(winner, sky_mode, seed):
    x = _scene_uniforms(_open_scene(spt_tpu_torch, sky_mode))
    r = np.random.default_rng(seed)
    c, rad = x["sph"][TARGET[winner], :3], x["sph"][TARGET[winner], 3]
    o = np.stack([r.uniform(-2, 2, N), r.uniform(0, 2, N), r.uniform(0, 1, N)])
    tgt = c[:, None] + r.normal(size=(3, N)) * 0.45 * rad
    if winner == "glass":
        ins = r.random(N) < 0.25
        o[:, ins] = c[:, None] + r.normal(size=(3, ins.sum())) * 0.2 * rad
        tgt[:, ins] = o[:, ins] + r.normal(size=(3, ins.sum()))
    d = tgt - o
    rnd = r.random(N) < 0.15
    d[:, rnd] = r.normal(size=(3, rnd.sum()))
    d /= np.linalg.norm(d, axis=0)
    th = r.uniform(0.2, 1.0, (3, N))
    rad_in = r.uniform(0.0, 1.0, (3, N))
    prev_pdf = np.where(r.random(N) < 0.2, 0.0, r.uniform(0.0, 2.0, N))
    x.update(
        state=[a.astype(np.float32) for a in (*o, *d, *th, *rad_in, prev_pdf)],
        aux=[r.random(N) < 0.9, r.random(N) < 0.3],
        uni={k: r.random(N).astype(np.float32)
             for k in ("rr", "u1", "u2", "lobe", "lu1", "lu2")},
        sample=r.integers(0, 2**32, N, dtype=np.uint64).astype(np.int64),
        ct=r.normal(size=(13, N)).astype(np.float32))
    return x


def _cfg(pkg, x, k, use_nee, use_mis, sky_mode):
    return pkg.BounceCfg(mtypes=x["mtypes"], k=k, rr_depth=RR_DEPTH,
                         use_nee=use_nee, use_mis=use_mis, sky_mode=sky_mode,
                         n_light_slots=len(x["lights"]))


def _torch_args(x, dtype=torch.float32, grad=False):
    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, requires_grad=grad)
    theta = (t(x["sph"]), t(x["sky"]), t(x["lights"]))
    state = tuple(t(a) for a in x["state"])
    lsb = torch.tensor(x["lsb"], dtype=dtype)
    u = {k: torch.tensor(v, dtype=dtype) for k, v in x["uni"].items()}
    u.update(lsel_lo=tuple(lsb[:3]), lsel_ext=tuple(lsb[3:]),
             sample=torch.from_numpy(x["sample"]), seed=SEED)
    aux = tuple(torch.from_numpy(a) for a in x["aux"])
    ct = tuple(torch.tensor(c, dtype=dtype) for c in x["ct"])
    return theta, state, aux, u, ct


def _autograd(theta, state, aux, u, nl, cfg, ct):
    out, _ = tp.trace_bounce(theta, state, aux, u, nl, cfg)
    leaves = (*theta, *state)
    got = torch.autograd.grad(out, leaves, grad_outputs=ct, allow_unused=True)
    return [torch.zeros_like(a) if g is None else g for g, a in
            zip(got, leaves)]


@pytest.mark.parametrize("sky_mode", [spt_tpu_torch.SKY_NONE,
                                      spt_tpu_torch.SKY_GRADIENT])
@pytest.mark.parametrize("use_nee,use_mis", [(True, True), (True, False),
                                             (False, False)])
@pytest.mark.parametrize("k", [0, RR_DEPTH])
@pytest.mark.parametrize("winner", ["lambert", "metal", "glass"])
def test_vjp_matches_autograd(winner, k, use_nee, use_mis, sky_mode):
    x = _lanes(winner, sky_mode, seed=k + 2 * use_nee + use_mis)
    cfg = _cfg(tp, x, k, use_nee, use_mis, sky_mode)
    theta, state, aux, u, ct = _torch_args(x, grad=True)
    want = _autograd(theta, state, aux, u, x["nl"], cfg, ct)
    th_ct, st_ct = trace_bounce_vjp(
        tuple(a.detach() for a in theta), tuple(a.detach() for a in state),
        aux, u, x["nl"], cfg, ct)
    for i, (a, b) in enumerate(zip((*th_ct, *st_ct), want)):
        b = b.numpy()
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(), err_msg=i)
    # The bounce did work here: lanes hit the winner, and theta got gradient.
    assert (th_ct[0][TARGET[winner]] != 0).any()


@pytest.mark.parametrize("winner", ["lambert", "metal", "glass"])
def test_vjp_matches_autograd_float64(winner):
    x = _lanes(winner, spt_tpu_torch.SKY_GRADIENT, seed=11)
    cfg = _cfg(tp, x, RR_DEPTH, True, True, spt_tpu_torch.SKY_GRADIENT)
    theta, state, aux, u, ct = _torch_args(x, torch.float64, grad=True)
    want = _autograd(theta, state, aux, u, x["nl"], cfg, ct)
    th_ct, st_ct = trace_bounce_vjp(
        tuple(a.detach() for a in theta), tuple(a.detach() for a in state),
        aux, u, x["nl"], cfg, ct)
    for i, (a, b) in enumerate(zip((*th_ct, *st_ct), want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=i)


def test_inactive_lanes_pass_the_cotangent_through():
    x = _lanes("lambert", spt_tpu_torch.SKY_GRADIENT, seed=5)
    x["aux"][0][:] = False
    cfg = _cfg(tp, x, 0, True, True, spt_tpu_torch.SKY_GRADIENT)
    theta, state, aux, u, ct = _torch_args(x)
    th_ct, st_ct = trace_bounce_vjp(theta, state, aux, u, x["nl"], cfg, ct)
    assert all(float(t.abs().sum()) == 0.0 for t in th_ct)
    for a, b in zip(st_ct, ct):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scene", ["cornell", "grad_scene"])
@pytest.mark.parametrize("k", [0, 3])
def test_recorded_replay_equals_the_sweep(scene, k):
    """K2's replay (``megakernel_grad.recorded_geometry``): each lane's hit
    rebuilt from the sphere and shadow verdict its forward recorded gives
    the sphere-list sweep's state cotangents and theta cotangent bit for
    bit, at bounce 0 and with Russian roulette (k = 3)."""
    import chip_smoke as cs
    from spt_tpu_torch.kernels import megakernel_grad as tmg
    sd = getattr(cs, scene)(spt_tpu_torch).compile(device="cpu")
    cam = spt_tpu_torch.Camera.look_at((0, 1.0, -1.2), (0, 0.8, 4.0),
                                       device="cpu")
    blob, meta, lsb, static = tmega.pack_uniforms(sd, cam, 0, SEED)
    lanes = cs.vjp_lanes(torch, "cpu", 512, 20 + k)
    kw = dict(k=k, rr_depth=3, use_nee=True, use_mis=True,
              sky_mode=sd.sky_mode, **static)
    g_sweep, ct_sweep = tmg.bounce_vjp_plain(blob, meta, lsb, *lanes, **kw)
    g_rec, ct_rec = tmg.bounce_vjp_recorded_plain(blob, meta, lsb, *lanes,
                                                  **kw)
    sc, cfg, u = tmg._plain_bounce(blob, meta, lsb, lanes[2], lanes[3],
                                   **kw)
    ids, blocked = tmg.record_bounce(sc.theta, tuple(lanes[0]),
                                     tuple(lanes[1]), u, sc.nl, cfg)
    # lanes hit (and, under grad_scene's sky, miss) and are blocked, and
    # the cotangents are not zero
    assert (ids >= 0).any() and blocked.any()
    assert (ids < 0).any() or scene == "cornell"
    assert float(g_sweep.abs().sum()) > 0
    assert torch.equal(g_rec, g_sweep) and torch.equal(ct_rec, ct_sweep)
