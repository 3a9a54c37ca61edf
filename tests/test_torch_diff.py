"""The port's differentiable render: packing, autograd, Adam.

On the CPU the kernel render (``make_cuda_render_fn``, K1 forward and K2
backward) takes both kernels' plain versions.  Tolerances:

* ``pack_blob_torch`` equals JAX's ``pack_blob_jnp`` bit for bit (the
  scene, sky and sphere rows; test_torch_scene.py holds ``pack_scene``,
  camera included, against JAX's).
* The autograd render against ``render_and_grad`` / spp (the same plain K2):
  rtol 1e-5; against autograd through ``pack_blob_torch`` and the plain K1:
  rtol 1e-4 with an atol of 1e-4 times the field's largest magnitude (float32
  rounding of the hand adjoint, as in test_torch_grad.py).
* Finite differences of the plain render with the same sample ids, Russian
  roulette off: directional derivatives within 1e-2 relative (the repo's
  acceptance notion, BASELINE.md).
* ``InverseRenderer``: the two backends take the same steps within rtol
  1e-4 where Russian roulette never runs, and differ where it runs in one
  of them; 10 steps lower the loss and the albedo error; one Adam step is
  the closed-form update.
"""

import numpy as np
import pytest
import torch

import spt_tpu
import spt_tpu_torch
from spt_tpu.kernels import megakernel as jmega
from spt_tpu_torch.core.convert import params_from_arrays
from spt_tpu_torch.diff import cuda_diff, gradients as G
from spt_tpu_torch.kernels import megakernel as tmega
from spt_tpu_torch.kernels import megakernel_grad as tmg
from test_torch_scene import SCENES, cornell_camera, cornell_scene

# One intra-op thread: these tests trace small tensors, where torch's
# idle OpenMP workers would only spin against the other test processes.
torch.set_num_threads(1)

W = H = 8
KW = dict(max_bounces=3, use_nee=True, use_mis=True, seed=3)


def _cornell():
    return cornell_scene(spt_tpu_torch).compile(device="cpu"), \
        cornell_camera(spt_tpu_torch)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_pack_blob_torch_matches_jax(name):
    build, ckw = SCENES[name]
    sdt = build(spt_tpu_torch).compile(device="cpu", **ckw)
    sdj = build(spt_tpu).compile(**ckw)
    cam = cornell_camera(spt_tpu_torch, aperture=0.1, focus_dist=4.0)
    got = tmega.pack_blob_torch(sdt, cam)
    assert got.dtype == torch.float32
    jblob = jmega.pack_blob_jnp(sdj, cornell_camera(spt_tpu, aperture=0.1,
                                                    focus_dist=4.0))
    np.testing.assert_array_equal(got.numpy()[15:], np.asarray(jblob)[15:])


def test_autograd_render_matches_render_and_grad():
    sd, cam = _cornell()
    spp = 2
    render = cuda_diff.make_cuda_render_fn(sd, cam, W, H, spp=spp,
                                           rr_depth=1, **KW)
    params = {k: v.clone().requires_grad_(True)
              for k, v in G.get_params(sd, cuda_diff.PARAM_KEYS).items()}
    before = dict(tmega.LAUNCHES)
    render(params, 0).sum().backward()
    assert tmega.LAUNCHES == dict(before, plain=before["plain"] + 2)
    img, want = tmg.render_and_grad(sd, cam, W, H, 0, spp, rr_depth=1, **KW)
    for k in cuda_diff.PARAM_KEYS:
        np.testing.assert_allclose(params[k].grad.numpy(),
                                   want[k].numpy() / spp, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    # ... and autograd through the packing and the plain K1 itself.
    p2 = {k: v.clone().requires_grad_(True) for k, v in
          G.get_params(sd, cuda_diff.PARAM_KEYS).items()}
    blob, meta, lsb, static = tmega.pack_uniforms(sd, cam, 0, 3)
    out = tmega.render_tiles_plain(
        tmega.pack_blob_torch(G.apply_params(sd, p2), cam), meta, lsb,
        width=W, height=H, spp=spp, max_bounces=3, rr_depth=1, use_nee=True,
        use_mis=True, sky_mode=sd.sky_mode, dof=False, **static)
    (out * (1.0 / spp)).sum().backward()
    for k in cuda_diff.PARAM_KEYS:
        b = p2[k].grad.numpy()
        np.testing.assert_allclose(params[k].grad.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(), err_msg=k)


@pytest.mark.parametrize("kw,wrapper", [
    (dict(engine="fused"), "megakernel_grad"),
    (dict(engine="wavefront"), "bounce_bwd"),
    (dict(capacity=256), "megakernel_bvh_grad")])
def test_unported_engines_raise(kw, wrapper, monkeypatch):
    """The name is from when these routes raised.  Each now renders one
    sample of Cornell and differentiates it through the engine
    ``make_pallas_render_fn`` routes it to: "fused" keeps a small scene on
    K1/K2, "wavefront" forces the differentiable wavefront (K9/K10), and a
    capacity above 128 takes K3/K4.  The backward wrapper that ran is
    counted."""
    from spt_tpu_torch.kernels import megakernel_bvh_grad, wavefront_grad
    module = {"megakernel_grad": tmg,
              "megakernel_bvh_grad": megakernel_bvh_grad,
              "bounce_bwd": wavefront_grad}[wrapper]
    calls = []
    real = getattr(module, wrapper)
    monkeypatch.setattr(module, wrapper,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    if wrapper == "bounce_bwd":       # _ShadeOp holds the wrapper itself
        monkeypatch.setattr(wavefront_grad, "KERNELS",
                            wavefront_grad.KERNELS[:3] + (module.bounce_bwd,))
    sd = cornell_scene(spt_tpu_torch).compile(
        device="cpu", capacity=kw.pop("capacity", None))
    render = cuda_diff.make_cuda_render_fn(
        sd, cornell_camera(spt_tpu_torch), W, H, spp=1, max_bounces=3, **kw)
    params = {k: v.clone().requires_grad_(True)
              for k, v in G.get_params(sd, cuda_diff.PARAM_KEYS).items()}
    render(params, 0).sum().backward()
    assert calls
    for k, p in params.items():
        assert bool(torch.isfinite(p.grad).all()), k
    assert float(params["albedo"].grad.abs().sum()) > 0


def test_wavefront_split_false_raises():
    from spt_tpu_torch.kernels import wavefront_grad
    sd, cam = _cornell()
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 15"):
        wavefront_grad.make_wavefront_render_fn(sd, cam, W, H, spp=1,
                                                split=False)


def test_inverse_renderer_large_scene_lowers_the_loss():
    """InverseRenderer(backend="cuda") on the 202-sphere scene (K3/K4's
    plain versions here): three Adam steps on albedo and centres from a
    perturbed albedo lower the loss."""
    from chip_smoke import scene_200
    from test_torch_bvh import big_camera
    sd = scene_200(spt_tpu_torch).compile(device="cpu")
    assert sd.capacity > cuda_diff.SMEM_PRIM_CAP
    cam = big_camera(spt_tpu_torch)
    true_p = G.get_params(sd, ("albedo",))
    render = cuda_diff.make_cuda_render_fn(sd, cam, 16, 12, spp=2,
                                           max_bounces=3, seed=3)
    with torch.no_grad():
        target = render(true_p, 0)
    start = G.apply_params(sd, {"albedo": torch.clamp(
        true_p["albedo"] + 0.25, 0.0, 1.0)})
    inv = G.InverseRenderer(start, cam, target, fields=("albedo", "centers"),
                            spp_per_step=2, max_bounces=3, seed=3,
                            learning_rate=0.05, rotate_samples=False)
    before = dict(tmega.LAUNCHES)
    losses = inv.run(3)
    assert tmega.LAUNCHES["plain"] == before["plain"] + 6   # K3, K4 a step
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_unknown_param_key_raises():
    sd, cam = _cornell()
    render = cuda_diff.make_cuda_render_fn(sd, cam, W, H, spp=1)
    with pytest.raises(KeyError, match="ior"):
        render(G.get_params(sd, ("albedo", "ior")), 0)


@pytest.mark.parametrize("key", ["albedo", "emission"])
def test_gradient_matches_finite_differences(key):
    """Russian roulette off (rr_depth > max_bounces): the render is smooth
    in albedo and emission, so central differences are exact but for
    float32 rounding."""
    sd, cam = _cornell()
    render = cuda_diff.make_cuda_render_fn(sd, cam, W, H, spp=2,
                                           rr_depth=10, **KW)
    plain = G.make_render_fn(sd, cam, W, H, rr_depth=10, **KW)
    p = {key: getattr(sd.materials, key).clone().requires_grad_(True)}
    render(p, 0).sum().backward()
    r = np.random.default_rng(1)
    step = torch.from_numpy(r.normal(size=tuple(p[key].shape)).astype(
        np.float32))
    if key == "emission":    # only the lamp: the emitting test is discrete
        step = step * (p[key].detach().sum(-1, keepdim=True) > 0)
    h = 1e-2 if key == "albedo" else 1e-1
    ids = torch.arange(2)
    with torch.no_grad():
        fd = (plain({key: p[key] + h * step}, ids).sum()
              - plain({key: p[key] - h * step}, ids).sum()) / (2 * h)
    got = float((p[key].grad * step).sum())
    assert abs(got - float(fd)) <= 1e-2 * abs(float(fd))


def _inverse(backend, max_bounces=3, **kw):
    sd, cam = _cornell()
    true_p = G.get_params(sd, ("albedo", "roughness"))
    target = G.make_render_fn(sd, cam, W, H, max_bounces=max_bounces,
                              seed=3)(true_p, torch.arange(4)).detach()
    r = np.random.default_rng(0)
    start = params_from_arrays(dict(
        albedo=np.clip(true_p["albedo"].numpy()
                       + r.uniform(-0.2, 0.2, true_p["albedo"].shape),
                       0.0, 1.0)), device="cpu")
    sd0 = G.apply_params(sd, start)
    inv = G.InverseRenderer(sd0, cam, target, spp_per_step=4,
                            max_bounces=max_bounces, seed=3,
                            rotate_samples=False, backend=backend, **kw)
    return inv, true_p


@pytest.mark.parametrize("depth", [3, 4, 5])
def test_inverse_renderer_backends(depth):
    """Russian roulette runs from bounce index 3 in the "cuda" backend and
    never in "plain", as in JAX's "pallas" and "soa" backends.  At depth 3
    it does not run, and at depth 4 it runs only on the last bounce, whose
    outgoing throughput nothing reads: the two renders are one function and
    take the same steps.  From depth 5 they differ."""
    a, _ = _inverse("cuda", max_bounces=depth)
    b, _ = _inverse("plain", max_bounces=depth)
    la, lb = a.run(3), b.run(3)
    if depth == 5:
        assert abs(la[0] - lb[0]) > 1e-3 * lb[0]
        return
    np.testing.assert_allclose(la, lb, rtol=1e-4)
    for k in a.params:
        np.testing.assert_allclose(a.params[k].detach().numpy(),
                                   b.params[k].detach().numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_inverse_renderer_lowers_loss_and_albedo_error():
    inv, true_p = _inverse("cuda", learning_rate=0.05)
    err0 = float((inv.params["albedo"].detach() - true_p["albedo"]).abs()
                 .mean())
    before = dict(tmega.LAUNCHES)
    losses = inv.run(10)
    assert tmega.LAUNCHES["plain"] == before["plain"] + 20   # K1 + K2 a step
    err1 = float((inv.params["albedo"].detach() - true_p["albedo"]).abs()
                 .mean())
    assert all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0]
    assert err1 < err0


def test_one_adam_step_is_the_closed_form_update():
    inv, _ = _inverse("plain", learning_rate=0.02)
    p0 = {k: v.detach().clone() for k, v in inv.params.items()}
    grads = torch.autograd.grad(inv.loss_fn(inv.params, torch.arange(4)),
                                list(inv.params.values()))
    inv.step()
    for (k, v), g in zip(p0.items(), grads):
        # Step 1: bias-corrected moments are g and g^2.
        want = G.clip_params({k: v - 0.02 * g / (g.abs() + 1e-8)})[k]
        np.testing.assert_allclose(inv.params[k].detach().numpy(),
                                   want.numpy(), rtol=1e-6, atol=1e-7)


def test_make_render_fn_takes_any_sample_ids():
    sd, cam = _cornell()
    render = G.make_render_fn(sd, cam, W, H, max_bounces=2, seed=3)
    p = G.get_params(sd)
    a = render(p, torch.tensor([5, 2]))
    b = (render(p, torch.tensor([5])) + render(p, torch.tensor([2]))) / 2
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_plain_work_counts_are_nested():
    """The counts k1_op_count and k2_op_count read: every hit was an active
    ray, every shadow ray left a hit, every lit lane traced a shadow ray."""
    sd, cam = _cornell()
    blob, meta, lsb, static = tmega.pack_uniforms(sd, cam, 0, 3)
    stats = {}
    tmega.render_tiles_plain(blob, meta, lsb, stats=stats, width=W,
                             height=H, spp=2, max_bounces=3, rr_depth=1,
                             use_nee=True, use_mis=True, sky_mode=sd.sky_mode,
                             dof=False, **static)
    assert stats["paths"] == 2 * W * H and stats["active"][0] == 2 * W * H
    for a, h, sh, lit in zip(*(stats[k] for k in ("active", "hit", "shadow",
                                                   "lit"))):
        assert a >= h >= sh >= lit >= 0
    assert sum(stats["lit"]) > 0
