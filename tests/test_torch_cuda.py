"""The port's CUDA kernels on the card; every test here skips without one.

Imports neither jax nor the JAX package, so it runs on a GPU machine that
has neither.  There, from the repo root (the suite's conftest imports jax):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: the RNG bits are equal exactly; K1 against its plain version is
held to chip_smoke.py's bar (99.9% of pixels isclose(rtol=2e-3,
atol=2e-4), means within 0.1%).
"""

import numpy as np
import pytest
import torch

import spt_tpu_torch as T
from chip_smoke import ATOL, MAX_MEAN_REL, MIN_CLOSE, RTOL, cornell
from spt_tpu_torch.core import rng
from spt_tpu_torch.kernels import megakernel as mk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_counter_bits_kernel_exact(cuda):
    r = np.random.default_rng(0)
    args = [torch.from_numpy(r.integers(0, 2**32, 1 << 16, dtype=np.uint64)
                             .astype(np.int64)).to(cuda) for _ in range(4)]
    assert torch.equal(mk.counter_bits_cuda(*args), rng.counter_bits(*args))


@pytest.mark.parametrize("case", ["cornell", "demo38", "thin_lens"])
def test_k1_matches_plain(cuda, case):
    if case == "demo38":
        sd = T.demo_scene_38_spheres().compile(capacity=64, device=cuda)
        cam = T.Camera.look_at((0, 0, 0), (0, 0, 1), fov_degrees=90,
                               device=cuda)
    else:
        sd = cornell(T).compile(device=cuda)
        lens = dict(aperture=0.15, focus_dist=4.5) if case == "thin_lens" \
            else {}
        cam = T.Camera.look_at((0, 1.0, -1.5), (0, 1.0, 3.0),
                               fov_degrees=55, device=cuda, **lens)
    blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 7, 3)
    kw = dict(width=48, height=32, spp=4, max_bounces=8, rr_depth=3,
              use_nee=True, use_mis=True, sky_mode=sd.sky_mode,
              dof=case == "thin_lens", **static)
    got = mk.megakernel_fwd(blob, meta, lsb, **kw).cpu().numpy()
    want = mk.render_tiles_plain(blob, meta, lsb, **kw).cpu().numpy()
    assert np.isfinite(got).all() and want.mean() > 0.01
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(axis=-1)
    assert close.mean() >= MIN_CLOSE
    assert abs(got.mean() - want.mean()) <= MAX_MEAN_REL * want.mean()


def test_facade_launches_k1(cuda):
    tr = T.create_path_tracer("cuda")
    assert tr.device.type == "cuda"
    tr.set_scene(cornell(T))
    s = T.RenderSettings()
    s.set_resolution(32, 24)
    tr.set_settings(s)
    before = dict(mk.LAUNCHES)
    tr.render()
    tr.render()
    img = tr.get_render_result().image_f32
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    assert mk.LAUNCHES == dict(before, k1=before["k1"] + 2)


def test_k1_rejects_what_it_cannot_take(cuda):
    sd = cornell(T).compile(device=cuda)
    cam = T.Camera.look_at((0, 1, -1.5), (0, 1, 3), device=cuda)
    blob, meta, lsb, static = mk.pack_uniforms(sd, cam, 0, 3)
    kw = dict(width=8, height=8, spp=1, max_bounces=2, rr_depth=1,
              use_nee=True, use_mis=True, sky_mode=sd.sky_mode, dof=False)
    with pytest.raises(ValueError):
        mk.megakernel_fwd(blob.double(), meta, lsb, **kw, **static)
    with pytest.raises(ValueError):
        mk.megakernel_fwd(blob, meta, lsb.cpu(), **kw, **static)
    with pytest.raises(ValueError):
        mk.megakernel_fwd(blob, meta, lsb, **kw, n_prims=256,
                          n_light_slots=1)
