"""``parallel.sharding``'s five renders and the kernels' bands on the CPU.

One spawned group of two gloo ranks (``tools/dist_worker.launch``) runs
every sharded case once; the tests read its reports.  Three scenes, one a
route of the facade's (``engine.cuda_backend.render_route``): the
four-sphere scene of tests/test_sharding.py (K1), config 5 cut to 300
spheres (capacity 512: K3) and the same under an environment map (the
wavefront); 24x24, 2 spp, depth 3, the plain versions of the kernels.

* Every render equals the unsharded route on the same samples bit for
  bit: the bands key each lane on its global pixel id and take the full
  image's camera, a chunk of the wavefront holds the full image's samples,
  and the SUM of two partial images adds two floats, alike in either
  order.  The ring may part from it only at a lane whose nearest hits on
  two shards lie at the same distance (none in these scenes).
* ``"auto"`` takes the gather within its budget and the ring with a
  budget of 0 bytes.
* Without processes: the bands of K1, K3 and the wavefront (their plain
  versions) equal the same rows of the full render bit for bit, from row
  offsets that are not multiples of the regen batch's 4 rows; a bad
  strategy, sample ids that are not consecutive, ``render_megasample``'s
  ``jitter`` and a height the mesh does not divide each raise.
"""

import numpy as np
import pytest
import torch

import spt_tpu_torch as T
from chip_smoke import CAM_10K, env_gradient, scene_10k
from spt_tpu_torch.engine.cuda_backend import render_route
from spt_tpu_torch.kernels import megakernel as tmega
from spt_tpu_torch.kernels import megakernel_bvh as tmb
from spt_tpu_torch.kernels import wavefront as twf
from spt_tpu_torch.parallel import mesh as M
from spt_tpu_torch.parallel import sharding as S
from spt_tpu_torch.tools import dist_worker

# One intra-op thread: these tests trace small tensors, where torch's
# idle OpenMP workers would only spin against the other test processes.
torch.set_num_threads(1)

CPU = "cpu"
W = H = 24
SPP = 2
KW = dict(max_bounces=3, rr_depth=2, seed=11)
# Seconds the spawned group may take, start to end (about 4 here).
GROUP_TIMEOUT = 240.0
RENDERS = {"pixel": dict(data=2, prim=1), "sample": dict(data=2, prim=1),
           "prim_gather": dict(data=1, prim=2),
           "prim_ring": dict(data=1, prim=2),
           "prim_auto": dict(data=1, prim=2)}
SCENES = ("s4", "s300", "s300env")


def small_scene(pkg):
    """tests/test_sharding.py's scene: a floor, two balls and a lamp."""
    scene = pkg.Scene()
    scene.set_sky(pkg.SKY_NONE)
    white = scene.add_material("lambert", albedo=(0.7, 0.7, 0.7))
    red = scene.add_material("lambert", albedo=(0.6, 0.1, 0.1))
    lamp = scene.add_material("lambert", albedo=(0.8,) * 3,
                              emission=(10.0,) * 3)
    metal = scene.add_material("metal", albedo=(0.8, 0.8, 0.9),
                               roughness=0.3)
    scene.create_sphere("floor", (0, -1000, 4), 1000.0, white)
    scene.create_sphere("ball", (-0.7, 0.6, 4.0), 0.6, red)
    scene.create_sphere("mball", (0.8, 0.5, 4.3), 0.5, metal)
    scene.create_sphere("lamp", (0.0, 2.8, 4.0), 0.7, lamp)
    return scene


SMALL_CAM = dict(position=(0, 1.0, -1.0), target=(0, 0.8, 4.0),
                 fov_degrees=55)


def _scenes():
    env = scene_10k(T, n=300)
    env.set_environment_map(env_gradient(16, 32))
    cam10 = T.Camera.look_at(device=CPU, **CAM_10K)
    return {"s4": (small_scene(T).compile(device=CPU),
                   T.Camera.look_at(device=CPU, **SMALL_CAM)),
            "s300": (scene_10k(T, n=300).compile(device=CPU), cam10),
            "s300env": (env.compile(device=CPU), cam10)}


@pytest.fixture(scope="module")
def group():
    """Every render on every scene, and "auto" with no budget, run once on
    one spawned group of two gloo ranks: label -> rank 0's report; and the
    scenes."""
    scenes = _scenes()
    cases = {f"{sc}_{r}": dict(case=r, scene=sc, **mesh)
             for sc in SCENES for r, mesh in RENDERS.items()}
    cases["s300_auto_ring"] = dict(case="prim_auto", scene="s300", data=1,
                                   prim=2)
    for label, c in cases.items():
        c.update(width=W, height=H, spp=SPP, kw=dict(KW))
    cases["s300_auto_ring"]["kw"]["transient_budget"] = 0
    reports = dist_worker.launch(list(cases.values()), 2, scenes=scenes,
                                 backend="gloo", device=CPU,
                                 timeout=GROUP_TIMEOUT)
    return dict(zip(cases, reports)), scenes


def _unsharded(scenes, label):
    sd, cam = scenes[label]
    return render_route(sd)(sd, cam, W, H, 0, SPP, **KW).numpy()


@pytest.mark.parametrize("render", list(RENDERS))
@pytest.mark.parametrize("scene", SCENES)
def test_sharded_render_matches_unsharded(group, scene, render):
    reports, scenes = group
    rep = reports[f"{scene}_{render}"]
    want = _unsharded(scenes, scene)
    got = rep["image"]
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    assert want.mean() > 0.05
    assert rep["backend"] == "gloo" and len(rep["walls_s"]) == 2
    differ = set(np.flatnonzero((got != want).any(-1)).tolist())
    if render == "prim_ring":
        assert differ <= set(rep["tie_pixels"])
    else:
        np.testing.assert_array_equal(got, want)
    if render == "prim_auto":
        assert rep["strategy"] == ["gather", "gather"]
    # One collective a rank for pixel and sample, two for the gather (the
    # table, the image); the ring's ranks make the same ones: a count of
    # the alive rays and two hand-ons a bounce, then the image.
    if render == "prim_ring":
        n = rep["collectives"]
        assert n[0] == n[1] <= 1 + 3 * KW["max_bounces"] and n[0] >= 4
    else:
        assert rep["collectives"] == [1 if render in ("pixel", "sample")
                                      else 2] * 2
    assert rep["launches"]["plain"] > 0
    assert not any(rep["glue_calls"].values())


def test_auto_takes_the_ring_without_budget(group):
    reports, scenes = group
    rep = reports["s300_auto_ring"]
    assert rep["strategy"] == ["ring", "ring"]
    np.testing.assert_array_equal(rep["image"], reports["s300_prim_ring"]
                                  ["image"])
    sd, cam = scenes["s300"]
    assert 0 < S.gather_transient_bytes(sd, cam, 2) <= \
        S.GATHER_TRANSIENT_BUDGET


BANDS = ((5, 7), (13, 9), (2, 20))


@pytest.mark.parametrize("offset,rows", BANDS)
@pytest.mark.parametrize("route", ["k1", "k3", "wavefront"])
def test_band_equals_rows_of_the_full_render(route, offset, rows):
    w, h = 20, 22
    if route == "k1":
        sd, cam = small_scene(T).compile(device=CPU), T.Camera.look_at(
            device=CPU, **SMALL_CAM)
        fn = tmega.render_tiles
    else:
        sd = scene_10k(T, n=300).compile(device=CPU)
        cam = T.Camera.look_at(device=CPU, **CAM_10K)
        fn = tmb.render_tiles_bvh if route == "k3" else twf.render_wavefront
    extra = {} if route == "k1" else dict(block=8)
    full = fn(sd, cam, w, h, 3, SPP, **KW, **extra)
    band = fn(sd, cam, w, rows, 3, SPP, row_offset=offset, full_height=h,
              **KW, **extra)
    assert float(full.mean()) > 0.05
    assert torch.equal(band, full[offset:offset + rows])


def test_bad_arguments_raise():
    mesh = M.RenderMesh(data=1, prim=1, data_idx=0, prim_idx=0,
                        data_group=None, prim_group=None,
                        device=torch.device(CPU), backend="gloo")
    sd = small_scene(T).compile(device=CPU)
    cam = T.Camera.look_at(device=CPU, **SMALL_CAM)
    with pytest.raises(ValueError, match="strategy"):
        S.render_prim_sharded(sd, cam, 8, 8, [0], mesh, strategy="allgather")
    for fn in (S.render_pixel_sharded, S.render_prim_sharded_gather,
               S.render_prim_sharded_ring):
        with pytest.raises(ValueError, match="consecutive"):
            fn(sd, cam, 8, 8, [0, 2], mesh)
        with pytest.raises(TypeError, match="jitter"):
            fn(sd, cam, 8, 8, [0, 1], mesh, jitter=False)
    with pytest.raises(TypeError, match="unroll"):
        S.render_sample_sharded(sd, cam, 8, 8, 1, mesh, unroll=True)
    two = M.RenderMesh(data=2, prim=1, data_idx=0, prim_idx=0,
                       data_group=None, prim_group=None,
                       device=torch.device(CPU), backend="gloo")
    with pytest.raises(ValueError, match="divisible"):
        S.render_pixel_sharded(sd, cam, 8, 7, [0], two)
    with pytest.raises(ValueError, match="do not lie"):
        tmega.render_tiles(sd, cam, 8, 4, 0, 1, row_offset=6, full_height=8)
