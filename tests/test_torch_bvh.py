"""The port's BVH build, refit and K3 packing against the JAX package's.

Tolerance: none.  Both packages build their trees with the same builders
(the native SAH library, or the numpy median split) from the same float32
arrays, pack them with the same numpy code, and reduce boxes with min/max,
which are exact; every array must be bit-equal.
"""

import numpy as np
import pytest
import torch

import spt_tpu
import spt_tpu_torch
from spt_tpu.core import bvh as jbvh
from spt_tpu.kernels import megakernel_bvh as jmbvh
from spt_tpu.kernels import physics as jphys
from spt_tpu_torch.core import bvh as tbvh
from spt_tpu_torch.core.convert import scene_data_from_arrays
from spt_tpu_torch.kernels import megakernel_bvh as tmbvh
from spt_tpu_torch.kernels import physics as tphys
from chip_smoke import scene_10k, scene_200 as big_scene
from test_torch_scene import (cornell_camera, cornell_scene, jax_scene_arrays,
                              torch_scene_arrays)

# One intra-op thread: these tests trace small tensors, where torch's
# idle OpenMP workers would only spin against the other test processes.
torch.set_num_threads(1)

CPU = "cpu"
_NODE_FIELDS = ("node_min", "node_max", "node_skip", "node_first",
                "node_count", "prim_idx")


def big_camera(pkg, **kw):
    if pkg is spt_tpu_torch:
        kw.setdefault("device", CPU)
    return pkg.Camera.look_at((0, 2.0, -4.0), (0, 1.0, 14.0), fov_degrees=60,
                              **kw)


def _assert_bvh_equal(got, want):
    for f in _NODE_FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.n_nodes, got.max_leaf) == (want.n_nodes, want.max_leaf)


def _arrays(sd):
    return (np.asarray(sd.centers), np.asarray(sd.radii),
            np.asarray(sd.prim_valid))


@pytest.mark.parametrize("force_numpy", [False, True])
def test_build_bvh_bit_equal(force_numpy):
    c, r, v = _arrays(big_scene(spt_tpu).compile())
    for max_leaf in (4, 32):
        want = jbvh.build_bvh(c, r, valid=v, max_leaf=max_leaf,
                              force_numpy=force_numpy)
        got = tbvh.build_bvh(c, r, valid=v, max_leaf=max_leaf,
                             force_numpy=force_numpy)
        _assert_bvh_equal(got, want)
        assert got.builder == ("numpy" if force_numpy else "native")
        assert got.node_min.device.type == "cpu"


def test_build_bvh_empty_scene():
    c = np.zeros((8, 3), np.float32)
    r = np.zeros(8, np.float32)
    v = np.zeros(8, bool)
    got = tbvh.build_bvh(c, r, valid=v)
    _assert_bvh_equal(got, jbvh.build_bvh(c, r, valid=v))
    assert got.builder == "empty"


def test_refit_bvh_bit_equal():
    c, r, v = _arrays(big_scene(spt_tpu).compile())
    want0 = jbvh.build_bvh(c, r, valid=v)
    got0 = tbvh.build_bvh(c, r, valid=v)
    moved = c + np.random.default_rng(3).normal(0, 0.7, c.shape).astype(
        np.float32)
    grown = r * np.float32(1.3)
    want = jbvh.refit_bvh(want0, moved, grown)
    got = tbvh.refit_bvh(got0, torch.from_numpy(moved),
                         torch.from_numpy(grown))
    _assert_bvh_equal(got, want)
    # The moved boxes differ from the built ones: the refit did something.
    assert not torch.equal(got.node_min, got0.node_min)


def test_compile_with_bvh_bit_equal():
    sdj = big_scene(spt_tpu).compile()
    sdt = big_scene(spt_tpu_torch).compile(device=CPU)
    assert sdj.bvh is None and sdt.bvh is None       # 202 <= 512 spheres
    sdj = big_scene(spt_tpu).compile(use_bvh=True)
    sdt = big_scene(spt_tpu_torch).compile(use_bvh=True, device=CPU)
    _assert_bvh_equal(sdt.bvh, sdj.bvh)
    # scene_data_from_arrays carries the node arrays across.
    arrays = jax_scene_arrays(sdj)
    arrays.update({f"bvh.{f}": np.asarray(getattr(sdj.bvh, f))
                   for f in _NODE_FIELDS})
    conv = scene_data_from_arrays(arrays, num_prims=sdj.num_prims,
                                  num_lights=sdj.num_lights,
                                  sky_mode=sdj.sky_mode, device=CPU)
    _assert_bvh_equal(conv.bvh, sdj.bvh)


@pytest.mark.parametrize("name,block", [("big", 32), ("big", 8),
                                        ("cornell", 32)])
def test_pack_bvh_scene_bit_equal(name, block):
    build, cam = ((big_scene, big_camera) if name == "big"
                  else (cornell_scene, cornell_camera))
    sdj = build(spt_tpu).compile()
    sdt = build(spt_tpu_torch).compile(device=CPU)
    cam_j = cam(spt_tpu, aperture=0.2, focus_dist=9.0)
    want = jmbvh.pack_bvh_scene(sdj, cam_j, block)
    got = tmbvh.pack_bvh_scene(sdt, cam_j, block)     # the JAX camera's bits
    for a, b, what in zip(got[:5], want[:5],
                          ("blob", "meta", "nodef8", "nodei8", "prims")):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    for key in ("block_prim_ids", "node_cover", "octant_perm"):
        np.testing.assert_array_equal(got[5][key], want[5][key], err_msg=key)
    for key in ("n_mats", "mtypes", "n_light_slots", "block", "n_nodes",
                "n_blocks", "light_prims"):
        assert got[5][key] == want[5][key], key
    assert got[5]["builder"] == "native"


def test_lsel_bounds_from_prims_bit_equal():
    sdj = big_scene(spt_tpu).compile()
    sdt = big_scene(spt_tpu_torch).compile(device=CPU)
    prims = jmbvh.pack_bvh_scene(sdj, big_camera(spt_tpu))[4]
    want = np.asarray(jphys.lsel_bounds_from_prims(prims))
    got = tphys.lsel_bounds_from_prims(torch.from_numpy(prims))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tphys.lsel_bounds(sdt.centers, sdt.radii,
                                       sdt.prim_valid).numpy())


@pytest.mark.parametrize("name", ["scene_10k", "scene_200"])
def test_chip_smoke_scenes_match_their_sources(name):
    """chip_smoke.py rebuilds bench_suite.py's config-5 scene (cut to 600
    spheres here) and tests/test_pallas_bvh.py's scene without importing
    the JAX package; both compile to the same arrays as the originals."""
    if name == "scene_10k":
        import bench_suite
        want = bench_suite.scene_10k(600).compile()
        got = scene_10k(spt_tpu_torch, 600).compile(device=CPU)
    else:
        import test_pallas_bvh
        want = test_pallas_bvh._big_scene(200).compile()
        got = big_scene(spt_tpu_torch).compile(device=CPU)
    a, b = torch_scene_arrays(got), jax_scene_arrays(want)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (got.num_prims, got.num_lights, got.sky_mode) == \
        (want.num_prims, want.num_lights, want.sky_mode)
