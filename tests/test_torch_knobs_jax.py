"""The port's wavefront knobs against the JAX package's, on the CPU.

* ``_coherence_key`` bit for bit against JAX's at five (qbits, dir_major,
  dbits) settings, on one random stream of one shape (eager JAX compiles
  once a shape), and the same ValueError where the key would pass 31 bits.
* ``_sort_rays(rowsort=True)`` against JAX's: the same rows in the same
  order (``jnp.argsort`` is stable, as the port's sort), the same ids, and
  the same alive prefix in tiles.
* One render with ``sort_every=2, dir_major=False`` against JAX's
  ``render_wavefront(..., interpret=True)`` with the same knobs, at the
  shape and bar of tests/test_torch_wavefront_jax.py: config 5 cut to 300
  spheres, 32x32, 1 spp, depth 3, leaf block 8, every sort run; 97% of
  pixels ``isclose(rtol=2e-3, atol=2e-4)``, means within 1%.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spt_tpu
import spt_tpu_torch
from bench_suite import scene_10k as jax_scene_10k
from spt_tpu.kernels import wavefront as jwf
from spt_tpu_torch.kernels import wavefront as twf
from chip_smoke import CAM_10K, scene_10k

# One intra-op thread: these tests trace small tensors, where torch's
# idle OpenMP workers would only spin against the other test processes.
torch.set_num_threads(1)

N_LANES = 32 * twf.ROW        # four tiles
LO = np.float32([-6.0, -5.0, 1.0])
EXT = np.float32([12.0, 10.0, 58.0])


def _stream(seed=11):
    """A (19, N_LANES) stream buffer as numpy float32: origins in and just
    past the box, unit directions of every octant, a third of the lanes
    dead, some of them out of the image, and distinct ids."""
    r = np.random.default_rng(seed)
    buf = np.zeros((twf.N_CH + twf.N_IDS, N_LANES), np.float32)
    buf[0:3] = (LO[:, None] - 1.0
                + r.random((3, N_LANES)) * (EXT[:, None] + 2.0))
    d = r.normal(size=(3, N_LANES))
    buf[3:6] = d / np.linalg.norm(d, axis=0)
    alive = r.random(N_LANES) > 0.33
    buf[twf.C_ALIVE] = alive
    buf[twf.C_INIMG] = alive | (r.random(N_LANES) > 0.5)
    buf[twf.C_TR:twf.C_TB + 1] = r.random((3, N_LANES))
    ids = np.stack([np.arange(N_LANES), r.integers(0, 4, N_LANES)])
    buf[twf.N_CH:] = ids.astype(np.int32).view(np.float32)
    return buf


def _bounds_jax():
    return tuple(jnp.float32(v) for v in LO), tuple(jnp.float32(v)
                                                    for v in EXT)


def _bounds_torch():
    return (tuple(torch.tensor(v) for v in LO),
            tuple(torch.tensor(v) for v in EXT))


@pytest.mark.parametrize("qbits,dir_major,dbits", [
    (4, True, 0), (4, False, 0), (5, True, 2), (3, False, 2), (6, True, 2)])
def test_coherence_key_matches_jax(qbits, dir_major, dbits):
    buf = _stream()
    want = np.asarray(jwf._coherence_key(jnp.asarray(buf[:twf.N_CH]),
                                         *_bounds_jax(), qbits, dir_major,
                                         dbits))
    got = twf._coherence_key(torch.from_numpy(buf[:twf.N_CH]),
                             *_bounds_torch(), qbits, dir_major, dbits)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    width = twf._live_bits(qbits, dbits if dir_major else 0)
    kinds = np.unique(got.numpy() >> width)
    assert list(kinds) == [0, 1, 2]       # alive, dead, pad lanes all there
    # Both refuse a key wider than 31 bits.
    for pkg in (jwf, twf):
        with pytest.raises(ValueError):
            pkg._live_bits(qbits, 9 - qbits)


def test_rowsort_matches_jax():
    buf = _stream(12)
    buf[twf.C_ALIVE, :8 * twf.ROW] = 0.0        # the first tile dead
    st_j, ids_j, tiles_j = jwf._sort_rays(
        jnp.asarray(buf[:twf.N_CH].reshape(twf.N_CH, -1, twf.ROW)),
        jnp.asarray(buf[twf.N_CH:].view(np.int32).reshape(2, -1, twf.ROW)),
        *_bounds_jax(), 4, True, 0, rowsort=True)
    got = torch.from_numpy(buf.copy())
    tiles = twf._sort_rays(got, N_LANES, *_bounds_torch(), rowsort=True)
    assert tiles == int(tiles_j)
    np.testing.assert_array_equal(
        got[twf.N_CH:].view(torch.int32).numpy(),
        np.asarray(ids_j).reshape(2, -1))
    np.testing.assert_array_equal(
        got[:twf.N_CH].view(torch.int32).numpy(),
        np.asarray(st_j).reshape(twf.N_CH, -1).view(np.int32))
    assert not np.array_equal(got.numpy(), buf)      # rows moved


def test_knob_render_matches_jax():
    knobs = dict(sort_every=2, dir_major=False)
    kw = dict(max_bounces=3, rr_depth=2, use_nee=True, use_mis=True, seed=5,
              block=8, sort_min_rays=0, **knobs)
    want = np.asarray(jwf.render_wavefront(
        jax_scene_10k(300).compile(use_bvh=True),
        spt_tpu.Camera.look_at(**CAM_10K), 32, 32, 0, 1, interpret=True,
        **kw))
    got = twf.render_wavefront(
        scene_10k(spt_tpu_torch, n=300).compile(device="cpu"),
        spt_tpu_torch.Camera.look_at(device="cpu", **CAM_10K), 32, 32, 0, 1,
        **kw).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=2e-3, atol=2e-4).all(axis=-1)
    assert close.mean() >= 0.97, f"{(~close).sum()} px diverge"
    assert abs(got.mean() - want.mean()) <= 0.01 * abs(want.mean())
    assert want.mean() > 0.05
