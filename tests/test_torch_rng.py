"""The port's RNG against the JAX package's: the bits must be equal exactly.

Inputs are numpy-seeded uint32 tuples, including 0 and 2**32-1 in every
position; tolerance: none (bit equality).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spt_tpu.core import rng as jrng
from spt_tpu_torch.core import rng as trng

# One intra-op thread: these tests trace small tensors, where torch's
# idle OpenMP workers would only spin against the other test processes.
torch.set_num_threads(1)

N = 4096
SEEDS = [0, 1, 3, 7, 42, 12345, 2**31 - 1, 2**31, 2**32 - 1]


def _tuples(seed):
    r = np.random.default_rng(seed)
    cols = [r.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
            for _ in range(4)]
    for c in cols:   # the extremes in every position
        c[:4] = [0, 2**32 - 1, 0, 2**32 - 1]
    cols[0][:2], cols[1][2:4] = [0, 0], [2**32 - 1, 0]
    return cols


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def _u32(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_counter_bits_exact(seed):
    pix, sample, dim, _ = _tuples(seed)
    want = np.asarray(jrng.counter_bits(jnp.asarray(pix), jnp.asarray(sample),
                                        jnp.asarray(dim), np.uint32(seed)))
    got = _u32(trng.counter_bits(_t(pix), _t(sample), _t(dim), seed))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_counter_bits_per_lane_seed_exact(seed):
    pix, sample, dim, seeds = _tuples(seed + 100)
    want = np.asarray(jrng.counter_bits(*(jnp.asarray(a) for a in
                                          (pix, sample, dim, seeds))))
    got = _u32(trng.counter_bits(_t(pix), _t(sample), _t(dim), _t(seeds)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_counter_uniform_exact(seed):
    pix, sample, dim, _ = _tuples(seed)
    want = np.asarray(jrng.counter_uniform(
        jnp.asarray(pix), jnp.asarray(sample), jnp.asarray(dim),
        np.uint32(seed)))
    got = trng.counter_uniform(_t(pix), _t(sample), _t(dim), seed).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_hash_u32_exact(seed):
    x = _tuples(seed)[0]
    np.testing.assert_array_equal(_u32(trng.hash_u32(_t(x))),
                                  np.asarray(jrng.hash_u32(jnp.asarray(x))))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_ref_rng_chain_exact(seed):
    x, y, frame, _ = _tuples(seed)
    width = 640
    sj = jrng.ref_seed(jnp.asarray(x), jnp.asarray(y), width,
                       jnp.asarray(frame))
    st = trng.ref_seed(_t(x), _t(y), width, _t(frame))
    np.testing.assert_array_equal(_u32(st), np.asarray(sj))
    for _ in range(4):
        sj, uj = jrng.ref_next(sj)
        st, ut = trng.ref_next(st)
        np.testing.assert_array_equal(_u32(st), np.asarray(sj))
        np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))


def test_int32_bits_roundtrip():
    x = _t(_tuples(5)[0])
    bits = trng.to_int32_bits(x)
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), _u32(x))
    np.testing.assert_array_equal(trng.as_u32(bits).numpy(), x.numpy())
