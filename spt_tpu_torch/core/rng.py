"""Counter-based and reference RNG, as plain PyTorch integer ops.

The same integer pipelines as ``spt_tpu.core.rng`` (and as the CUDA header
``csrc/rng.cuh``), so every backend draws bit-identical streams:

* ``counter_*`` — the stateless hash keyed on (pixel, sample,
  bounce*8+dim, seed) that every sampling site uses;
* ``ref_*`` — the reference renderer's stateful per-pixel PCG-style RNG.

uint32 values travel as int64 tensors holding 0..2**32-1: PyTorch on the CPU
cannot add or shift ``torch.uint32``, so each step computes in int64 and
masks with ``0xFFFFFFFF``.  Products are split into 16-bit halves so no
intermediate leaves the int64 range.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF

_REF_SEED_PRIME = 982451653
_LCG_MUL = 747796405
_LCG_INC = 2891336453
_PCG_MUL = 277803737
_H_MUL1 = 0x9E3779B9  # golden-ratio Weyl constant
_H_MUL2 = 0x85EBCA6B  # murmur3 finalizer constant
_H_MUL3 = 0xC2B2AE35  # murmur3 finalizer constant

# The reference divides by the f32 rounding of 4294967295.0f (exactly 2**32).
_INV_U32_MAX = float(np.float32(np.float32(1.0) / np.float32(4294967295.0)))
_INV_2_24 = float(np.float32(1.0 / (1 << 24)))


def as_u32(x) -> torch.Tensor:
    """Any integer tensor/array/int -> int64 tensor of its uint32 value."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, np.int64))
    return x.to(torch.int64) & MASK32


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 uint32 values -> int32 tensor with the same 32 bits."""
    x = x & MASK32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _mul(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for uint32 values a (tensor) and b (tensor or int)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def ref_seed(x, y, width, frame) -> torch.Tensor:
    """Per-pixel seed ``x + y*width + frame*982451653`` in wrapping uint32."""
    x, y = as_u32(x), as_u32(y)
    width, frame = as_u32(width), as_u32(frame)
    return (x + _mul(y, width) + _mul(frame, _REF_SEED_PRIME)) & MASK32


def ref_next(state: torch.Tensor):
    """One step of the reference's stateful RNG -> (new_state, uniform f32)."""
    state = (_mul(as_u32(state), _LCG_MUL) + _LCG_INC) & MASK32
    shift = (state >> 28) + 4
    r = _mul((state >> shift) ^ state, _PCG_MUL)
    r = (r >> 22) ^ r
    return state, r.to(torch.float32) * _INV_U32_MAX


def hash_u32(x) -> torch.Tensor:
    """PCG output hash of a uint32."""
    state = (_mul(as_u32(x), _LCG_MUL) + _LCG_INC) & MASK32
    shift = (state >> 28) + 4
    r = _mul((state >> shift) ^ state, _PCG_MUL)
    return (r >> 22) ^ r


def _mix(h: torch.Tensor, k) -> torch.Tensor:
    """Murmur3-style combine of a new word ``k`` into running hash ``h``."""
    k = _rotl(_mul(as_u32(k), _H_MUL2), 15)
    k = _mul(k, _H_MUL3)
    h = _rotl(h ^ k, 13)
    return (_mul(h, 5) + 0xE6546B64) & MASK32


def counter_bits(pixel, sample, bounce_dim, seed=0) -> torch.Tensor:
    """Stateless random uint32 (as int64) from a (pixel, sample, site) tuple."""
    h = as_u32(seed) ^ _H_MUL1
    h = _mix(h, pixel)
    h = _mix(h, sample)
    h = _mix(h, bounce_dim)
    return hash_u32(h)


def counter_uniform(pixel, sample, bounce_dim, seed=0) -> torch.Tensor:
    """Stateless uniform in [0, 1): the top 24 bits, exact in float32."""
    bits = counter_bits(pixel, sample, bounce_dim, seed)
    return (bits >> 8).to(torch.float32) * _INV_2_24
