"""The counter-based RNG of the path tracer, as plain PyTorch integer ops.

A frozen copy of ``spt_tpu_torch/core/rng.py`` (the ``counter_*`` hash and
its helpers) at commit 1ae0631e9a6a2afc017f1275ca928f65cb92b419.  It stays
here, unchanged when the port changes, so that the benchmark's reference
draws the stream the port promises: a uniform keyed on (pixel, sample,
bounce * 8 + dim, seed).

uint32 values travel as int64 tensors holding 0 .. 2**32 - 1; products are
split into 16-bit halves so that no intermediate leaves the int64 range.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF

_LCG_MUL = 747796405
_LCG_INC = 2891336453
_PCG_MUL = 277803737
_H_MUL1 = 0x9E3779B9
_H_MUL2 = 0x85EBCA6B
_H_MUL3 = 0xC2B2AE35
_INV_2_24 = float(np.float32(1.0 / (1 << 24)))


def as_u32(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, np.int64))
    return x.to(torch.int64) & MASK32


def _mul(a: torch.Tensor, b) -> torch.Tensor:
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def hash_u32(x) -> torch.Tensor:
    state = (_mul(as_u32(x), _LCG_MUL) + _LCG_INC) & MASK32
    shift = (state >> 28) + 4
    r = _mul((state >> shift) ^ state, _PCG_MUL)
    return (r >> 22) ^ r


def _mix(h: torch.Tensor, k) -> torch.Tensor:
    k = _rotl(_mul(as_u32(k), _H_MUL2), 15)
    k = _mul(k, _H_MUL3)
    h = _rotl(h ^ k, 13)
    return (_mul(h, 5) + 0xE6546B64) & MASK32


def counter_bits(pixel, sample, bounce_dim, seed=0) -> torch.Tensor:
    h = as_u32(seed) ^ _H_MUL1
    h = _mix(h, pixel)
    h = _mix(h, sample)
    h = _mix(h, bounce_dim)
    return hash_u32(h)


def counter_uniform(pixel, sample, bounce_dim, seed=0) -> torch.Tensor:
    """Uniform in [0, 1): the top 24 bits, exact in float32."""
    bits = counter_bits(pixel, sample, bounce_dim, seed)
    return (bits >> 8).to(torch.float32) * _INV_2_24
