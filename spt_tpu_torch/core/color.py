"""Color utilities: RGBA8888 packing, tone mapping, gamma, display image.

``pack_rgba8`` puts R in the high byte.  The display conversion is the
reference's (mean over samples, clamp to [0, 1], no gamma, u8 by truncation
of v*255) plus exposure / tonemap / gamma / auto-exposure.
"""

from __future__ import annotations

import torch


def rgba_to_uint32(r, g, b, a) -> torch.Tensor:
    """Pack u8 channels into a uint32 tensor, R in the high byte.

    The word is built in int64 (PyTorch on the CPU cannot shift uint32),
    then converted."""
    r, g, b, a = (torch.as_tensor(c).to(torch.int64) for c in (r, g, b, a))
    word = ((r << 24) | (g << 16) | (b << 8) | a) & 0xFFFFFFFF
    return word.to(torch.uint32)


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """float [0,1] -> [0, 255] float; the caller's integer cast truncates."""
    return torch.clamp(x, 0.0, 1.0) * 255.0


def tonemap_reinhard(c):
    return c / (1.0 + c)


def tonemap_aces(c):
    """Narkowicz ACES filmic fit."""
    a, b, cc, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((c * (a * c + b)) / (c * (cc * c + d) + e), 0.0, 1.0)


def apply_tonemap(c, mode: str):
    if mode == "reinhard":
        return tonemap_reinhard(c)
    if mode == "aces":
        return tonemap_aces(c)
    if mode == "none":
        return c
    raise ValueError(f"unknown tonemap mode {mode!r}")


def apply_gamma(c, gamma: float):
    if gamma == 1.0:
        return c
    return torch.pow(torch.clamp(c, 0.0, 1.0), 1.0 / gamma)


def luminance(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def finalize_image(accum_rgb, n_samples, exposure=1.0, tonemap="none",
                   gamma=1.0, auto_exposure=False, target_exposure=0.18):
    """Accumulated radiance (H,W,3) + sample count -> display RGB in [0,1]."""
    mean = accum_rgb / max(float(n_samples), 1.0)
    if auto_exposure:
        avg_lum = torch.exp(torch.mean(torch.log(luminance(mean) + 1e-6)))
        mean = mean * (target_exposure / torch.clamp_min(avg_lum, 1e-6))
    else:
        mean = mean * exposure
    mean = apply_tonemap(mean, tonemap)
    mean = apply_gamma(mean, gamma)
    return torch.clamp(mean, 0.0, 1.0)


def pack_rgba8(rgb, alpha=None) -> torch.Tensor:
    """(H,W,3) float [0,1] -> (H,W) uint32 RGBA8888."""
    r, g, b = (quantize_u8(rgb[..., i]).to(torch.int64) for i in range(3))
    if alpha is None:
        a = torch.full_like(r, 255)
    else:
        a = quantize_u8(alpha).to(torch.int64)
    return rgba_to_uint32(r, g, b, a)

