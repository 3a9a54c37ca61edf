"""Cameras: the positionable pinhole / thin-lens ``Camera`` and the
reference renderer's hard-coded ``ReferenceCamera``.

A camera is a frozen dataclass of float32 tensors on one device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..utils.device import DeviceLike, resolve_device


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched vec3 dot product over the trailing axis, keepdims."""
    return torch.sum(a * b, dim=-1, keepdim=True)


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v * torch.reciprocal(torch.sqrt(torch.clamp_min(
        torch.sum(v * v, dim=-1, keepdim=True), eps)))


@dataclasses.dataclass(frozen=True)
class Camera:
    """Positionable pinhole / thin-lens camera."""

    position: torch.Tensor      # (3,)
    forward: torch.Tensor       # (3,) unit
    right: torch.Tensor         # (3,) unit
    up: torch.Tensor            # (3,) unit
    tan_half_fov: torch.Tensor  # scalar, tan(vertical_fov / 2)
    aperture: torch.Tensor      # scalar lens radius; 0 => pinhole
    focus_dist: torch.Tensor    # scalar focal-plane distance

    @staticmethod
    def look_at(position, target, up=(0.0, 1.0, 0.0), fov_degrees=45.0,
                aperture=0.0, focus_dist=None,
                device: DeviceLike = None) -> "Camera":
        device = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=device)
        position = torch.as_tensor(position, **f32)
        target = torch.as_tensor(target, **f32)
        world_up = torch.as_tensor(up, **f32)
        fwd = target - position
        dist = torch.linalg.vector_norm(fwd)
        fwd = fwd / torch.clamp_min(dist, 1e-12)
        # +x right on screen, +y up, +z forward: right = up × fwd,
        # cam_up = fwd × right.
        right = torch.linalg.cross(world_up, fwd)
        right = right / torch.clamp_min(torch.linalg.vector_norm(right), 1e-12)
        cam_up = torch.linalg.cross(fwd, right)
        if focus_dist is None:
            focus_dist = dist
        fov = torch.as_tensor(fov_degrees, **f32)
        return Camera(
            position=position, forward=fwd, right=right, up=cam_up,
            tan_half_fov=torch.tan(torch.deg2rad(fov) * 0.5),
            aperture=torch.as_tensor(aperture, **f32),
            focus_dist=torch.as_tensor(focus_dist, **f32))

    def generate_rays(self, px, py, width, height, u_jitter, v_jitter,
                      u_lens=None, v_lens=None):
        """Primary rays for integer pixel coords with sub-pixel jitter.

        Returns (origins, directions) with trailing dim 3.
        """
        aspect = torch.tensor(width, dtype=torch.float32) / height
        sx = (px.to(torch.float32) + u_jitter) / float(width)
        sy = (py.to(torch.float32) + v_jitter) / float(height)
        ndc_x = (2.0 * sx - 1.0) * aspect.to(sx.device) * self.tan_half_fov
        ndc_y = (1.0 - 2.0 * sy) * self.tan_half_fov
        d = ndc_x[..., None] * self.right + ndc_y[..., None] * self.up \
            + self.forward
        d = normalize(d)
        o = torch.broadcast_to(self.position, d.shape)
        if u_lens is not None:
            # Thin-lens: offset origin on the lens disk, refocus on the plane.
            r = self.aperture * torch.sqrt(u_lens)
            phi = (2.0 * math.pi) * v_lens
            offset = (r * torch.cos(phi))[..., None] * self.right \
                + (r * torch.sin(phi))[..., None] * self.up
            focus_pt = o + d * (self.focus_dist / torch.clamp_min(
                dot(d, torch.broadcast_to(self.forward, d.shape)), 1e-6))
            o = o + offset
            d = normalize(focus_pt - o)
        return o, d


@dataclasses.dataclass(frozen=True)
class ReferenceCamera:
    """The reference renderer's hard-coded camera.

    Pinhole at origin, +z forward, pixel-corner sampling (no jitter):
    u = x/w, v = 1 − y/h, dir = normalize((2u−1)·aspect, 2v−1, 1).
    """

    def generate_rays(self, px, py, width, height):
        aspect = float(torch.tensor(width, dtype=torch.float32) / height)
        inv_w = float(1.0 / torch.tensor(width, dtype=torch.float32))
        inv_h = float(1.0 / torch.tensor(height, dtype=torch.float32))
        u = px.to(torch.float32) * inv_w
        v = 1.0 - py.to(torch.float32) * inv_h
        uv_x = (u * 2.0 - 1.0) * aspect
        uv_y = v * 2.0 - 1.0
        inv_len = 1.0 / torch.sqrt(uv_x * uv_x + uv_y * uv_y + 1.0)
        d = torch.stack([uv_x * inv_len, uv_y * inv_len, inv_len], dim=-1)
        return torch.zeros_like(d), d
