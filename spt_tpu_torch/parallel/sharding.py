"""Sharded training steps and primitive padding.

The port of two functions of ``spt_tpu.parallel.sharding``:

* ``make_dp_grad_step``: the data-parallel gradient step of inverse
  rendering.  Each rank evaluates the loss on its own sample ids, and the
  loss and the scene-parameter gradients are averaged over ``data``.
* ``shard_scene_prims``: pads the primitive arrays so that the capacity
  divides a shard count.

The JAX module's other renders (``render_pixel_sharded``,
``render_sample_sharded`` and the oracle primitive-sharding strategies)
run through its AoS oracle ``integrator_jax.render_megasample``, which the
port leaves out (ROADMAP.md); the kernel paths are ``wavefront_sharded``
and ``wavefront_prim``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..core.scene import SceneData
from .mesh import RenderMesh, all_reduce


def shard_scene_prims(scene: SceneData, n_shards: int) -> SceneData:
    """The scene with its primitive arrays padded by invalid rows (zeros,
    ``prim_valid`` False) to a capacity that ``n_shards`` divides."""
    cap = scene.capacity
    new_cap = -(-cap // n_shards) * n_shards
    if new_cap == cap:
        return scene
    pad = new_cap - cap

    def pad0(x):
        return torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]),
                                         dtype=x.dtype, device=x.device)])

    return dataclasses.replace(
        scene, centers=pad0(scene.centers), radii=pad0(scene.radii),
        mat_id=pad0(scene.mat_id), prim_valid=pad0(scene.prim_valid))


def make_dp_grad_step(loss_fn, mesh: RenderMesh, samples_per_device: int):
    """``step(params, step_idx) -> (loss, grads)``, sample-sharded.

    ``loss_fn(params, sample_ids)`` is a differentiable scalar.  The rank at
    data index i evaluates it on sample ids ``step_idx * N * spd + i * spd +
    arange(spd)`` (``spd`` = ``samples_per_device``, N the data axis), and
    one all-reduce averages the loss and every gradient over ``data``
    (gloo has no average: a SUM, then a division).  ``params``: a dict of
    tensors; ``grads`` has the same keys, the same on every rank."""
    mesh.check_member()
    spd = samples_per_device

    def step(params: dict, step_idx: int):
        keys = list(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in keys}
        base = int(step_idx) * mesh.data * spd + mesh.data_idx * spd
        ids = torch.arange(base, base + spd)
        loss = loss_fn(leaves, ids)
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys],
                                    allow_unused=True)
        flat = torch.cat([loss.detach().reshape(1).to(torch.float32)] + [
            (torch.zeros_like(leaves[k]) if g is None else g).reshape(-1)
            .to(torch.float32) for k, g in zip(keys, grads)])
        all_reduce(flat, dist.ReduceOp.SUM, mesh.data_group, mesh.backend)
        flat = flat * (1.0 / mesh.data)
        out, at = {}, 1
        for k in keys:
            n = leaves[k].numel()
            out[k] = flat[at:at + n].reshape(leaves[k].shape)
            at += n
        return flat[0], out

    return step
