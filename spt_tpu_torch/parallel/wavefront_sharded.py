"""The sorted wavefront with its samples sharded over the mesh's ``data`` axis.

The port of ``spt_tpu.parallel.wavefront_sharded`` (BASELINE config 5's
"rays sharded across N>=2 hosts with grad all-reduce"):

* ``render_wavefront_sharded``: the spp split over ``data``.  Each rank runs
  the whole wavefront (K5, sort, precull, K6, K7) on its own window of
  global sample ids, and one all-reduce sums the partial radiance.  The
  counter RNG keys on the (pixel, sample) ids each ray carries, so each
  rank draws exactly what one process would for those samples: the result
  is the unsharded render's up to the order of the sum.
* ``make_wavefront_dp_render_fn``: the differentiable wavefront (K5, K6, K9
  forward, K10 backward) under the same split.  The scene parameters enter
  through ``_GradAllReduce``, whose backward all-reduces their gradient
  with SUM (the gradient all-reduce, one collective of the flat parameter
  vector), and the image leaves through ``_ImageAllReduce``, whose forward
  sums the partial images and whose backward is the identity.  So each
  rank differentiates its own samples and the sum over ``data`` is taken
  once, as the transpose of JAX's ``shard_map`` takes it; an all-reduce
  under autograd (``torch.distributed.nn``) would all-reduce the image's
  cotangent too, which every rank holds whole, and give N times the
  gradient.

Ranks of one ``prim`` group hold the same samples and compute the same
image; the sums run over ``data`` only.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.scene import SceneData
from ..kernels import wavefront as wf
from ..kernels.megakernel_bvh import BLOCK
from .mesh import RenderMesh, all_reduce


def render_wavefront_sharded(scene: SceneData, camera, width: int,
                             height: int, start_sample: int, spp: int,
                             mesh: RenderMesh, *, max_bounces: int = 8,
                             rr_depth: int = 3, use_nee: bool = True,
                             use_mis: bool = True, seed: int = 0,
                             dof=None, block: int = BLOCK,
                             sort_min_rays: int = 1 << 17,
                             chunk_rays: int = 4 << 20, **kw) -> torch.Tensor:
    """Sample-sharded wavefront forward; the (H, W, 3) radiance sum over
    ``spp`` samples, on every rank.

    ``spp`` must divide by the mesh's ``data`` axis; data index i renders
    samples [start + i*spp/N, start + (i+1)*spp/N) by
    ``wavefront.render_wavefront`` on the scene's device, ``kw`` its other
    options (the knobs ``sort_every``, ``qbits``, ``dir_major``, ``dbits``,
    ``rowsort``, ``tcull``; ``compact``, ``precull``, ``split``, ``mxu``),
    as JAX's passes them through."""
    spp_rank = mesh.samples_per_rank(spp)
    mesh.check_member()
    img = wf.render_wavefront(
        scene, camera, width, height, start_sample + mesh.data_idx * spp_rank,
        spp_rank, max_bounces=max_bounces, rr_depth=rr_depth,
        use_nee=use_nee, use_mis=use_mis, seed=seed, dof=dof, block=block,
        sort_min_rays=sort_min_rays, chunk_rays=chunk_rays, **kw)
    return all_reduce(img, dist.ReduceOp.SUM, mesh.data_group, mesh.backend)


class _ImageAllReduce(torch.autograd.Function):
    """A rank's partial image -> the sum over ``data``; the backward passes
    the cotangent through (each rank's partial enters the sum once)."""

    @staticmethod
    def forward(ctx, img, mesh):
        return all_reduce(img.clone(), dist.ReduceOp.SUM, mesh.data_group,
                          mesh.backend)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _GradAllReduce(torch.autograd.Function):
    """The identity on the parameters; the backward sums their gradients
    over ``data`` in one all-reduce of the flat vector (the gradient
    all-reduce).  ``timing``, a dict or None, gets that collective's
    milliseconds (``mesh.all_reduce``'s stats) and the vector's length
    under ``"grad_numel"``."""

    @staticmethod
    def forward(ctx, mesh, timing, *params):
        ctx.mesh, ctx.timing = mesh, timing
        ctx.shapes = [p.shape for p in params]
        return tuple(p.clone() for p in params)

    @staticmethod
    def backward(ctx, *cts):
        mesh = ctx.mesh
        flat = torch.cat([
            (torch.zeros(s, dtype=torch.float32, device=mesh.device)
             if c is None else c).reshape(-1)
            for c, s in zip(cts, ctx.shapes)])
        all_reduce(flat, dist.ReduceOp.SUM, mesh.data_group, mesh.backend,
                   ctx.timing)
        if ctx.timing is not None:
            ctx.timing["grad_numel"] = flat.numel()
        out, at = [], 0
        for s in ctx.shapes:
            n = s.numel()
            out.append(flat[at:at + n].reshape(s))
            at += n
        return (None, None, *out)


def make_wavefront_dp_render_fn(scene: SceneData, camera, width: int,
                                height: int, *, spp: int, mesh: RenderMesh,
                                timing: dict | None = None, **kw):
    """Sample-sharded differentiable wavefront: ``render(params,
    start_sample) -> (H, W, 3)`` mean radiance of samples ``start_sample ..
    start_sample + spp - 1``, on every rank, differentiable with
    ``torch.autograd``.

    Each rank renders its window of ``spp / N`` samples through
    ``wavefront_grad.make_wavefront_render_fn`` (``kw``: its options); the
    backward runs each rank's own bounces (K10) and all-reduces the
    parameters' gradient over ``data`` once.  ``timing``, if given, gets
    the gradient all-reduce's milliseconds, one entry a backward
    (``_GradAllReduce``)."""
    from ..kernels import wavefront_grad as wg

    spp_rank = mesh.samples_per_rank(spp)
    mesh.check_member()
    rank_render = wg.make_wavefront_render_fn(
        scene, camera, width, height, spp=spp_rank, **kw)
    offset = mesh.data_idx * spp_rank

    def render(params: dict, start_sample) -> torch.Tensor:
        keys = list(params)
        shared = _GradAllReduce.apply(mesh, timing,
                                      *(params[k] for k in keys))
        img = rank_render(dict(zip(keys, shared)), int(start_sample) + offset)
        return _ImageAllReduce.apply(img, mesh) * (1.0 / mesh.data)

    return render
