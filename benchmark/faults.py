"""Faults planted in the program under a run, to show that the check
catches them (the CPU tests at a small size; ``control.py`` on the card at
the cell's own size).

Render cells (the facade's ``_render_samples``, one chunk):
* ``state_unchanged``: the chunk adds nothing to the accumulation;
* ``half_batch``: half of the chunk's samples rendered, their mean taken
  as the chunk's;
* ``altered``: the chunk rendered from the wrong sample ids (the next
  chunk's), an answer that looks right.

Inverse cells (``InverseRenderer``):
* ``state_unchanged``: a step leaves the parameters as they were (Adam's
  update skipped);
* ``half_batch``: the loss is the mean over the top half of the image;
* ``altered``: the rendered image's first row is zeroed where it is made.

A cell on one chip has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

import torch

RENDER = ("state_unchanged", "half_batch", "altered")
INVERSE = ("state_unchanged", "half_batch", "altered")


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def planted(entry: str, fault: str):
    """Plant ``fault`` in the program on the path of the ``entry``."""
    if entry == "facade_render":
        from spt_tpu_torch.engine import cuda_backend
        cls = cuda_backend.CudaPathTracer
        orig = cls._render_samples

        def render_samples(self, start, spp):
            if fault == "state_unchanged":
                return orig(self, start, spp) * 0.0
            if fault == "half_batch":
                half = max(spp // 2, 1)
                return orig(self, start, half) * (spp / half)
            if fault == "altered":
                return orig(self, start + spp, spp)
            raise ValueError(f"unknown fault {fault!r}")
        with _patched(cls, "_render_samples", render_samples):
            yield
        return
    if entry == "inverse_step":
        from spt_tpu_torch.diff import gradients as g
        orig_loss, orig_post = g.make_loss_fn, g.InverseRenderer.__post_init__

        def make_loss_fn(render_fn, target):
            if fault == "half_batch":
                def loss(params, ids):
                    h = target.shape[0] // 2
                    return ((render_fn(params, ids)[:h] - target[:h]) ** 2
                            ).mean()
                return loss
            if fault == "altered":
                def altered(params, ids):
                    img = render_fn(params, ids)
                    return torch.cat([torch.zeros_like(img[:1]), img[1:]])
                return orig_loss(altered, target)
            return orig_loss(render_fn, target)

        def post_init(self):
            orig_post(self)
            if fault == "state_unchanged":
                self.opt.step = lambda *a, **k: None
        if fault not in INVERSE:
            raise ValueError(f"unknown fault {fault!r}")
        with _patched(g, "make_loss_fn", make_loss_fn), \
                _patched(g.InverseRenderer, "__post_init__", post_init):
            yield
        return
    raise ValueError(f"no faults for entry {entry!r}")

