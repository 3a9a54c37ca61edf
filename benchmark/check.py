"""Whether what the timed path produced is correct: the program's answers
against the plain reference (``reference/``), each compared number beside
its limit from the cell's file (``cells/<cell>.json``).

* Renders (``facade_render``): each answer kept from the window (a sample
  of the finished images drawn from the seed, the last finished one and
  the unfinished one) is judged on ``pixels`` pixels drawn from the seed:
  the program's mean radiance (its accumulation over its sample count)
  against the reference's over the same sample ids.  The number is the
  relative L1 gap, sum |program - reference| / sum |reference| over those
  pixels and channels, per answer and over all of them.
* Inverse steps (``inverse_step``): the reference follows each stretch
  of ``checked_steps`` steps that the entry kept (the first ones, from
  the start; those from a step of the window, from the parameters and
  Adam's state the program had there) with the same target and sample
  ids (its loss and gradient by autograd, then Adam and the clip to the
  fields' domains).  Numbers, each the worst over the stretches: the
  largest relative gap of a step's loss; of the stretch's first
  gradient's norm, leaf by leaf; of the norm of the parameters' change
  over the stretch, leaf by leaf.  A leaf's gap is |program norm -
  reference norm| over the larger of the reference's norm of that leaf
  and of the median leaf.  Leaves whose reference gradient is under a
  thousandth of the median leaf's are left out of the change.

``lowp=True`` runs the reference as the control, in bfloat16 in the
program's place.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from . import scenes
from .entries import render_settings
from .reference import render as ref

ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8
CLIP = {"albedo": (0.0, 1.0), "roughness": (0.02, 1.0)}


def render_numbers(config, cell_check, seed, desc, answers, device,
                   lowp=False, counts=None) -> dict:
    """{"image_rel_l1": over all answers, "per_answer": [...], "lanes":
    the paths the reference traced}; ``answers`` as
    ``FacadeRender.outputs``.  With ``lowp`` the control's images take the
    program's place."""
    st = render_settings(config)
    n_px = st.width * st.height
    tab = ref.scene_tables(desc, device)
    low = ref.scene_tables(desc, device, lowp=True) if lowp else None
    pick = np.random.default_rng(scenes.seed_words(seed, 0xC4EC))
    gap = total = 0.0
    per, lanes = [], 0
    for index, pose, accum, n in answers:
        pids = torch.as_tensor(np.sort(pick.choice(
            n_px, size=min(cell_check["pixels"], n_px), replace=False)),
            dtype=torch.int64, device=device)
        blob = ref.camera_blob(pose, device)
        want = ref.render_pixels(tab, blob, pids, range(n), st,
                                 counts=counts) / n
        if lowp:
            got = ref.render_pixels(low, blob, pids, range(n), st,
                                    lowp=True) / n
        else:
            got = accum.reshape(-1, 3)[pids].to(torch.float32) / n
        g = float((got - want).abs().sum())
        w = float(want.abs().sum())
        per.append(g / max(w, 1e-30))
        gap, total = gap + g, total + w
        lanes += pids.numel() * n
    return dict(image_rel_l1=gap / max(total, 1e-30), per_answer=per,
                per_answer_of="image_rel_l1", lanes=lanes)


def _leaf_gap(got: dict, want: dict, keep) -> float:
    norms = {k: float(torch.linalg.vector_norm(want[k])) for k in want}
    med = statistics.median(norms.values())
    return max(abs(float(torch.linalg.vector_norm(got[k])) - norms[k])
               / max(norms[k], med, 1e-30) for k in keep)


def reference_steps(config, traffic, desc, snap, target, pose, device,
                    lowp=False, counts=None):
    """The reference's ``checked_steps`` steps from the state ``snap``
    (``InverseStep._snapshot``'s: step index, parameters, Adam's moments)
    -> (losses, first gradient, parameters after)."""
    st = render_settings(config)
    spp, lr = traffic["spp_per_step"], traffic["learning_rate"]
    b1, b2 = ADAM_BETAS
    params = {k: v.detach().clone() for k, v in snap["params"].items()}
    m = {k: v.detach().clone() for k, v in snap["m"].items()}
    v2 = {k: v.detach().clone() for k, v in snap["v"].items()}
    losses, first = [], None
    for i in range(traffic["checked_steps"]):
        s = snap["step"] + i
        loss, g = ref.loss_and_grad(
            desc, params, pose, target, list(range(s * spp, (s + 1) * spp)),
            st, lowp=lowp, counts=counts if i == 0 else None)
        losses.append(float(loss))
        if first is None:
            first = g
        t = s + 1
        for k in params:
            m[k] = b1 * m[k] + (1.0 - b1) * g[k]
            v2[k] = b2 * v2[k] + (1.0 - b2) * g[k] * g[k]
            denom = torch.sqrt(v2[k]) / (1.0 - b2 ** t) ** 0.5 + ADAM_EPS
            params[k] = torch.clamp(params[k] - (lr / (1.0 - b1 ** t))
                                    * m[k] / denom, *CLIP[k])
    return losses, first, params


def stretch_numbers(config, traffic, desc, snap, target, pose, device,
                    lowp=False, counts=None) -> dict:
    """The three gaps of one stretch of the program's steps from the
    reference's; with ``lowp`` the control's steps take the program's
    place."""
    start = snap["params"]
    want_l, want_g, want_p = reference_steps(
        config, traffic, desc, snap, target, pose, device, counts=counts)
    if lowp:
        got_l, got_g, got_p = reference_steps(
            config, traffic, desc, snap, target, pose, device, lowp=True)
    else:
        got_l, got_g, got_p = snap["losses"], snap["grad"], snap["after"]
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in want_g.items()}
    med = statistics.median(norms.values())
    moving = [k for k in want_g if norms[k] >= 1e-3 * med]
    d_got = {k: got_p[k] - start[k] for k in moving}
    d_want = {k: want_p[k] - start[k] for k in moving}
    loss_gaps = [abs(g - w) / max(abs(w), 1e-30)
                 for g, w in zip(got_l, want_l)]
    return dict(loss_gap=max(loss_gaps),
                grad_gap=_leaf_gap(got_g, want_g, list(want_g)),
                change_gap=_leaf_gap(d_got, d_want, moving),
                loss_gaps=loss_gaps, losses=list(got_l),
                reference_losses=list(want_l))


def inverse_numbers(config, traffic, desc, stretches, target, pose, device,
                    lowp=False, counts=None) -> dict:
    """The worst of each gap over the stretches (``InverseStep.outputs``);
    the reference's bounce counts from the first stretch's first step."""
    per = [stretch_numbers(config, traffic, desc, snap, target, pose,
                           device, lowp=lowp,
                           counts=counts if i == 0 else None)
           for i, snap in enumerate(stretches)]
    out = {k: max(p[k] for p in per)
           for k in ("loss_gap", "grad_gap", "change_gap")}
    out.update(per_answer=[g for p in per for g in p["loss_gaps"]],
               per_answer_of="loss_gap",
               stretches=[dict(step=snap["step"],
                               **{k: p[k] for k in ("loss_gap", "grad_gap",
                                                    "change_gap")})
                          for snap, p in zip(stretches, per)])
    return out
