"""Checkpoint / resume of progressive render and optimizer state.

The port of ``spt_tpu/io/checkpoint.py``, with the same ``.npz`` keys
(``accum``, ``frame_count``; ``param_*``, ``opt_*``, ``step``), so a file
either package writes loads in the other.  A progressive session's state
is its accumulation buffer and frame count: a resumed render continues
with the same next sample index, hence the same samples (the RNG depends
only on sample ids).
"""

from __future__ import annotations

import numpy as np

from .image import _host


def save_render_state(path: str, tracer) -> None:
    """Persist a PathTracerBase session's progressive state."""
    state = tracer.get_state()
    np.savez(path, accum=_host(state["accum"]),
             frame_count=np.int64(state["frame_count"]))


def load_render_state(path: str, tracer) -> None:
    """Restore a session saved by save_render_state; the accumulation
    buffer goes to the tracer's device."""
    with np.load(path) as z:
        tracer.set_state({"accum": z["accum"],
                          "frame_count": int(z["frame_count"])})


def save_optimizer_state(path: str, params, opt_state_flat: dict,
                         step: int) -> None:
    """Persist inverse-rendering optimization state (flat dicts of tensors
    or arrays)."""
    arrays = {f"param_{k}": _host(v) for k, v in params.items()}
    arrays.update({f"opt_{k}": _host(v) for k, v in opt_state_flat.items()})
    arrays["step"] = np.int64(step)
    np.savez(path, **arrays)


def load_optimizer_state(path: str):
    """(params, opt_state_flat, step) as host arrays."""
    with np.load(path) as z:
        params = {k[6:]: z[k] for k in z.files if k.startswith("param_")}
        opt = {k[4:]: z[k] for k in z.files if k.startswith("opt_")}
        step = int(z["step"])
    return params, opt, step
