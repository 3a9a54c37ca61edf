"""Invariant checks: host-side verify/check and a checked-output wrapper.

The port of ``spt_tpu/utils/assertions.py``.  ``verify`` is an always-on
invariant check that reports the caller's source location and raises;
``check`` does nothing when ``SPT_RELEASE`` is set.  ``checked_fn`` wraps a
function so that a NaN or an infinity in any floating-point tensor it
returns raises ``VerifyError``.  It checks the outputs only: the JAX
package's ``checked_fn`` (``jax.experimental.checkify``) checks every
intermediate value, division and index too.
"""

from __future__ import annotations

import inspect
import os

import torch


class VerifyError(AssertionError):
    pass


def _location(depth: int = 2) -> str:
    frame = inspect.stack()[depth]
    return f"{frame.filename}:{frame.lineno} in {frame.function}"


def verify(condition: bool, message: str = "verification failed") -> None:
    """Always-on invariant check."""
    if not condition:
        raise VerifyError(f"{message} [{_location()}]")


_RELEASE = bool(int(os.environ.get("SPT_RELEASE", "0")))


def check(condition: bool, message: str = "check failed") -> None:
    """Debug-only invariant check; disabled when SPT_RELEASE=1."""
    if _RELEASE:
        return
    if not condition:
        raise VerifyError(f"{message} [{_location()}]")


def _tensors(out):
    """The tensors in a (nested) tuple, list or dict of outputs."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for x in out:
            yield from _tensors(x)
    elif isinstance(out, dict):
        for x in out.values():
            yield from _tensors(x)


def checked_fn(fn):
    """Wrap ``fn`` so that g(*args) -> value raises ``VerifyError`` when a
    floating-point tensor among its outputs holds a NaN or an infinity.

    Use in tests and debugging sessions; production paths call ``fn``
    directly.  Each check reads one flag per output tensor to the host.
    """
    name = getattr(fn, "__name__", repr(fn))

    def g(*args, **kwargs):
        out = fn(*args, **kwargs)
        for i, t in enumerate(_tensors(out)):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                kind = "NaN" if bool(torch.isnan(t).any()) else "infinity"
                raise VerifyError(f"{name}: output tensor {i} holds a {kind}")
        return out

    return g
