"""Invariant checks: host-side verify/check and a checked-function wrapper.

The port of ``spt_tpu/utils/assertions.py``.  ``verify`` is an always-on
invariant check that reports the caller's source location and raises;
``check`` does nothing when ``SPT_RELEASE`` is set.  ``checked_fn`` wraps a
function so that a NaN, an infinity or a division by zero in any
intermediate value it computes, or in any tensor it returns, raises
``VerifyError``, as the JAX package's ``checked_fn``
(``jax.experimental.checkify``) does for its traced programs.
"""

from __future__ import annotations

import inspect
import math
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


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


# The checks ``checked_fn`` runs, by name.  "nan": an op's output holds a
# NaN; "inf": an op made an infinity from finite inputs (an overflow, a
# log of 0); "div": a division's divisor holds a zero; "index": an index
# out of range, which torch raises by itself (on the CPU an IndexError or
# RuntimeError, on the card a device-side assert), so this name only keeps
# that on.  The same split as checkify's ``float_checks`` and
# ``index_checks``.
FLOAT_CHECKS = frozenset({"nan", "inf", "div"})
INDEX_CHECKS = frozenset({"index"})
ALL_CHECKS = FLOAT_CHECKS | INDEX_CHECKS

_DIVISIONS = frozenset({"div", "div_", "floor_divide", "floor_divide_",
                        "remainder", "remainder_", "fmod", "fmod_"})
# Ops whose outputs hold no computed value: uninitialised memory (the
# buffers a caller fills later) and views of what is already checked.
_UNWRITTEN = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided", "set_", "resize_"})


def _floats(values):
    """The floating-point tensors among ``values`` (a pytree)."""
    return [t for t in tree_flatten(values)[0]
            if isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.numel()]


def _all_finite(values) -> bool:
    for v in tree_flatten(values)[0]:
        if isinstance(v, float) and not math.isfinite(v):
            return False
        if isinstance(v, torch.Tensor) and v.is_floating_point() \
                and v.numel() and not bool(torch.isfinite(v).all()):
            return False
    return True


class _CheckMode(TorchDispatchMode):
    """Checks every op that runs under it: its floating-point outputs for
    NaN and infinity, a division's divisor for zeros.  The first failing
    op raises ``VerifyError`` naming the op and the check; each check reads
    one flag to the host."""

    def __init__(self, name: str, errors: frozenset):
        super().__init__()
        self.name, self.errors = name, errors

    def _fail(self, func, what: str, check: str):
        raise VerifyError(f"{self.name}: {func.overloadpacket} {what} "
                          f"(check {check!r})")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = func.overloadpacket.__name__
        if "div" in self.errors and op in _DIVISIONS and len(args) > 1:
            d = args[1]
            zero = bool((d == 0).any()) if isinstance(d, torch.Tensor) \
                else d == 0
            if zero:
                self._fail(func, "divided by zero", "div")
        out = func(*args, **kwargs)
        if func.is_view or op in _UNWRITTEN:
            return out
        for t in _floats(out):
            if "nan" in self.errors and bool(torch.isnan(t).any()):
                self._fail(func, "made a NaN", "nan")
            if "inf" in self.errors and bool(torch.isinf(t).any()) \
                    and _all_finite((args, kwargs)):
                self._fail(func, "made an infinity from finite inputs",
                           "inf")
        return out


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


def checked_fn(fn, errors=None):
    """Wrap ``fn`` so that g(*args) -> value raises ``VerifyError`` on the
    first failed check of ``errors`` (a set of ``ALL_CHECKS``' names;
    default: all of them).

    ``fn`` runs under a ``TorchDispatchMode`` that checks every torch op it
    runs, so a NaN made and then masked inside ``fn`` raises too; the error
    names the op and the check.  A hand-written kernel called through
    ``ctypes`` writes into tensors that no op returns, so its buffers are
    checked only where ``fn`` returns them: the returned floating-point
    tensors are checked for NaN and infinity after ``fn`` ends.

    Use in tests and debugging sessions; production paths call ``fn``
    directly.  Each check reads one flag to the host.
    """
    errors = ALL_CHECKS if errors is None else frozenset(errors)
    unknown = errors - ALL_CHECKS
    if unknown:
        raise ValueError(f"unknown checks {sorted(unknown)}; the checks are "
                         f"{sorted(ALL_CHECKS)}")
    name = getattr(fn, "__name__", repr(fn))

    def g(*args, **kwargs):
        with _CheckMode(name, errors):
            out = fn(*args, **kwargs)
        for i, t in enumerate(_tensors(out)):
            if not t.is_floating_point():
                continue
            if "nan" in errors and bool(torch.isnan(t).any()):
                raise VerifyError(f"{name}: output tensor {i} holds a NaN")
            if "inf" in errors and bool(torch.isinf(t).any()):
                raise VerifyError(f"{name}: output tensor {i} holds an "
                                  f"infinity")
        return out

    return g
