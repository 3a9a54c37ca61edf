"""What the per-layer metrics' readers (``metrics/<name>.py``) share.

Each reader is ``read(ctx) -> number or None``; ``ctx`` is the dict that
``harness.run`` builds: ``trace`` (``trace.Trace`` of a traced run),
``spans`` (the window's spans), ``setup`` (the set-up's), ``launches``
(the program's launch counters over the window), ``window`` (the
entry's readings), ``counts`` (the reference's per-bounce rays, hits,
shadow rays and lit lanes over ``counted_paths`` paths),
``window_paths``, ``n_spheres`` and ``backward``.  None: nothing to read,
and the metric is left out of the line.
"""

from __future__ import annotations

from .reference import counts as C


def glue_share(ctx):
    """% of the window's device time in kernels that are not the port's
    hand-written ones (sorts, gathers, scatters, compaction, elementwise
    ops, copies)."""
    tr = ctx["trace"]
    if tr is None or tr.device_s <= 0:
        return None
    return 100.0 * (tr.device_s - sum(tr.by_label.values())) / tr.device_s


def device_idle(ctx):
    """% of the traced window in which no kernel, copy or set runs."""
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def kernel_roofline(ctx):
    """% of the hand-written kernels' device time that their least time
    (the larger of fp32 operations at the peak rate and bytes at the peak
    bandwidth, ``reference/counts.py``) takes; kernels the counts do not
    cover count in the time and not in the least time; None where none
    of the kernels that ran is covered."""
    tr = ctx["trace"]
    if tr is None or not ctx["counts"] or ctx["counted_paths"] <= 0:
        return None
    device = sum(tr.by_label.values())
    if device <= 0:
        return None
    scale = ctx["window_paths"] / ctx["counted_paths"]
    per_bounce = [[v * scale for v in row] for row in ctx["counts"]]
    least = C.kernel_least_seconds(ctx["window_paths"], per_bounce,
                                   ctx["n_spheres"], ctx["backward"])
    counted = sum(least.get(k, 0.0) for k in tr.by_label)
    return 100.0 * counted / device if counted > 0 else None
