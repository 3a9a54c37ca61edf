"""The device trace of a ``--trace 1`` run, and what the readers take from
it.

The window runs under ``torch.profiler`` (CPU and CUDA activities) inside
a ``bench.window`` annotation; the trace is exported as Chrome JSON into
a temporary directory and reduced to: the device intervals (kernels,
copies, sets) inside the window, their union (``busy_s``), the window's
length, device seconds by kernel name and by hand-written kernel label
(``KERNELS``: the ``__global__`` functions of the port's ``csrc``, by
name), and the device's idle gaps, each named by the innermost host
event running at its middle.
"""

from __future__ import annotations

import contextlib
import heapq
import json
import os
import re
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
WINDOW = "bench.window"

# Labels of the port's hand-written kernels by the name of their
# ``__global__`` function (mangled or not); everything else on the device
# is a library's or PyTorch's.
KERNELS = {
    "k1": "megakernel_fwd_kernel", "k2": "megakernel_grad_kernel",
    "k2_vjp": "bounce_vjp_kernel", "k3": "megakernel_bvh_kernel",
    "k4": "megakernel_bvh_grad_kernel", "k5": "raygen_kernel",
    "k6": "isect_kernel", "k6m": "isect_mxu_kernel", "k7": "shade_kernel",
    "k8l": "anyhit_kernel", "k7mv": "mxu_verdict_kernel",
    "k11": "bounce_kernel", "k10": "bounce_bwd_kernel",
    "counter_bits": "counter_bits_kernel",
}
_PATTERNS = [(label, re.compile(rf"(?<![A-Za-z_]){name}(?![a-z_])"))
             for label, name in KERNELS.items()]


def kernel_label(name: str):
    """The hand-written kernel label of a device event's name, or None."""
    for label, pat in _PATTERNS:
        if pat.search(name):
            return label
    return None


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The reduced trace (times in seconds)."""

    def __init__(self, events: list):
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("ph") == "X"]
        if not win:
            raise RuntimeError("the trace holds no bench.window annotation")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) * 1e-6
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X" or "ts" not in e:
                continue
            a = float(e["ts"])
            b = a + float(e.get("dur", 0.0))
            if e.get("cat") in DEVICE_CATS:
                a, b = max(a, w0), min(b, w1)
                if b > a:
                    dev.append((a, b, e.get("name", "?")))
            elif e.get("cat") in HOST_CATS and e.get("name") != WINDOW:
                host.append((a, b, e.get("name", "?")))
        self.by_name = defaultdict(float)
        self.by_label = defaultdict(float)
        self.launches = defaultdict(int)
        for a, b, name in dev:
            self.by_name[name] += (b - a) * 1e-6
            label = kernel_label(name)
            if label is not None:
                self.by_label[label] += (b - a) * 1e-6
                self.launches[label] += 1
        busy = _union([(a, b) for a, b, _ in dev])
        self.busy_s = sum(b - a for a, b in busy) * 1e-6
        self.device_s = sum(self.by_name.values())
        self.n_device_events = len(dev)
        gaps, t = [], w0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((t, w1))
        self.gaps = defaultdict(float)
        names = _innermost(host, [0.5 * (a + b) for a, b in gaps])
        for (a, b), name in zip(gaps, names):
            self.gaps[name] += (b - a) * 1e-6

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return dict(device_ops=[[n[:160], s] for n, s in ops],
                    idle_gaps=[[n[:160], s] for n, s in gaps])


def _innermost(host: list, times: list) -> list:
    """For each time (in increasing order), the name of the latest-starting
    host event (start, end, name) that covers it: one sweep, a heap of the
    events started so far by their start, those ended dropped from its
    top."""
    host = sorted(host)
    heap, i, out = [], 0, []
    for t in times:
        while i < len(host) and host[i][0] <= t:
            heapq.heappush(heap, (-host[i][0], -i, host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][2] < t:
            heapq.heappop(heap)
        out.append(heap[0][3] if heap else "(no host event)")
    return out


@contextlib.contextmanager
def profiled(enabled: bool, out: dict):
    """Run the body under torch.profiler when ``enabled``; then put the
    reduced ``Trace`` in ``out["trace"]``."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    with tempfile.TemporaryDirectory() as tmp:
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            yield
        t0 = time.perf_counter()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    out["trace"] = Trace(events)
    out["seconds"] = time.perf_counter() - t0
