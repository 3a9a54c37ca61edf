"""Profiling and render statistics, on ``torch.profiler``.

The port of ``spt_tpu/utils/profiling.py``: named trace annotations
(``trace_scope``, a ``torch.profiler.record_function`` span), trace
capture into a directory (``capture_trace``: CPU activity, plus the card's
kernels and copies where the process has a card; a Chrome trace,
``<host>_<pid>.<time>.pt.trace.json``, that TensorBoard and Perfetto
read), a wall-time ``Timer`` that waits for the card, the ``RenderStats``
aggregator (rays/s, paths/s, sliding-window frame times) and
``measure_occupancy``, the share of lanes still alive at each bounce.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Optional

import torch

from .assertions import _tensors


@contextlib.contextmanager
def trace_scope(name: str):
    """Named span in torch.profiler traces."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Capture a trace of the block into ``log_dir``: the host's ops and
    spans, and on a machine with a card its kernels and copies."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class Timer:
    """Wall-time block timer; on exit it waits for the card that holds
    ``sync`` (a tensor, or a tuple, list or dict of them)."""

    def __init__(self, sync=None):
        self._sync = sync
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        for t in _tensors(self._sync):
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
        self.elapsed = time.perf_counter() - self._t0
        return False


class RenderStats:
    """Sliding-window render statistics."""

    def __init__(self, window: int = 64):
        self._frames = deque(maxlen=window)
        self.total_paths = 0
        self.total_rays = 0
        self.total_time = 0.0

    def record(self, seconds: float, n_paths: int,
               n_rays: Optional[int] = None) -> None:
        self._frames.append((seconds, n_paths, n_rays or 0))
        self.total_time += seconds
        self.total_paths += n_paths
        self.total_rays += n_rays or 0

    @property
    def fps(self) -> float:
        if not self._frames:
            return 0.0
        t = sum(f[0] for f in self._frames)
        return len(self._frames) / t if t > 0 else 0.0

    @property
    def paths_per_second(self) -> float:
        t = sum(f[0] for f in self._frames)
        return sum(f[1] for f in self._frames) / t if t > 0 else 0.0

    @property
    def rays_per_second(self) -> float:
        t = sum(f[0] for f in self._frames)
        return sum(f[2] for f in self._frames) / t if t > 0 else 0.0

    def record_occupancy(self, occupancy) -> None:
        """Store the per-bounce active-lane fraction (see
        ``measure_occupancy``)."""
        self.occupancy = [float(x) for x in occupancy]

    def summary(self) -> dict:
        out = {"fps": self.fps, "paths_per_s": self.paths_per_second,
               "rays_per_s": self.rays_per_second,
               "total_paths": self.total_paths,
               "total_time_s": self.total_time}
        if getattr(self, "occupancy", None) is not None:
            out["occupancy_per_bounce"] = self.occupancy
        return out


def measure_occupancy(scene_data, camera, width: int, height: int, *,
                      spp: int = 8, max_bounces: int = 8, rr_depth: int = 3,
                      use_nee: bool = True, use_mis: bool = True,
                      seed: int = 0) -> list:
    """Per-bounce active-lane fraction (list of ``max_bounces`` floats).

    Bounce k's entry is the share of the ``width * height * spp`` paths
    that still carry a live ray when bounce k starts: the work a
    compaction pass keeps.  Read from the sorted wavefront (its kernels on
    the card, its plain versions on the CPU), which counts each bounce's
    alive lanes; the JAX package reads the same quantity from its SoA
    integrator.
    """
    from ..kernels import wavefront
    alive: list = []
    wavefront.render_wavefront(
        scene_data, camera, width, height, 0, spp, max_bounces=max_bounces,
        rr_depth=rr_depth, use_nee=use_nee, use_mis=use_mis, seed=seed,
        alive=alive)
    return [a / max(width * height * spp, 1) for a in alive]
