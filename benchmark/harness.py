"""One run of one cell: set up, measure for the run's seconds, check the
answers against the reference, read the metrics.

Everything is found by name: the cell in ``BENCHMARK.json``'s
``workloads`` (its ``config`` and ``traffic``), the configuration in
``configs/<config>.json``, the traffic mix in ``traffic/<traffic>.json``
(whose ``entry`` names the code in ``entries.py`` that drives it), the
cell's check in ``cells/<cell>.json``, and each per-layer metric's reader
in ``metrics/<metric>.py`` (a ``read(ctx)`` that returns a number or
None).
The end-to-end metrics are the benchmark's own, from the host clock and
the device's allocator.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from . import check, entries, faults, trace

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "spt_tpu")
GIB = float(1 << 30)


class RunError(Exception):
    """A run that prints no result."""


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that a run may not load, compared
    whole (``spt_tpu_torch`` is not ``spt_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Record:
    """Spans and counts the benchmark takes around the program's calls;
    ``scope`` names host phases in the trace of a traced run."""

    def __init__(self, tracing: bool):
        self.tracing = tracing
        self.spans = defaultdict(list)
        self.setup = {}

    def add(self, name: str, value: float) -> None:
        self.spans[name].append(value)

    def scope(self, name: str):
        if not self.tracing:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def close_setup(self) -> None:
        self.setup = {k: sum(v) for k, v in self.spans.items()}
        self.spans = defaultdict(list)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _deep_merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def load_cell(name: str, root: Path = ROOT, overrides: dict | None = None):
    """(benchmark, workload entry, config, traffic, check) of cell
    ``name``; ``overrides`` {"config": {...}, "traffic": {...}, "check":
    {...}} are merged in (the CPU tests' small sizes)."""
    bench = _json(root.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    over = overrides or {}
    config = _deep_merge(_json(root / "configs" / f"{w['config']}.json"),
                         over.get("config", {}))
    traffic = _deep_merge(_json(root / "traffic" / f"{w['traffic']}.json"),
                          over.get("traffic", {}))
    cell_check = _deep_merge(_json(root / "cells" / f"{name}.json"),
                             over.get("check", {}))
    return bench, w, config, traffic, cell_check


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics cell reports: a
    metric with ``workloads`` in those cells, one without in every cell
    (a per-layer one: every cell that reports the metric it moves)."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def load_reader(name: str, root: Path = ROOT):
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def end_to_end(name: str, w: dict, setup_s: float, peak: int):
    if name == "setup_s":
        return setup_s
    if name == "peak_mem_gib":
        return peak / GIB
    if name == "msamples_per_s":
        return w["samples"] / w["window_s"] / 1e6
    if name == "image_p95_ms":
        lat = w["latencies_s"]
        return float(np.percentile(lat, 95)) * 1e3 if lat else None
    if name == "step_ms":
        return w["window_s"] / w["steps"] * 1e3 if w["steps"] else None
    raise RunError(f"no end-to-end metric {name!r}")


def run(cell: str, seed: int, seconds: float, tracing: bool, *,
        t_start: float | None = None, device: str = "cuda",
        overrides: dict | None = None, root: Path = ROOT,
        lowp: bool = False, fault: str | None = None) -> tuple:
    """One run -> (result dict, the check's lines for standard error).
    ``device="cpu"`` (the CPU tests) skips the look for a card and runs
    the program's plain versions.  ``lowp`` judges the control (the
    reference in bfloat16) in the program's place, ``fault`` plants one of
    ``faults.py``'s faults in the program: both only for ``control.py``
    and the tests."""
    t_start = time.perf_counter() if t_start is None else t_start
    t_enter = time.perf_counter()
    bench, w, config, traffic, cell_check = load_cell(cell, root, overrides)
    on_card = device != "cpu"
    if on_card:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device is available")
        if torch.cuda.device_count() < w["chips"]:
            raise RunError(f"the cell asks for {w['chips']} devices, "
                           f"{torch.cuda.device_count()} are here")
    import spt_tpu_torch as T
    from spt_tpu_torch.kernels import megakernel as counters
    t_program = time.perf_counter()
    rec = Record(tracing)
    drv = entries.ENTRIES[traffic["entry"]](T, config, traffic, seed,
                                            device, rec)
    planted = faults.planted(traffic["entry"], fault) if fault \
        else contextlib.nullcontext()
    with planted:
        drv.setup()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        rec.close_setup()
        # The benchmark's own reference work in set-up is not the
        # program's.
        reference_s = rec.setup.get("reference_s", 0.0)
        setup_s = time.perf_counter() - t_start - reference_s
        launches0 = dict(counters.LAUNCHES)
        tout = {}
        # The collector's pauses fall where its counters happen to cross,
        # and scan the set-up's objects: the window runs with them frozen
        # and the collector off, and collects after.
        gc.collect()
        gc.freeze()
        gc.disable()
        try:
            with trace.profiled(tracing, tout):
                with rec.scope(trace.WINDOW):
                    win = drv.window(seconds)
        finally:
            gc.enable()
            gc.unfreeze()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        launches = {k: v - launches0.get(k, 0)
                    for k, v in counters.LAUNCHES.items()}
        outs = drv.outputs()
    found = forbidden_modules()
    if found:
        raise RunError(f"modules loaded that a run may not load: {found}")

    # The check, after the window, with the program's state freed.
    kept = dict(desc=drv.desc, st=drv.st,
                target=getattr(drv, "target", None),
                pose=getattr(drv, "pose", None))
    drv.free()
    del drv
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    counts = []
    t0 = time.perf_counter()
    if traffic["entry"] == "facade_render":
        nums = check.render_numbers(config, cell_check, seed, kept["desc"],
                                    outs, device, lowp=lowp, counts=counts)
        counted_paths = nums["lanes"]
        window_paths = win["samples"]
    else:
        nums = check.inverse_numbers(config, traffic, kept["desc"], outs,
                                     kept["target"], kept["pose"], device,
                                     lowp=lowp, counts=counts)
        counted_paths = kept["st"].width * kept["st"].height \
            * traffic["spp_per_step"]
        window_paths = counted_paths * win["steps"]
    check_s = time.perf_counter() - t0
    limits = cell_check["limits"]
    # A number that is not finite fails its limit, and is printed as text.
    checks = {k: dict(value=nums[k] if math.isfinite(nums[k]) else
                      str(nums[k]), limit=limits[k]) for k in limits}
    correct = all(math.isfinite(nums[k]) and nums[k] <= limits[k]
                  for k in limits)
    per_limit = limits[nums["per_answer_of"]]
    failed = sum(1 for v in nums["per_answer"] if not v <= per_limit)
    if not correct:
        failed = max(failed, 1)

    metrics = {}
    if tracing:
        ctx = dict(cell=cell, config=config, traffic=traffic, window=win,
                   trace=tout["trace"], spans=rec.spans, setup=rec.setup,
                   launches=launches, counts=counts,
                   counted_paths=counted_paths, window_paths=window_paths,
                   n_spheres=len(kept["desc"]["radii"]),
                   backward=traffic["entry"] == "inverse_step")
        got = {m["name"]: (m, load_reader(m["name"], root)(ctx))
               for m in metrics_of(bench, cell, "per_layer")}
    else:
        got = {m["name"]: (m, end_to_end(m["name"], win, setup_s, peak))
               for m in metrics_of(bench, cell, "end_to_end")}
    for name, (m, v) in got.items():
        if v is not None:
            metrics[name] = dict(value=float(v), unit=m["unit"])
    dev = dict(platform="gpu" if on_card else "cpu",
               kind=torch.cuda.get_device_name(0) if on_card else "cpu",
               count=w["chips"], memory_peak_bytes=int(peak))
    result = dict(correct=bool(correct), attempted=int(win["requests"]),
                  failed=int(failed), metrics=metrics, device=dev)
    if tracing:
        tr = tout["trace"]
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
        dev["power_limit"] = power_limit() if on_card else None
    result["checks"] = checks
    lines = [f"check {k}: {nums[k]!r} limit {limits[k]!r} "
             f"({'ok' if nums[k] <= limits[k] else 'FAILED'})"
             for k in limits]
    if tracing:
        lines.insert(0, f"trace seconds {tout['seconds']:.3f}, device "
                        f"events {tout['trace'].n_device_events}")
    lines.insert(0, f"check seconds {check_s:.3f}, answers "
                    f"{len(nums['per_answer'])}, per answer "
                    f"{[round(v, 9) for v in nums['per_answer']]}")
    if "stretches" in nums:
        lines.insert(1, f"stretches {nums['stretches']}")
    lines.insert(0, f"set-up: {setup_s:.3f} s: to the harness "
                    f"{t_enter - t_start:.3f}, the card and the program's "
                    f"import {t_program - t_enter:.3f}, the entry's set-up "
                    f"{setup_s + t_start - t_program:.3f} (its parts "
                    f"{ {k: round(v, 3) for k, v in rec.setup.items()} }); "
                    f"the reference's {reference_s:.3f} left out")
    return result, lines


def power_limit():
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return got.stdout.strip().splitlines()[0] if got.stdout.strip() \
        else got.stderr.strip()[:200]

