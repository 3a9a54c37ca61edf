"""Run the sharded renders on N ranks, one process each, and collect rank 0's
report.

    launch(cases, world_size, scenes={...}, backend=None, device=None)

spawns ``world_size`` processes of this module (``python -m
spt_tpu_torch.tools.dist_worker RANK WORLD DIR``), joined by
``init_distributed`` through a ``file://`` rendezvous in a fresh temporary
directory (parallel test workers cannot collide on it), runs every named
case on every rank in order, and returns rank 0's report of each: a dict
read from JSON, with the arrays it saved (images, gradients) loaded into it.
The port's counterpart of ``tools/run_multiprocess.py`` and
``tools/mp_worker.py``, which run the JAX package's AoS oracle; these cases
run the kernel paths (``parallel.wavefront_sharded``,
``parallel.wavefront_prim``, ``parallel.sharding``).

A case is a dict: ``"case"`` (a key of ``CASES``: ``"forward"``,
``"prim_forward"``, ``"dp_grad"``, ``"dp_step"``, and ``sharding``'s
five renders ``"pixel"``, ``"sample"``, ``"prim_gather"``,
``"prim_ring"``, ``"prim_auto"``), the mesh (``"data"``,
``"prim"``: ranks past ``data * prim`` sit it out), ``"scene"`` (a key of
``scenes``), ``"width"``, ``"height"``, ``"spp"``, ``"start"`` and
``"kw"`` (the render's options), and what the case reads besides.  Each
rank compiles the scene and camera from the parent's arrays, on
``device``: the card unless the caller passes "cpu", as every entry point
of the port; every rank takes the same device, so ranks on "cuda" share
one card.  ``backend`` defaults to "nccl" for a single rank on the card
and to "gloo" otherwise (the CPU, or ranks sharing a card, which NCCL
does not take).  Every report says which backend ran, and sums over
the ranks the kernels' launches (``launches``) and the list-building
glue's calls (``glue_calls``: ``wavefront.GLUE_CALLS``).

A rank that fails or hangs fails the launch: every rank has the
collective ``timeout``, and the parent kills the group and raises once any
rank exits nonzero or the whole run outlives ``timeout``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from spt_tpu_torch.utils.device import DeviceLike, resolve_device

ROOT = Path(__file__).resolve().parents[2]


# ---------------------------------------------------------------------------
# The parent: launch
# ---------------------------------------------------------------------------


def _save_scene(path: Path, scene, camera) -> None:
    """A compiled SceneData and its Camera as one .npz of numpy arrays."""
    arrays = {f: scene_field.detach().cpu().numpy() for f, scene_field in (
        (f, getattr(scene, f)) for f in ("centers", "radii", "mat_id",
                                         "prim_valid", "light_idx",
                                         "light_valid", "sky_params"))}
    for f in dataclasses.fields(scene.materials):
        arrays[f"materials.{f.name}"] = \
            getattr(scene.materials, f.name).detach().cpu().numpy()
    if scene.env_map is not None:
        arrays["env_map"] = scene.env_map.detach().cpu().numpy()
    for f in dataclasses.fields(camera):
        arrays[f"camera.{f.name}"] = \
            getattr(camera, f.name).detach().cpu().numpy()
    arrays["static"] = np.array([scene.num_prims, scene.num_lights,
                                 scene.sky_mode], np.int64)
    np.savez(path, **arrays)


def launch(cases: list, world_size: int, *, scenes: dict,
           backend: str | None = None, device: DeviceLike = None,
           timeout: float = 300.0) -> list:
    """Run ``cases`` on ``world_size`` spawned ranks; rank 0's reports.

    ``scenes``: name -> (SceneData, Camera), sent to the ranks as arrays.
    ``device`` None is the card (RuntimeError where there is none);
    ``backend`` None is ``default_backend``'s.  Each rank runs torch on
    one intra-op thread (ranks share the host's cores).  Raises
    RuntimeError with the ranks' logs if a rank fails, TimeoutError if the
    run outlives ``timeout`` seconds; either way no rank is left
    running."""
    device = resolve_device(device)
    if backend is None:
        backend = default_backend(device, world_size)
    with tempfile.TemporaryDirectory(prefix="spt_dist_") as tmp:
        d = Path(tmp)
        for name, (scene, camera) in scenes.items():
            _save_scene(d / f"scene_{name}.npz", scene, camera)
        (d / "job.json").write_text(json.dumps(dict(
            cases=cases, backend=backend, device=str(device),
            timeout=timeout)))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in (env.get("PYTHONPATH"),) if p])
        logs = [open(d / f"rank{r}.log", "w") for r in range(world_size)]
        procs = []
        try:
            for r in range(world_size):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "spt_tpu_torch.tools.dist_worker",
                     str(r), str(world_size), str(d)], cwd=str(ROOT),
                    env=env, stdin=subprocess.DEVNULL, stdout=logs[r],
                    stderr=subprocess.STDOUT))
            _wait(procs, d, time.monotonic() + timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in logs:
                f.close()
        reports = json.loads((d / "result.json").read_text())
        for i, rep in enumerate(reports):
            path = d / f"arrays_{i}.npz"
            if path.exists():
                with np.load(path) as z:
                    rep.update({k: z[k] for k in z.files})
        return reports


def default_backend(device: torch.device, world_size: int) -> str:
    """"nccl" for one rank on the card, "gloo" otherwise: on the CPU, and
    for ranks that share the card (NCCL takes no two ranks on one
    device)."""
    return "nccl" if device.type == "cuda" and world_size == 1 else "gloo"


def _wait(procs, d: Path, deadline: float) -> None:
    """Wait for every rank; raise as soon as one fails or at ``deadline``."""
    while True:
        codes = [p.poll() for p in procs]
        bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            raise RuntimeError(f"rank {bad[0]} exited with {codes[bad[0]]}:\n"
                               + _tails(procs, d))
        if all(c == 0 for c in codes):
            return
        if time.monotonic() > deadline:
            raise TimeoutError("the ranks did not finish in time:\n"
                               + _tails(procs, d))
        time.sleep(0.05)


def _tails(procs, d: Path, n: int = 3000) -> str:
    out = []
    for r in range(len(procs)):
        p = d / f"rank{r}.log"
        text = p.read_text() if p.exists() else ""
        out.append(f"--- rank {r} ---\n{text[-n:]}")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# A rank: the cases
# ---------------------------------------------------------------------------


def _load_scene(path: Path, device):
    from spt_tpu_torch.core.convert import (camera_from_arrays,
                                            scene_data_from_arrays)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    num_prims, num_lights, sky_mode = (int(v) for v in arrays["static"])
    scene = scene_data_from_arrays(arrays, num_prims=num_prims,
                                   num_lights=num_lights, sky_mode=sky_mode,
                                   device=device)
    camera = camera_from_arrays(
        {k[len("camera."):]: v for k, v in arrays.items()
         if k.startswith("camera.")}, device=device)
    return scene, camera


def _gather(obj) -> list:
    """Every rank's ``obj``, in rank order, on every rank."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _case_forward(ctx, case, mesh, scene, camera):
    """The sample-sharded forward (``render_wavefront_sharded``)."""
    from spt_tpu_torch.parallel.wavefront_sharded import \
        render_wavefront_sharded
    img = render_wavefront_sharded(
        scene, camera, case["width"], case["height"], case.get("start", 0),
        case["spp"], mesh, **case.get("kw", {}))
    return {}, {"image": img}


def _case_prim_forward(ctx, case, mesh, scene, camera):
    """The prim-sharded forward (``render_wavefront_prim_sharded``) with its
    stats: the tie pixels of every rank, the streams held equal."""
    from spt_tpu_torch.parallel.wavefront_prim import \
        render_wavefront_prim_sharded
    stats = {}
    img = render_wavefront_prim_sharded(
        scene, camera, case["width"], case["height"], case.get("start", 0),
        case["spp"], mesh, stats=stats, **case.get("kw", {}))
    ctx["stats"] = stats
    return {}, {"image": img}


def _params(scene, fields):
    from spt_tpu_torch.diff import gradients as G
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in G.get_params(scene, tuple(fields)).items()}


def _ct(case, device):
    r = np.random.default_rng(case.get("ct_seed", 3))
    return torch.from_numpy(r.uniform(0.5, 1.5, (case["height"],
                                                 case["width"], 3))
                            .astype(np.float32)).to(device)


def _case_dp_grad(ctx, case, mesh, scene, camera):
    """The DP gradient (``make_wavefront_dp_render_fn``): one backward of
    ``sum(ct * image)``, then ``"steps"`` Adam steps (lr ``"lr"``) on an
    L2 loss against the render of the true parameters, from an albedo
    perturbed by ``"perturb"`` (numpy seed 3)."""
    from spt_tpu_torch.diff import gradients as G
    from spt_tpu_torch.parallel.wavefront_sharded import \
        make_wavefront_dp_render_fn
    timing = {}
    render = make_wavefront_dp_render_fn(
        scene, camera, case["width"], case["height"], spp=case["spp"],
        mesh=mesh, timing=timing, **case.get("kw", {}))
    fields = case.get("fields", ("albedo", "emission", "roughness",
                                 "centers", "radii"))
    params = _params(scene, fields)
    img = render(params, case.get("start", 0))
    (img * _ct(case, mesh.device)).sum().backward()
    arrays = {"image": img.detach()}
    arrays.update({f"grad.{k}": p.grad for k, p in params.items()})
    out = {"grad_allreduce_ms": timing.get("collective_ms"),
           "grad_vector_numel": timing.get("grad_numel")}
    steps = case.get("steps", 0)
    if steps:
        true_p = G.get_params(scene, ("albedo",))
        with torch.no_grad():
            target = render(true_p, case.get("start", 0))
        r = np.random.default_rng(3)
        albedo = torch.clamp(true_p["albedo"] + torch.from_numpy(r.uniform(
            -case["perturb"], case["perturb"],
            tuple(true_p["albedo"].shape)).astype(np.float32))
            .to(mesh.device), 0.0, 1.0)
        p = _params(G.apply_params(scene, {"albedo": albedo}),
                    case.get("step_fields", ("albedo", "roughness")))
        opt = torch.optim.Adam(list(p.values()), lr=case.get("lr", 0.02),
                               eps=1e-8)
        err0 = float((p["albedo"].detach() - true_p["albedo"]).abs().mean())
        losses, step_s = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = torch.mean((render(p, case.get("start", 0)) - target) ** 2)
            loss.backward()
            opt.step()
            with torch.no_grad():
                for k, v in G.clip_params(p).items():
                    p[k].copy_(v)
            losses.append(float(loss.detach()))
            step_s.append(time.perf_counter() - t0)
        out.update(losses=losses, step_s=step_s, albedo_err_start=err0,
                   albedo_err_end=float((p["albedo"].detach()
                                         - true_p["albedo"]).abs().mean()))
    return out, arrays


def _case_dp_step(ctx, case, mesh, scene, camera):
    """``make_dp_grad_step`` on an L2 loss against a fixed random image,
    each rank's render (``make_wavefront_render_fn``) over its own sample
    ids, ``"spd"`` a rank, at step ``"step_idx"``."""
    from spt_tpu_torch.kernels import wavefront_grad as wg
    from spt_tpu_torch.parallel.sharding import make_dp_grad_step
    spd = case["spd"]
    render = wg.make_wavefront_render_fn(
        scene, camera, case["width"], case["height"], spp=spd,
        **case.get("kw", {}))
    target = _ct(case, mesh.device)

    def loss_fn(p, ids):
        return torch.mean((render(p, int(ids[0])) - target) ** 2)

    step = make_dp_grad_step(loss_fn, mesh, spd)
    loss, grads = step(_params(scene, case.get("fields", ("albedo",))),
                       case.get("step_idx", 0))
    return {"loss": float(loss)}, {f"grad.{k}": g for k, g in grads.items()}


def _sharded(fn_name: str):
    """A case of one of ``parallel.sharding``'s renders: the image, and the
    rank's collectives (and the ring's ties, the strategy that ran) in
    ``ctx["stats"]``.  The case's ``"spp"`` sample ids from ``"start"``;
    ``render_sample_sharded`` takes ``spp / data`` a rank."""

    def case_fn(ctx, case, mesh, scene, camera):
        from spt_tpu_torch.parallel import sharding
        fn = getattr(sharding, fn_name)
        stats = {}
        start, spp = case.get("start", 0), case["spp"]
        if fn_name == "render_sample_sharded":
            args = (mesh.samples_per_rank(spp), mesh, start)
        else:
            args = (range(start, start + spp), mesh)
        img = fn(scene, camera, case["width"], case["height"], *args,
                 stats=stats, **case.get("kw", {}))
        ctx["stats"] = stats
        return {}, {"image": img}

    case_fn.__doc__ = f"``sharding.{fn_name}``."
    return case_fn


CASES = {"forward": _case_forward, "prim_forward": _case_prim_forward,
         "dp_grad": _case_dp_grad, "dp_step": _case_dp_step,
         "pixel": _sharded("render_pixel_sharded"),
         "sample": _sharded("render_sample_sharded"),
         "prim_gather": _sharded("render_prim_sharded_gather"),
         "prim_ring": _sharded("render_prim_sharded_ring"),
         "prim_auto": _sharded("render_prim_sharded")}


def _run_case(case, scenes, device):
    """One case on this rank -> rank 0's report (others: None) and its
    arrays.  Every rank enters the mesh's groups and the gathers."""
    import torch.distributed as dist
    from spt_tpu_torch.kernels import megakernel as mk
    from spt_tpu_torch.kernels import wavefront as wf
    from spt_tpu_torch.parallel.mesh import make_render_mesh
    mesh = make_render_mesh(case.get("data"), case.get("prim", 1),
                            device=device)
    ctx, out, arrays, wall = {}, {}, {}, None
    member = mesh.data_idx is not None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    dist.barrier()
    mk.reset_launch_counts()
    wf.GLUE_CALLS.update(dict.fromkeys(wf.GLUE_CALLS, 0))
    if member:
        scene, camera = scenes[case["scene"]]
        t0 = time.perf_counter()
        out, arrays = CASES[case["case"]](ctx, case, mesh, scene, camera)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    rank_info = dict(
        member=member, wall_s=wall, launches=dict(mk.LAUNCHES),
        glue_calls=dict(wf.GLUE_CALLS),
        peak_memory_gb=(torch.cuda.max_memory_allocated(device) / 1e9
                        if device.type == "cuda" else None),
        stats=ctx.get("stats"))
    ranks = _gather(rank_info)
    if dist.get_rank() != 0:
        return None, {}
    members = [r for r in ranks if r["member"]]
    launches = {k: sum(r["launches"][k] for r in members)
                for k in mk.LAUNCHES}
    glue_calls = {k: sum(r["glue_calls"][k] for r in members)
                  for k in wf.GLUE_CALLS}
    out = dict(out, case=case["case"], data=mesh.data, prim=mesh.prim,
               backend=mesh.backend, device=str(device),
               device_name=(torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
               launches=launches, glue_calls=glue_calls,
               walls_s=[r["wall_s"] for r in members],
               peak_memory_gb=[r["peak_memory_gb"] for r in members])
    stats = [r["stats"] for r in members if r["stats"] is not None]
    if stats:
        out["tie_pixels"] = sorted({p for s in stats
                                    for p in s.get("tie_pixels", [])})
        for key in ("tie_lanes", "stream_checks", "collective_bytes"):
            out[key] = [s.get(key, 0) for s in stats]
        if "strategy" in stats[0]:
            out["strategy"] = [s["strategy"] for s in stats]
        out["collectives"] = [len(s.get("collective_ms", [])) for s in stats]
        out["collective_ms"] = [sum(s.get("collective_ms", [])) for s in stats]
    return out, arrays


def main(argv) -> int:
    rank, world, d = int(argv[0]), int(argv[1]), Path(argv[2])
    job = json.loads((d / "job.json").read_text())
    from spt_tpu_torch.parallel.mesh import init_distributed
    torch.set_num_threads(1)
    device = resolve_device(job["device"])
    init_distributed(job["backend"], f"file://{d / 'rendezvous'}", world,
                     rank, job["timeout"])
    try:
        scenes = {p.name[len("scene_"):-len(".npz")]: _load_scene(p, device)
                  for p in sorted(d.glob("scene_*.npz"))}
        reports = []
        for i, case in enumerate(job["cases"]):
            out, arrays = _run_case(case, scenes, device)
            if rank == 0:
                reports.append(out)
                if arrays:
                    np.savez(d / f"arrays_{i}.npz", **{
                        k: v.detach().cpu().numpy() for k, v in
                        arrays.items()})
        if rank == 0:
            tmp = d / "result.json.tmp"
            tmp.write_text(json.dumps(reports))
            os.replace(tmp, d / "result.json")
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
