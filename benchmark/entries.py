"""The entries that a traffic mix drives, by the ``entry`` of its file.

Each entry has ``setup()`` (build, warm up: the set-up time; the
benchmark's own reference work in it is recorded as ``reference_s`` and
left out), ``window(seconds)`` (the measured loop; returns the end-to-end
readings), ``outputs()`` (what the timed path produced, kept for the
check) and ``free()`` (drops the program's state before the reference
runs).

* ``facade_render``: the progressive facade of ``create_path_tracer
  ("cuda")``, closed loop, one client.  Each request re-poses the camera
  (``set_camera``, which resets the accumulation as an editor does on a
  camera move), calls ``render_to_completion()`` to the traffic's sample
  count in the facade's own chunks and reads ``get_render_result()``.
  The window closes at the first image that ends after ``seconds``.
* ``inverse_step``: ``diff.gradients.InverseRenderer(backend="cuda")``
  recovering the traffic's material fields from a target image; set-up
  runs its first ``checked_steps`` steps, the window the steps after
  them.  The reference follows two stretches of ``checked_steps`` steps:
  the first ones, from the start, and those from a step of the window
  drawn from the seed, from the parameters and Adam's state the program
  had there.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import scenes
from .reference import render as ref


def sync(device) -> None:
    """Wait for the card (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def render_settings(config: dict) -> ref.Settings:
    r = config["render"]
    return ref.Settings(width=r["width"], height=r["height"],
                        max_bounces=r["max_bounces"], rr_depth=r["rr_depth"],
                        use_nee=r["use_nee"], use_mis=r["use_mis"],
                        seed=r["seed"])


class FacadeRender:
    def __init__(self, T, config, traffic, seed, device, rec):
        self.T, self.config, self.traffic = T, config, traffic
        self.seed, self.device, self.rec = seed, device, rec
        self.st = render_settings(config)

    def _camera(self, pose):
        return self.T.Camera.look_at(pose["position"], pose["target"],
                                     fov_degrees=pose["fov_degrees"],
                                     device=self.device)

    def setup(self):
        T, r = self.T, self.config["render"]
        t0 = time.perf_counter()
        self.desc = scenes.describe(self.config, self.seed)
        scene = scenes.port_scene(T, self.desc)
        self.rec.add("scene_graph_s", time.perf_counter() - t0)
        tracer = T.create_path_tracer("cuda", device=self.device)
        tracer.set_scene(scene)
        s = T.RenderSettings()
        s.set_resolution(r["width"], r["height"])
        s.samples_per_pixel = self.traffic["spp"]
        s.max_bounces, s.russian_roulette_depth = (r["max_bounces"],
                                                   r["rr_depth"])
        s.use_nee, s.use_mis, s.seed = r["use_nee"], r["use_mis"], r["seed"]
        tracer.set_settings(s)
        self.tracer = tracer
        # Warm up the kernels of the traffic: one chunk of the
        # configuration's own pose, and the image's read.
        tracer.set_camera(self._camera(scenes.home_pose(self.config)))
        tracer.render(spp=min(self.traffic["warmup_spp"], self.traffic["spp"]))
        tracer.get_render_result()
        sync(self.device)
        self.rec.add("compile_s", tracer.compile_seconds)
        if self.rec.tracing:
            self._span_render_calls()

    def _span_render_calls(self):
        """Time each ``render()`` call that ``render_to_completion`` makes
        (the span ``render_call_s``, the trace's ``bench.render``)."""
        tracer, rec = self.tracer, self.rec
        chunk = tracer.render

        def render(spp=None):
            with rec.scope("bench.render"):
                t0 = time.perf_counter()
                chunk(spp=spp)
                rec.add("render_call_s", time.perf_counter() - t0)
        tracer.render = render

    def window(self, seconds: float) -> dict:
        tracer = self.tracer
        keep = self.traffic["keep_images"]
        px = self.st.width * self.st.height
        pick = np.random.default_rng(scenes.seed_words(self.seed, 0x5EED))
        self.kept, self.last = [], None
        samples, latencies, index = 0, [], 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            pose = scenes.pose(self.config, self.seed, index)
            t_img = time.perf_counter()
            with self.rec.scope("bench.set_camera"):
                tracer.set_camera(self._camera(pose))
            with self.rec.scope("bench.render_to_completion"):
                tracer.render_to_completion()
            with self.rec.scope("bench.get_render_result"):
                tracer.get_render_result()
                sync(self.device)
            latencies.append(time.perf_counter() - t_img)
            samples += tracer.frame_count * px
            # A copy: the facade may reuse its buffer for the next image.
            answer = (index, pose, tracer.get_state()["accum"].clone(),
                      tracer.frame_count)
            # A sample of the finished images drawn from the seed
            # (reservoir sampling), and the last one.
            if index < keep:
                self.kept.append(answer)
            else:
                j = int(pick.integers(0, index + 1))
                if j < keep:
                    self.kept[j] = answer
            self.last = answer
            index += 1
            if time.perf_counter() >= deadline:
                break
        sync(self.device)
        return dict(window_s=time.perf_counter() - t0, samples=samples,
                    images=len(latencies), latencies_s=latencies,
                    requests=index)

    def outputs(self) -> list:
        """(image index, pose, radiance sum (H, W, 3), samples) of each
        answer checked: the kept images and the last one."""
        out = {a[0]: a for a in self.kept}
        out[self.last[0]] = self.last
        return [out[k] for k in sorted(out)]

    def free(self):
        self.tracer = None


class InverseStep:
    def __init__(self, T, config, traffic, seed, device, rec):
        self.T, self.config, self.traffic = T, config, traffic
        self.seed, self.device, self.rec = seed, device, rec
        self.st = render_settings(config)

    def start_materials(self, desc):
        """Albedo and roughness moved uniformly within the traffic's
        ``perturb`` from the true ones, drawn from the seed, clipped to
        ``bounds``."""
        rng = np.random.default_rng(scenes.seed_words(self.seed, 0x1A7))
        out = {}
        for f in ("albedo", "roughness"):
            v = np.asarray(desc[f], np.float64)
            if f in self.traffic["fields"]:
                lo, hi = self.traffic["bounds"][f]
                v = np.clip(v + rng.uniform(-1, 1, v.shape)
                            * self.traffic["perturb"][f], lo, hi)
            out[f] = v.astype(np.float32)
        return out

    def setup(self):
        from spt_tpu_torch.diff import gradients
        T, tr, r = self.T, self.traffic, self.config["render"]
        t0 = time.perf_counter()
        self.true_desc = scenes.describe(self.config, self.seed)
        start = self.start_materials(self.true_desc)
        self.desc = scenes.with_materials(self.true_desc, start["albedo"],
                                          start["roughness"])
        scene = scenes.port_scene(T, self.desc)
        self.rec.add("scene_graph_s", time.perf_counter() - t0)
        t0 = time.perf_counter()
        sd = scene.compile(device=self.device)
        self.rec.add("compile_s", time.perf_counter() - t0)
        self.pose = scenes.home_pose(self.config)
        # The target: the true scene rendered by the benchmark's reference
        # at sample ids no step uses; its seconds are not the program's.
        sync(self.device)
        t0 = time.perf_counter()
        first = tr["target_first_sample"]
        self.target = ref.render_image(
            ref.scene_tables(self.true_desc, self.device),
            ref.camera_blob(self.pose, self.device),
            list(range(first, first + tr["target_spp"])), self.st)
        sync(self.device)
        self.rec.add("reference_s", time.perf_counter() - t0)
        cam = T.Camera.look_at(self.pose["position"], self.pose["target"],
                               fov_degrees=self.pose["fov_degrees"],
                               device=self.device)
        self.inv = gradients.InverseRenderer(
            sd, cam, self.target, fields=tuple(tr["fields"]),
            spp_per_step=tr["spp_per_step"],
            learning_rate=tr["learning_rate"], max_bounces=r["max_bounces"],
            use_nee=r["use_nee"], seed=r["seed"], backend="cuda")
        # The first steps, which the reference follows from the start.
        self.stretches = [self._snapshot()]
        for _ in range(tr["checked_steps"]):
            self._step()
        sync(self.device)

    def _snapshot(self) -> dict:
        """The state before the next step: its index, the parameters and
        Adam's moments (zeros before the first step), and room for the
        readings of the steps that follow."""
        opt = self.inv.opt
        snap = dict(step=self.inv.step_count, params={}, m={}, v={},
                    losses=[])
        for k, p in self.inv.params.items():
            st = opt.state.get(p, {})
            snap["params"][k] = p.detach().clone()
            for key, name in (("m", "exp_avg"), ("v", "exp_avg_sq")):
                x = st.get(name)
                snap[key][k] = torch.zeros_like(p.detach()) if x is None \
                    else x.detach().clone()
        return snap

    def _step(self) -> None:
        """One step, its readings added to each stretch still open: its
        loss; after a stretch's first step the gradient that Adam got (the
        first step's from Adam's first moment, m1 = (1 - beta1) g; a later
        one's as the parameters' ``grad``, which Adam read); after its
        last the parameters."""
        with self.rec.scope("bench.step"):
            loss = self.inv.step()
        n = self.traffic["checked_steps"]
        for snap in self.stretches:
            if len(snap["losses"]) >= n:
                continue
            snap["losses"].append(loss)
            if len(snap["losses"]) == 1:
                snap["grad"] = self.adam_grad() if snap["step"] == 0 else {
                    k: p.grad.detach().clone()
                    for k, p in self.inv.params.items()}
            if len(snap["losses"]) == n:
                snap["after"] = {k: v.detach().clone()
                                 for k, v in self.inv.params.items()}

    def adam_grad(self) -> dict:
        """The first gradient, from Adam's first moment after one step
        (m1 = (1 - beta1) g)."""
        opt = self.inv.opt
        beta1 = opt.param_groups[0]["betas"][0]
        out = {}
        for k, p in self.inv.params.items():
            m = opt.state.get(p, {}).get("exp_avg")    # none: no step taken
            out[k] = torch.zeros_like(p.detach()) if m is None \
                else (m / (1.0 - beta1)).detach().clone()
        return out

    def window(self, seconds: float) -> dict:
        # The window's stretch starts at a step drawn from the seed,
        # uniformly over the window's steps (reservoir sampling).
        pick = np.random.default_rng(scenes.seed_words(self.seed, 0x57E9))
        steps = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            if int(pick.integers(0, steps + 1)) == 0:
                self.stretches[1:] = [self._snapshot()]
            self._step()
            steps += 1
        sync(self.device)
        return dict(window_s=time.perf_counter() - t0, steps=steps,
                    requests=steps)

    def outputs(self) -> list:
        """Each stretch the reference follows (``_snapshot``'s, with its
        ``checked_steps`` losses, ``grad`` and ``after``); the window's
        last steps, after the window, where it closed inside its
        stretch."""
        while len(self.stretches[-1]["losses"]) < \
                self.traffic["checked_steps"]:
            self._step()
        return list(self.stretches)

    def free(self):
        self.inv = None


ENTRIES = {"facade_render": FacadeRender, "inverse_step": InverseStep}
