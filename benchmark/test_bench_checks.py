"""The check of each cell on the CPU at a small size: the sound program is
correct; the bfloat16 control and every planted fault are not.

Each run drives the whole harness (set-up, window, check) with the look
for a card skipped and the port's plain versions in place of its kernels.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import faults, harness  # noqa: E402

SMALL = {
    "cornell512.render": {
        "config": {"render": {"width": 16, "height": 12}},
        "traffic": {"spp": 8, "warmup_spp": 4},
        "check": {"pixels": 64}},
    "scene10k.render": {
        "config": {"render": {"width": 24, "height": 16},
                   "scene": {"count": 2100}},
        "traffic": {"spp": 4, "warmup_spp": 2},
        "check": {"pixels": 96}},
    "cornell512.inverse": {
        "config": {"render": {"width": 24, "height": 24}},
        "traffic": {"spp_per_step": 4, "target_spp": 8}},
}
SEED = 2**31 + 12345


def _run(cell, **kw):
    result, lines = harness.run(cell, SEED, 0.5, False, device="cpu",
                                overrides=SMALL[cell], **kw)
    return result


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_program_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1


@pytest.mark.parametrize("cell", ["cornell512.render", "cornell512.inverse"])
def test_bfloat16_control_is_not_correct(cell):
    r = _run(cell, lowp=True)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in ("cornell512.render",) for f in faults.RENDER] + [
    ("cornell512.inverse", f) for f in faults.INVERSE])
def test_planted_fault_is_not_correct(cell, fault):
    r = _run(cell, fault=fault)
    assert not r["correct"], (fault, r["checks"])
    assert r["failed"] >= 1


def test_images_kept_are_copies(monkeypatch):
    """A facade that accumulates into one buffer in place, reused from
    image to image, is still correct: the answers kept are copies."""
    from spt_tpu_torch.engine import api

    def render(self, spp=None):
        self._invalidate()
        s = self._settings
        spp = (1 if s.progressive else s.samples_per_pixel) \
            if spp is None else spp
        chunk = self._render_samples(self._frame_count, spp)
        if self._frame_count == 0:
            self._accum.copy_(chunk)
        else:
            self._accum += chunk
        self._frame_count += spp

    def zeros(self, s):
        buf = getattr(self, "_one_buffer", None)
        if buf is None or buf.shape != (s.height, s.width, 3):
            self._one_buffer = buf = api.torch.zeros(
                (s.height, s.width, 3), device=self.device)
        return buf.zero_()
    monkeypatch.setattr(api.PathTracerBase, "render", render)
    monkeypatch.setattr(api.PathTracerBase, "_zeros", zeros)
    r, _ = harness.run("cornell512.render", SEED, 5.0, False, device="cpu",
                       overrides=SMALL["cornell512.render"])
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 2


def test_a_fault_after_the_first_steps_is_not_correct(monkeypatch):
    """Steps that go wrong only once the first ones are past (Adam's
    update skipped from the window's second step on) are caught by the
    stretch the reference follows from a step of the window (its later
    steps run after the window where it closed first)."""
    from spt_tpu_torch.diff import gradients
    orig = gradients.InverseRenderer.step
    first = SMALL["cornell512.inverse"]["traffic"].get("checked_steps", 3)

    def step(self):
        if self.step_count > first:
            self.opt.step = lambda *a, **k: None
        return orig(self)
    monkeypatch.setattr(gradients.InverseRenderer, "step", step)
    result, lines = harness.run("cornell512.inverse", SEED, 2.0, False,
                                device="cpu",
                                overrides=SMALL["cornell512.inverse"])
    assert result["attempted"] >= 1
    assert not result["correct"], (result["checks"], lines)
