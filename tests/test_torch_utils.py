"""The port's utilities against the JAX package's: invariant checks,
traces on torch.profiler, the timer and the render statistics.

``RenderStats`` must equal JAX's on the same records exactly (the same
float sums); the rest are behaviours: the caller's location in a
``VerifyError``, a NaN or an infinity caught by ``checked_fn`` among the
outputs and, made and masked, among the intermediate values, a
``trace_scope`` named in a trace ``capture_trace`` writes on the CPU.
"""

import glob
import gzip
import json
import os

import numpy as np
import pytest
import torch

from spt_tpu.utils import profiling as jprof
from spt_tpu_torch.utils import assertions as A
from spt_tpu_torch.utils import profiling as P

torch.set_num_threads(1)


def test_verify_and_check_name_the_caller():
    A.verify(True)
    A.check(1 == 1)
    with pytest.raises(A.VerifyError, match=r"boom \[.*test_torch_utils\.py"
                       r":\d+ in test_verify_and_check_name_the_caller\]"):
        A.verify(False, "boom")
    with pytest.raises(A.VerifyError, match="test_torch_utils.py"):
        A.check(False)
    assert issubclass(A.VerifyError, AssertionError)


def test_checked_fn_raises_on_nan_and_inf():
    def f(x):
        return {"y": torch.log(x), "n": torch.tensor([1, 2])}, x * 2
    g = A.checked_fn(f)
    out, twice = g(torch.tensor([1.0, 2.0]))
    torch.testing.assert_close(twice, torch.tensor([2.0, 4.0]))
    with pytest.raises(A.VerifyError, match="NaN"):
        g(torch.tensor([1.0, -1.0]))
    with pytest.raises(A.VerifyError, match="infinity"):
        g(torch.tensor([0.0, 1.0]))


def test_checked_fn_checks_intermediate_values():
    """A NaN made and then masked inside ``fn`` raises, naming the op and
    the check; so does a division by zero; ``errors=`` picks the checks."""
    def masked(x):
        return torch.where(x > 0, torch.sqrt(x), 0.0)

    def ratio(x):
        return torch.where(x != 0, x / x.sum(), 0.0)

    x = torch.tensor([1.0, -1.0])
    with pytest.raises(A.VerifyError, match=r"aten\.sqrt made a NaN"):
        A.checked_fn(masked)(x)
    with pytest.raises(A.VerifyError, match=r"aten\.div divided by zero "
                                            r"\(check 'div'\)"):
        A.checked_fn(ratio)(x)
    torch.testing.assert_close(A.checked_fn(masked, errors=A.INDEX_CHECKS)(x),
                               torch.tensor([1.0, 0.0]))
    with pytest.raises(A.VerifyError, match="div"):
        A.checked_fn(ratio, errors={"div"})(x)
    A.checked_fn(ratio, errors={"nan", "inf"})(torch.tensor([1.0, 2.0]))
    assert A.FLOAT_CHECKS | A.INDEX_CHECKS == A.ALL_CHECKS
    with pytest.raises(ValueError, match="unknown checks"):
        A.checked_fn(masked, errors={"oob"})
    with pytest.raises(IndexError):
        A.checked_fn(lambda t: t[torch.tensor([5])])(x)


def test_checked_fn_passes_a_clean_plain_render():
    """K1's and the wavefront's plain versions (the wavefront's buffers
    start uninitialised, ``torch.empty``) run clean under every check."""
    from chip_smoke import CAM_10K, scene_10k
    from spt_tpu_torch.kernels import megakernel, wavefront
    import spt_tpu_torch as T
    cam = T.Camera.look_at(device="cpu", position=(0, 1.0, -1.5),
                           target=(0, 1.0, 3.0), fov_degrees=55)
    sd = T.demo_scene_38_spheres().compile(device="cpu")
    img = A.checked_fn(megakernel.render_tiles)(sd, cam, 8, 8, 0, 1,
                                                max_bounces=3)
    assert float(img.mean()) > 0.0
    sd = scene_10k(T, n=300).compile(device="cpu")
    img = A.checked_fn(wavefront.render_wavefront)(
        sd, T.Camera.look_at(device="cpu", **CAM_10K), 8, 8, 0, 1,
        max_bounces=3, block=8)
    assert float(img.mean()) > 0.0


def test_capture_trace_names_a_trace_scope(tmp_path):
    d = str(tmp_path / "prof")
    x = torch.arange(64, dtype=torch.float32)
    with P.capture_trace(d):
        with P.trace_scope("render_chunk_0"):
            y = (x * 2).sum()
    assert float(y) == 4032.0
    files = glob.glob(os.path.join(d, "*.pt.trace.json*"))
    assert len(files) == 1
    opener = gzip.open if files[0].endswith(".gz") else open
    with opener(files[0], "rt") as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "render_chunk_0" in names


def test_timer_times_a_block():
    with P.Timer(sync={"a": [torch.zeros(2)]}) as t:
        torch.ones(8).sum()
    assert t.elapsed > 0.0


def test_render_stats_equal_jax():
    records = [(0.25, 1000, 3000), (0.5, 2000, None), (0.125, 500, 900)]
    got, want = P.RenderStats(window=2), jprof.RenderStats(window=2)
    assert got.summary() == want.summary()
    for rec in records:
        got.record(*rec)
        want.record(*rec)
    occ = np.array([1.0, 0.75, 0.5], np.float32)
    got.record_occupancy(torch.from_numpy(occ))
    want.record_occupancy(occ)
    assert got.summary() == want.summary()
    assert (got.fps, got.paths_per_second, got.rays_per_second) == \
        (want.fps, want.paths_per_second, want.rays_per_second)
