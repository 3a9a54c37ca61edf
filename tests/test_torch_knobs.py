"""The wavefront's A/B knobs in the port, on the CPU, torch only.

* ``sort_every``, ``rowsort``, ``dir_major``, ``dbits``, ``qbits`` and
  ``block`` on ``render_wavefront``'s split, fused (``split=False``, the
  precull's lists) and matmul-form (``mxu``) routes, and ``tcull=False`` on
  the two routes that sweep lists, each render equal to the same route's
  default bit for bit (with the gradient sky; ``tcull`` with the env map
  too), as tests/test_wavefront.py pins JAX's: the sort is a permutation
  the estimator cannot see, and the t exits only skip what cannot win.
  Each sort knob is checked to have moved the stream.
* The plain K6l, K6m and K11 sweeps with ``tcull=False``: the same
  winners (and K11's state and record) as with the t exits, more spheres
  tested.
* ``make_wavefront_render_fn`` with ``sort_every=0``, ``dir_major=False``,
  ``compact=False`` and, fused, ``tcull=False``: the value equal to the
  default's, the gradients to 1e-6 relative L2 a field (the plain K10's
  sums follow the lane order).
* ``rowsort``: whole 128-lane rows, ordered by their least key, the alive
  prefix counted in rows and rounded up to tiles.
* The knobs' errors (``check_knobs``) raised before any launch by every
  entry point, and ``render_wavefront_sharded`` passing them through.

Config 5 cut to 150 spheres, leaf block 8, 16x16 pixels, 1 spp, depth 3,
every sort run.  The key against JAX's and one whole render against JAX's
are in ``test_torch_knobs_jax.py``.
"""

import types

import numpy as np
import pytest
import torch

import spt_tpu_torch
from spt_tpu_torch.diff import gradients as TG
from spt_tpu_torch.kernels import megakernel as tmega
from spt_tpu_torch.kernels import wavefront as twf
from spt_tpu_torch.kernels import wavefront_grad as twg
from spt_tpu_torch.parallel import wavefront_sharded as tws
from chip_smoke import (CAM_10K, env_gradient, scene_10k, wf_advance,
                        wf_bounce, wf_inputs)

# One intra-op thread: these tests trace small tensors, where torch's
# idle OpenMP workers would only spin against the other test processes.
torch.set_num_threads(1)

CPU = "cpu"
W = H = 16
KW = dict(max_bounces=3, rr_depth=2, use_nee=True, use_mis=True, seed=5,
          block=8, sort_min_rays=0)
ROUTES = {"split": {}, "fused": dict(split=False),
          "mxu": dict(mxu=True)}
SORT_KNOBS = {"sort_every=0": dict(sort_every=0),
              "sort_every=2": dict(sort_every=2),
              "rowsort": dict(rowsort=True),
              "dir_major=False": dict(dir_major=False),
              "dbits=2": dict(dbits=2), "qbits=5": dict(qbits=5)}


def _scene(sky="gradient"):
    scene = scene_10k(spt_tpu_torch, n=150)
    if sky == "envmap":
        scene.set_environment_map(env_gradient(16, 32))
    return scene.compile(device=CPU)


def _camera():
    return spt_tpu_torch.Camera.look_at(device=CPU, **CAM_10K)


_SCENES = {}


def _render(sky, route, knob, monkeypatch=None):
    """(image, the stream's pixel ids after each sort) of one render."""
    if sky not in _SCENES:
        _SCENES[sky] = _scene(sky)
    orders = []
    if monkeypatch is not None:
        sort = twf._sort_rays

        def spy(buf, n_lanes, *a):
            out = sort(buf, n_lanes, *a)
            orders.append(buf[twf.N_CH].clone())
            return out
        monkeypatch.setattr(twf, "_sort_rays", spy)
    img = twf.render_wavefront(_SCENES[sky], _camera(), W, H, 0, 1,
                               **dict(KW, **ROUTES[route], **knob))
    return img, orders


_DEFAULTS = {}


def _default(sky, route, monkeypatch):
    if (sky, route) not in _DEFAULTS:
        _DEFAULTS[sky, route] = _render(sky, route, {}, monkeypatch)
    return _DEFAULTS[sky, route]


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("knob", sorted(SORT_KNOBS) + ["block=16"])
def test_knob_render_equals_default(route, knob, monkeypatch):
    """A sort knob or another leaf width: the route's image bit for bit,
    and (the sort knobs) the stream in another order after some sort."""
    want, want_orders = _default("gradient", route, monkeypatch)
    kw = dict(block=16) if knob == "block=16" else SORT_KNOBS[knob]
    got, orders = _render("gradient", route, kw, monkeypatch)
    assert float(want.mean()) > 0.05
    assert torch.equal(got, want), \
        f"{int((got != want).any(-1).sum())} pixels apart"
    if knob == "block=16":
        return
    moved = len(orders) != len(want_orders) or any(
        not torch.equal(a, b) for a, b in zip(orders, want_orders))
    assert moved, f"{knob} sorted the stream as the default does"


@pytest.mark.parametrize("sky", ["gradient", "envmap"])
@pytest.mark.parametrize("route", ["fused", "mxu"])
def test_tcull_off_render_equals_default(route, sky, monkeypatch):
    want, _ = _default(sky, route, monkeypatch)
    got, _ = _render(sky, route, dict(tcull=False))
    assert float(want.mean()) > 0.05
    assert torch.equal(got, want), \
        f"{int((got != want).any(-1).sum())} pixels apart"


def test_plain_sweeps_without_tcull():
    """K6l, K6m and K11 (K11g's record) on bounces 0 and 1 of the scene,
    their lists swept whole with ``tcull=False``: the same residual (and
    state) bit for bit, more spheres tested."""
    sd, cam = _scene(), _camera()
    t, stc, meta = wf_inputs(torch, twf, twf, sd, cam, 5)
    block = stc["block"]
    lob, hib = twf._leaf_block_bounds(t["prims"].reshape(-1, 5, block))
    boxes = twf.leaf_boxes(lob, hib)
    bctr, cslot = twf.mxu_tables(dict(prims=t["prims"]), block)
    b = wf_bounce(torch, twf, t, stc, meta, W, H, 0, 5)
    spheres = {(key, tcull): 0 for key in ("k6l", "k6m", "k11")
               for tcull in (True, False)}
    for k in (0, 1):
        if k:
            b = wf_advance(torch, twf, t, stc, meta, b, 0, 5, sd.sky_mode)
        st, ids, n = b["st"], b["ids"], b["n"]
        rows = twf.precull_tiles(
            tuple(st[c, :n] for c in range(3)),
            tuple(st[c, :n] for c in range(3, 6)), st[twf.C_ALIVE, :n],
            None, lob, hib, per_row=True)
        kw11 = dict(k=k, block=block, n_mats=stc["n_mats"],
                    n_light_slots=stc["n_light_slots"], rr_depth=2,
                    use_nee=True, use_mis=True, sky_mode=sd.sky_mode,
                    precull=True, boxes=boxes)
        outs = {}
        for tcull in (True, False):
            stats = {k_: {} for k_ in ("k6l", "k6m", "k11")}
            k6l = twf.isect_plain(t["prims"], b["cand"], b["ctn"], st, n,
                                  block=block, stats=stats["k6l"],
                                  tcull=tcull)
            k6m = twf.isect_mxu_plain(t["prims"], cslot, bctr, *rows, st, n,
                                      block=block, boxes=boxes,
                                      stats=stats["k6m"], tcull=tcull)
            st11, rec = twg.bounce_fwd_plain(
                t["blob"], meta, t["lsb"], t["nodef"], t["nodei"],
                t["prims"], t["mtypes"], b["cand"], b["ctn"], st, ids, n,
                stats=stats["k11"], tcull=tcull, **kw11)
            outs[tcull] = (k6l, k6m, st11[:, :n], rec), stats
        for a, c in zip(outs[True][0], outs[False][0]):
            assert torch.equal(a.view(torch.int32), c.view(torch.int32)), \
                f"bounce {k}"
        for key in ("k6l", "k6m", "k11"):
            for tcull in (True, False):
                spheres[key, tcull] += outs[tcull][1][key]["spheres"]
        assert outs[False][1]["k6l"]["list_words"] \
            < outs[True][1]["k6l"]["list_words"]   # no bound read
    for key in ("k6l", "k6m", "k11"):
        assert spheres[key, False] > spheres[key, True], key


@pytest.mark.parametrize("case", ["sort_every=0", "dir_major=False",
                                  "compact=False", "fused_tcull=False"])
def test_grad_knobs_invisible(case):
    sd, cam = _scene(), _camera()
    keys = ("albedo", "centers", "radii")
    kw = dict(spp=1, max_bounces=3, rr_depth=2, seed=5, sort_min_rays=0,
              block=8)
    knob = {"sort_every=0": dict(sort_every=0),
            "dir_major=False": dict(dir_major=False),
            "compact=False": dict(compact=False),
            "fused_tcull=False": dict(split=False, tcull=False)}[case]
    base = dict(split=False) if case.startswith("fused") else {}
    out = []
    for k in (base, knob):
        params = {key: v.clone().requires_grad_(True)
                  for key, v in TG.get_params(sd, keys).items()}
        render = twg.make_wavefront_render_fn(sd, cam, W, H, **kw, **k)
        img = render(params, 0)
        img.sum().backward()
        out.append((img.detach(), {key: params[key].grad for key in keys}))
    (img0, g0), (img1, g1) = out
    assert float(img0.mean()) > 0.05
    assert torch.equal(img0, img1)
    for key in keys:
        err = float(torch.linalg.norm(g1[key] - g0[key])
                    / torch.linalg.norm(g0[key]))
        assert err <= 1e-6, (key, err)


def test_rowsort_keeps_rows_whole():
    """``_sort_rays(rowsort=True)``: each 128-lane row moves whole, rows
    in order of their least key (stable), and the alive prefix is the
    rows with an alive lane, rounded up to tiles."""
    sd, cam = _scene(), _camera()
    t, stc, meta = wf_inputs(torch, twf, twf, sd, cam, 5)
    st, ids = twf.raygen_plain(t["blob"], meta, width=64, height=32,
                               chunk_spp=2, dof=False)
    buf = twf._stream_buffer(st, ids).clone()
    r = np.random.default_rng(4)
    dead = torch.from_numpy(r.random(buf.shape[1]) < 0.5)
    buf[twf.C_ALIVE] = torch.where(dead, 0.0, buf[twf.C_ALIVE])
    buf[twf.C_ALIVE, :3 * twf.TILE] = 0.0      # three tiles all dead
    buf[twf.C_ALIVE, 300] = 1.0                # but one lane of row 2
    lo, ext = twf._scene_sort_bounds(t["nodef"])
    before = buf.clone()
    key = twf._coherence_key(before, lo, ext)
    n_tiles = twf._sort_rays(buf, buf.shape[1], lo, ext, rowsort=True)
    row_key = key.reshape(-1, twf.ROW).amin(1)
    rows = torch.sort(row_key, stable=True).indices
    assert torch.equal(buf, before.reshape(19, -1, twf.ROW)[:, rows]
                       .reshape(19, -1))
    alive_rows = int((row_key < twf._dead_key(twf.Q_BITS)).sum())
    assert n_tiles == -(-alive_rows // 8)
    assert alive_rows % 8 and n_tiles * 8 > alive_rows


def test_knob_errors_before_any_launch():
    sd, cam = _scene(), _camera()
    bad = [dict(sort_every=-1), dict(qbits=0), dict(dbits=-1),
           dict(qbits=6, dbits=3), dict(qbits=9, dir_major=False)]
    for kw in bad:
        before = dict(tmega.LAUNCHES)
        with pytest.raises(ValueError):
            twf.render_wavefront(sd, cam, W, H, 0, 1, **kw)
        with pytest.raises(ValueError):
            twg.make_wavefront_render_fn(sd, cam, W, H, spp=1, **kw)
        assert dict(tmega.LAUNCHES) == before, kw
    with pytest.raises(ValueError):
        twf._live_bits(5, 4)
    # dbits counts only where the key is direction-major
    twf.check_knobs(qbits=8, dbits=5, dir_major=False)
    assert twf._live_bits(4) == twf._live_bits(4, 0) == 15


def test_sharded_render_passes_knobs(monkeypatch):
    seen = {}

    def render(*a, **kw):
        seen.update(kw)
        return torch.ones(2, 2, 3)
    monkeypatch.setattr(twf, "render_wavefront", render)
    monkeypatch.setattr(tws, "all_reduce", lambda img, *a: img)
    mesh = types.SimpleNamespace(
        samples_per_rank=lambda spp: spp, check_member=lambda: None,
        data_idx=0, data_group=None, backend="gloo")
    knobs = dict(sort_every=2, qbits=5, dir_major=False, dbits=1,
                 rowsort=True, tcull=False, split=False)
    tws.render_wavefront_sharded(None, None, 2, 2, 0, 1, mesh, **knobs)
    assert {k: seen[k] for k in knobs} == knobs


def test_rowsort_backward_is_exact():
    """``_sort_rays_diff(rowsort=True)``: a row permutation under autograd;
    each lane's cotangent comes back to the lane it came from."""
    sd, cam = _scene(), _camera()
    t, _, meta = wf_inputs(torch, twf, twf, sd, cam, 5)
    st, ids = twf.raygen_plain(t["blob"], meta, width=64, height=32,
                               chunk_spp=1, dof=False)
    st = st.clone()
    st[twf.C_ALIVE, :twf.TILE] = 0.0          # the first tile dead
    st.requires_grad_(True)
    lo, ext = twf._scene_sort_bounds(t["nodef"])
    out, ids_s, nalive = twg._sort_rays_diff(st, ids, st.shape[1], lo, ext,
                                             rowsort=True)
    assert nalive == 1 and not torch.equal(ids_s, ids)
    ct = torch.from_numpy(np.random.default_rng(7).normal(
        size=tuple(st.shape)).astype(np.float32))
    out.backward(ct)
    # Where each output lane came from: match the (sample, pixel) keys.
    src = {int(k): i for i, k in enumerate(
        (ids[1].long() * (1 << 20) + ids[0].long()).tolist())}
    perm = torch.tensor([src[int(k)] for k in (
        ids_s[1].long() * (1 << 20) + ids_s[0].long()).tolist()])
    assert torch.equal(out.detach(), st.detach()[:, perm])
    want = torch.zeros_like(ct).index_copy_(1, perm, ct)
    assert torch.equal(st.grad.view(torch.int32), want.view(torch.int32))
