"""The least work of each hand-written kernel, for the kernels' roofline.

A frozen copy of the port's count arithmetic at commit
1ae0631e9a6a2afc017f1275ca928f65cb92b419: ``K1_OPS`` and ``k1_op_count``
(``spt_tpu_torch/kernels/megakernel.py``), ``K2_OPS`` and
``k2_op_count`` (``kernels/megakernel_grad.py``), ``WF_OPS`` and the
byte counts of K5, K6 and K7 (``kernels/wavefront.py``, ``chip_smoke.py``
for K5), with the table of peaks.  The counts it is fed are the
benchmark's own: the reference's rays, hits, shadow rays and lit lanes
on a sample of the window's paths (``check.py``), scaled to the window.

What depends on the port's own data structures stays out: a tree walk's
node tests and the spheres its leaves hold (K6 is held to the winner's
test and its bytes, K7 to its shading and bytes, its shadow walk left
out), and the words of the tree beyond one read of every sphere.  So
each count is a lower one, and a share of it cannot pass 100% unless the
time leaves out work.
"""

from __future__ import annotations

# One H100 SXM (NVIDIA's data sheet): fp32 outside the tensor cores, an
# FMA counted as two, and HBM3.
FP32_PEAK = 67e12
HBM_RATE = 3.35e12

K1_OPS = dict(raygen=38, sphere_test=18, miss=6, hit=116, shadow=142)
K2_OPS = dict(hit=270, lit=280)
WF_OPS = dict(K1_OPS, block=1, rebuild=20)
N_CH = 17       # the wavefront's state channels a lane
N_IDS = 2       # pixel id, sample id
N_RES = 8       # K6's residual rows a lane


def totals(counts: list) -> dict:
    """Per-bounce [rays, hits, shadow rays, lit] -> their sums."""
    keys = ("active", "hit", "shadow", "lit")
    return {k: sum(row[a] for row in counts) for a, k in enumerate(keys)}


def k1_ops(paths: float, c: dict, n_prims: int) -> float:
    return (paths * K1_OPS["raygen"]
            + c["active"] * n_prims * K1_OPS["sphere_test"]
            + (c["active"] - c["hit"]) * K1_OPS["miss"]
            + c["hit"] * K1_OPS["hit"]
            + c["shadow"] * (K1_OPS["shadow"]
                             + n_prims * K1_OPS["sphere_test"]))


def k2_ops(paths: float, c: dict, n_prims: int) -> float:
    fwd = k1_ops(paths, c, n_prims)
    recompute = fwd - paths * K1_OPS["raygen"]
    return fwd + recompute + c["hit"] * K2_OPS["hit"] \
        + c["lit"] * K2_OPS["lit"]


def k5_bytes(paths: float) -> float:
    return 4 * (N_CH + N_IDS) * paths + 4 * (15 + 3)


def k6_work(c: dict, n_spheres: int) -> tuple:
    """(ops, bytes) of K6 over the rays in ``c``: the winner's sphere test
    a hit; each alive lane's alive flag, residual, origin and direction,
    and every sphere read once."""
    ops = c["hit"] * WF_OPS["sphere_test"]
    n_bytes = 4 * ((1 + N_RES + 6) * c["active"] + 4 * n_spheres)
    return ops, n_bytes


def k7_work(c: dict, n_spheres: int) -> tuple:
    """(ops, bytes) of K7: the bounce on the rebuilt winner and each shadow
    ray's set-up (its walk left out); 15 state channels, ids and 5
    residual rows read and 16 channels written an alive lane, and every
    sphere read once."""
    ops = ((c["active"] - c["hit"]) * WF_OPS["miss"]
           + c["hit"] * (WF_OPS["hit"] + WF_OPS["rebuild"])
           + c["shadow"] * WF_OPS["shadow"])
    n_bytes = 4 * ((15 + N_IDS + 5 + 16) * c["active"] + 4 * n_spheres)
    return ops, n_bytes


def least_seconds(ops: float, n_bytes: float) -> float:
    return max(ops / FP32_PEAK, n_bytes / HBM_RATE)


def kernel_least_seconds(paths: float, per_bounce: list, n_spheres: int,
                         backward: bool) -> dict:
    """Least seconds of each kernel label for ``paths`` camera paths whose
    per-bounce [rays, hits, shadow rays, lit] are ``per_bounce`` (already
    scaled to those paths): K1 (and K2 under ``backward``) as one sum,
    K5 once, K6 and K7 bounce by bounce (each bounce is a launch)."""
    c = totals(per_bounce)
    out = {"k1": least_seconds(k1_ops(paths, c, n_spheres), 0.0),
           "k5": least_seconds(0.0, k5_bytes(paths))}
    if backward:
        out["k2"] = least_seconds(k2_ops(paths, c, n_spheres), 0.0)
    k6 = k7 = 0.0
    for row in per_bounce:
        rc = dict(zip(("active", "hit", "shadow", "lit"), row))
        k6 += least_seconds(*k6_work(rc, n_spheres))
        k7 += least_seconds(*k7_work(rc, n_spheres))
    out["k6"], out["k7"] = k6, k7
    return out
