"""Flattened, array-indexed BVH over sphere primitives.

The port of ``spt_tpu.core.bvh``'s builder and refit: the same trees, as
torch tensors.

* **Host build**: binned SAH in the repo's C++ builder
  (``native/libbvh_builder.so``, loaded with ctypes), with a pure-numpy
  median split as the fallback.  Both emit the same flattened preorder
  layout, so the traversal code does not care which one ran; with the same
  builder, this package and the JAX package build the same tree bit for
  bit.  ``BVH.builder`` records which one ran.
* **Layout**: depth-first preorder with skip links.  For node ``i`` the
  first child is ``i + 1`` and ``skip[i]`` is the preorder successor of its
  subtree, where a ray goes when it misses the node's box or leaves a leaf:
  a walk needs one node pointer per ray and no stack.

The traversal lives in the kernels (``kernels/megakernel_bvh.py`` and the
CUDA kernel K3), which walk the packed octant tables built from this tree.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import sys
import time

import numpy as np
import torch

MAX_LEAF = 4  # primitives per leaf of SceneData.bvh

_NATIVE_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                            "libbvh_builder.so")
_native = None


@dataclasses.dataclass(frozen=True)
class BVH:
    node_min: torch.Tensor    # (N, 3) f32 AABB lower corners
    node_max: torch.Tensor    # (N, 3) f32 AABB upper corners
    node_skip: torch.Tensor   # (N,) i32 preorder successor of the subtree
    node_first: torch.Tensor  # (N,) i32 first prim slot (leaf)
    node_count: torch.Tensor  # (N,) i32 leaf prim count; 0 marks inner
    prim_idx: torch.Tensor    # (P,) i32 primitive permutation (leaf order)
    n_nodes: int
    max_leaf: int
    builder: str              # "native" (SAH), "numpy" (median) or "empty"
    seconds: float = 0.0      # host time of the build


def _load_native():
    """The C++ SAH builder, or None where it is missing or will not load."""
    global _native
    if _native is not None:
        return _native
    path = os.path.abspath(_NATIVE_PATH)
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.spt_build_bvh.restype = ctypes.c_int
    # centers (n*3), radii (n), n, max_leaf, then the outputs node_min and
    # node_max (2n*3), node_skip, node_first, node_count (2n), prim_idx (n)
    lib.spt_build_bvh.argtypes = [fp, fp, ctypes.c_int, ctypes.c_int,
                                  fp, fp, ip, ip, ip, ip]
    _native = lib
    return lib


def _build_native(centers: np.ndarray, radii: np.ndarray, max_leaf: int):
    lib = _load_native()
    if lib is None:
        return None
    n = len(radii)
    cap = max(2 * n, 1)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    node_skip = np.empty((cap,), np.int32)
    node_first = np.empty((cap,), np.int32)
    node_count = np.empty((cap,), np.int32)
    prim_idx = np.empty((n,), np.int32)
    centers = np.ascontiguousarray(centers, np.float32)
    radii = np.ascontiguousarray(radii, np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    n_nodes = lib.spt_build_bvh(
        centers.ctypes.data_as(fp), radii.ctypes.data_as(fp),
        ctypes.c_int(n), ctypes.c_int(max_leaf),
        node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
        node_skip.ctypes.data_as(ip), node_first.ctypes.data_as(ip),
        node_count.ctypes.data_as(ip), prim_idx.ctypes.data_as(ip))
    if n_nodes <= 0:
        return None
    return (node_min[:n_nodes], node_max[:n_nodes], node_skip[:n_nodes],
            node_first[:n_nodes], node_count[:n_nodes], prim_idx)


def _build_numpy(centers: np.ndarray, radii: np.ndarray, max_leaf: int):
    """Median split on the widest centroid axis, in preorder."""
    n = len(radii)
    lo_all = centers - radii[:, None]
    hi_all = centers + radii[:, None]

    node_min, node_max = [], []
    node_first, node_count = [], []
    prim_order: list[int] = []

    def emit(idx: np.ndarray) -> None:
        me = len(node_min)
        node_min.append(lo_all[idx].min(0))
        node_max.append(hi_all[idx].max(0))
        node_first.append(0)
        node_count.append(0)
        if len(idx) <= max_leaf:
            node_first[me] = len(prim_order)
            node_count[me] = len(idx)
            prim_order.extend(int(i) for i in idx)
        else:
            cen = centers[idx]
            axis = int(np.argmax(cen.max(0) - cen.min(0)))
            order = np.argsort(cen[:, axis], kind="stable")
            half = len(idx) // 2
            emit(idx[order[:half]])
            emit(idx[order[half:]])

    def subtree_end(i: int) -> int:
        end = i + 1
        if node_count[i] == 0:
            end = subtree_end(end)        # left child
            end = subtree_end(end)        # right child
        return end

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(10000, 4 * n))
    try:
        emit(np.arange(n))
        skip = np.asarray([subtree_end(i) for i in range(len(node_min))],
                          np.int32)
    finally:
        sys.setrecursionlimit(old_limit)
    return (np.asarray(node_min, np.float32), np.asarray(node_max, np.float32),
            skip, np.asarray(node_first, np.int32),
            np.asarray(node_count, np.int32), np.asarray(prim_order, np.int32))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def build_bvh(centers, radii, valid=None, max_leaf: int = MAX_LEAF,
              force_numpy: bool = False, device=None) -> BVH:
    """A BVH over the valid spheres, as tensors on ``device`` (default: the
    device of ``centers`` if it is a tensor, else the CPU).

    Invalid (padding) primitives are left out of the tree, so a walk never
    needs the validity mask."""
    if device is None:
        device = centers.device if isinstance(centers, torch.Tensor) \
            else torch.device("cpu")
    centers = _np(centers).astype(np.float32)
    radii = _np(radii).astype(np.float32)
    if valid is not None:
        live = np.nonzero(_np(valid).astype(bool))[0].astype(np.int32)
    else:
        live = np.arange(len(radii), dtype=np.int32)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    if len(live) == 0:
        # A single empty leaf whose box can never be hit.
        return BVH(node_min=t(np.full((1, 3), np.inf, np.float32),
                              torch.float32),
                   node_max=t(np.full((1, 3), -np.inf, np.float32),
                              torch.float32),
                   node_skip=t(np.array([1]), torch.int32),
                   node_first=t(np.array([0]), torch.int32),
                   node_count=t(np.array([0]), torch.int32),
                   prim_idx=t(np.array([0]), torch.int32),
                   n_nodes=1, max_leaf=max_leaf, builder="empty")

    t0 = time.perf_counter()
    c_live, r_live = centers[live], radii[live]
    builder = "numpy"
    built = None if force_numpy else _build_native(c_live, r_live, max_leaf)
    if built is None:
        built = _build_numpy(c_live, r_live, max_leaf)
    else:
        builder = "native"
    nmin, nmax, skip, first, count, order = built
    return BVH(node_min=t(nmin, torch.float32), node_max=t(nmax, torch.float32),
               node_skip=t(skip, torch.int32), node_first=t(first, torch.int32),
               node_count=t(count, torch.int32),
               prim_idx=t(live[order], torch.int32),   # original prim ids
               n_nodes=int(len(skip)), max_leaf=max_leaf, builder=builder,
               seconds=time.perf_counter() - t0)


def _range_reduce(values: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  op) -> torch.Tensor:
    """``op`` over ``values[lo[i]:hi[i]]`` for every i (hi > lo), by a
    sparse table of power-of-two spans: two overlapping spans cover each
    range, which min and max allow."""
    n = values.shape[0]
    table = [values]
    span = 1
    while 2 * span <= n:
        prev = table[-1]
        table.append(op(prev[:n - 2 * span + 1], prev[span:n - span + 1]))
        span *= 2
    length = hi - lo
    level = torch.floor(torch.log2(length.to(torch.float64))).long()
    out = torch.empty_like(values[lo])
    for j in range(len(table)):
        sel = level == j
        if bool(sel.any()):
            a, b = lo[sel], hi[sel] - (1 << j)
            out[sel] = op(table[j][a], table[j][b])
    return out


def refit_bvh(bvh: BVH, centers, radii) -> BVH:
    """Node boxes recomputed from the current ``centers``/``radii`` over the
    fixed topology, detached (boxes only cull; a hit is chosen discretely).

    A sphere moved outside its build-time box stays hittable.  Leaf boxes
    come from the leaf's prim slots; an inner node reduces over its preorder
    range [i, skip_i), as the JAX package's masked (n, n) reduction does, and
    min/max are exact, so both give the same bits."""
    c = torch.as_tensor(centers, dtype=torch.float32).detach()
    r = torch.as_tensor(radii, dtype=torch.float32,
                        device=c.device).detach()
    dev = c.device
    first = bvh.node_first.to(dev).long()
    count = bvh.node_count.to(dev).long()
    skip = bvh.node_skip.to(dev).long()
    prim_idx = bvh.prim_idx.to(dev).long()
    n = bvh.n_nodes
    big = 3e38
    lo_k = torch.full((n, 3), big, dtype=torch.float32, device=dev)
    hi_k = torch.full((n, 3), -big, dtype=torch.float32, device=dev)
    is_leaf = count > 0
    for s in range(bvh.max_leaf):
        pid = prim_idx[torch.clamp_max(first + s, prim_idx.shape[0] - 1)]
        ok = (is_leaf & (s < count))[:, None]
        rr = r[pid][:, None]
        lo_k = torch.minimum(lo_k, torch.where(ok, c[pid] - rr, big))
        hi_k = torch.maximum(hi_k, torch.where(ok, c[pid] + rr, -big))
    rows = torch.arange(n, device=dev)
    end = torch.maximum(skip, rows + 1)     # every range holds node i
    return dataclasses.replace(
        bvh, node_min=_range_reduce(lo_k, rows, end, torch.minimum),
        node_max=_range_reduce(hi_k, rows, end, torch.maximum))
