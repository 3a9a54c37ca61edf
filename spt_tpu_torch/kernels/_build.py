"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` is compiled at first use with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, under
``spt_tpu_torch/_build/``, and loaded with ``ctypes``.  A library is named
by a hash of the sources, so an edit rebuilds it and an unchanged tree
reuses it.  ``--fmad=false`` keeps ``a*b+c`` as two rounded operations, as
the plain PyTorch versions compute it; there is no ``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# name -> (restype, argtypes) of every exported entry.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRIES = {
    "megakernel": {
        # out, blob, meta, lsb, next (scratch), counts (null: not counting),
        # width, height, spp, n_prims, n_light_slots, max_bounces, rr_depth,
        # use_nee, use_mis, sky_mode, dof, max_blocks, inv_w, inv_h, aspect,
        # stream
        "spt_megakernel_fwd": [_P] * 6 + [_I] * 12 + [_F, _F, _F, _P],
        # n_prims, n_light_slots -> blocks an SM
        "spt_megakernel_fwd_blocks_per_sm": [_I, _I],
        "spt_megakernel_fwd_threads": [],
        # out, pixel, sample, dim, seed, n, stream
        "spt_counter_bits": [_P, _P, _P, _P, _P, _I, _P],
    },
    "megakernel_grad": {
        # img, gvec, blob, meta, lsb, ct, width, height, spp, n_prims,
        # n_light_slots, max_bounces, rr_depth, use_nee, use_mis, sky_mode,
        # dof, inv_w, inv_h, aspect, stream
        "spt_megakernel_grad": [_P] * 6 + [_I] * 11 + [_F, _F, _F, _P],
        # gvec, out_ct, state_ct, state, aux, pid, sample, blob, meta, lsb,
        # n, n_prims, n_light_slots, k, rr_depth, use_nee, use_mis,
        # sky_mode, stream
        "spt_bounce_vjp": [_P] * 10 + [_I] * 8 + [_P],
        # n_prims, n_light_slots -> blocks an SM
        "spt_megakernel_grad_blocks_per_sm": [_I, _I],
    },
    "megakernel_bvh": {
        # out, blob, meta, lsb, nodef, nodei, prims, mtypes, next (scratch),
        # counts (null: not counting), width, height, spp, n_nodes, block,
        # n_mats, n_light_slots, max_bounces, rr_depth, use_nee, use_mis,
        # sky_mode, dof, max_blocks, inv_w, inv_h, aspect, stream
        "spt_megakernel_bvh_fwd": [_P] * 10 + [_I] * 14 + [_F, _F, _F, _P],
        # n_mats, n_light_slots -> blocks an SM
        "spt_megakernel_bvh_fwd_blocks_per_sm": [_I, _I],
        "spt_megakernel_bvh_fwd_threads": [],
    },
    "wavefront": {
        # st, ids, blob, meta, width, height, tiles_x, tiles_per_img,
        # n_tiles, n_lanes, dof, inv_w, inv_h, aspect, stream
        "spt_wavefront_raygen": [_P] * 4 + [_I] * 7 + [_F, _F, _F, _P],
        # res, st, prims, cand, ctn, cmat, bctr (K6m; null for K6), nodef,
        # nodei (K6's tree mode; null for the lists), stride, n_lanes,
        # n_blocks, block, n_nodes, stream
        "spt_wavefront_isect": [_P] * 9 + [_I] * 5 + [_P],
        # st, ids, res, blob, meta, lsb, prims, mtypes, scand, sctn,
        # blocked (K9 and K8; null for K7), nodef, nodei (the shadow walks;
        # null for the lists), stride, n_lanes, n_blocks, block, n_mats,
        # n_light_slots, k, rr_depth, use_nee, use_mis, sky_mode,
        # blocked_in_res, n_nodes, store_path (0: K8, the verdicts alone),
        # stream
        "spt_wavefront_shade": [_P] * 13 + [_I] * 14 + [_P],
        # st, ids, blob, meta, lsb, nodef, nodei, prims, mtypes, cand, ctn,
        # boxes (the list sweep's cull; null: none), res (K11g; null for
        # K11), stride, n_lanes, n_nodes, n_blocks, block, n_mats,
        # n_light_slots, k, rr_depth, use_nee, use_mis, sky_mode, precull,
        # stream
        "spt_wavefront_bounce": [_P] * 13 + [_I] * 13 + [_P],
        # blocked, sray, prims, scand, sctn, stride, n_lanes, n_blocks,
        # block, stream
        "spt_wavefront_anyhit": [_P] * 5 + [_I] * 4 + [_P],
        # verdict, sray, cslot, bctr, scand, sctn, n_lanes, n_blocks, block,
        # stream (K7m's verdict pass)
        "spt_wavefront_mxu_verdicts": [_P] * 6 + [_I] * 3 + [_P],
        # block -> the verdict pass's blocks an SM
        "spt_wavefront_mxu_verdicts_blocks_per_sm": [_I],
        # din, dprims, dscal, st, ids, res, ct, blob, meta, lsb, mtypes,
        # stride, n_lanes, n_mats, n_light_slots, k, rr_depth, use_nee,
        # use_mis, sky_mode, n_blocks, block, stream
        "spt_wavefront_bounce_bwd": [_P] * 11 + [_I] * 11 + [_P],
        # n_mats, n_light_slots -> K10's blocks an SM
        "spt_wavefront_bounce_bwd_blocks_per_sm": [_I, _I],
        # which (0 K6, 1 K7/K9, 2 K11, 3 K8l, 4 K10, 5 K8, 6 K7b and K7m's
        # bounce, 7 K11g), smem -> blocks an SM
        "spt_wavefront_blocks_per_sm": [_I, _I],
    },
    "megakernel_bvh_grad": {
        # img, grad_s, grad_g, blob, meta, lsb, nodef, nodei, prims, mtypes,
        # ct, width, height, spp, n_nodes, block, n_mats, n_light_slots,
        # max_bounces, rr_depth, use_nee, use_mis, sky_mode, dof, inv_w,
        # inv_h, aspect, stream
        "spt_megakernel_bvh_grad": [_P] * 11 + [_I] * 13 + [_F, _F, _F, _P],
        # n_mats, n_light_slots -> blocks an SM
        "spt_megakernel_bvh_grad_blocks_per_sm": [_I, _I],
    },
}

_LOADED: dict = {}
BUILD_INFO: dict = {}   # name -> {"seconds", "ptxas", "path", "cached"}


def find_nvcc() -> str:
    """The nvcc on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the same sources were built before."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"lib{name}_{_source_hash()}.so"
    if lib.exists():
        BUILD_INFO.setdefault(name, dict(seconds=0.0, ptxas=[],
                                         path=str(lib), cached=True))
        return lib
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    # -Xptxas -v: registers, stack, spill stores/loads of every kernel.
    lines = (proc.stdout + proc.stderr).splitlines()
    BUILD_INFO[name] = dict(seconds=seconds, path=str(lib), cached=False,
                            ptxas=[ln.strip() for ln in lines if ln.strip()])
    return lib


def load_library(name: str = "megakernel") -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, argtypes set."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in ENTRIES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
