"""The render mesh over ``torch.distributed``: ranks on a (data, prim) grid.

The port of ``spt_tpu.parallel.mesh``.  JAX builds a ``Mesh`` of devices and
runs one program over it (``shard_map``); here every rank is a process with
its own device, and a ``RenderMesh`` says where this rank sits on the grid
and holds the process group of each axis:

* ``data`` shards samples (the spp of a render, the sample ids of a
  gradient step): the partial images are summed and the gradients
  all-reduced over it.
* ``prim`` shards the scene's leaf blocks (``wavefront_prim``): the nearest
  hit is min-reduced and the shadow verdicts max-reduced over it.

``init_distributed`` wraps ``dist.init_process_group``; nothing here reads a
cluster's environment, so the caller gives the rendezvous (``file://`` or
``tcp://`` address), the world size and the rank.  The JAX module's
``replicated`` and ``row_sharded`` build ``NamedSharding``s, which have no
counterpart here: a rank holds whole tensors, replicated by construction,
and the sharded functions cut their own windows.  They are left out.
"""

from __future__ import annotations

import dataclasses
import datetime
import time

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device


def init_distributed(backend: str = "nccl", init_method: str | None = None,
                     world_size: int = 1, rank: int = 0,
                     timeout: float = 300.0) -> None:
    """Join the process group once per process (a second call is a no-op
    if the first made the same world).  ``backend`` "nccl" for ranks on
    cards of their own, "gloo" for ranks on the CPU or sharing one card;
    ``timeout`` seconds bound every collective, so a rank that dies makes
    the others fail instead of hanging."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size or dist.get_rank() != rank:
            raise RuntimeError(
                f"already in a process group as rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, not {rank} of {world_size}")
        return
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))


def rank_grid(n_ranks: int, data: int | None = None, prim: int = 1,
              hosts: int | None = None) -> np.ndarray:
    """The (data, prim) grid of ranks: ``grid[i, j]`` is the rank at data
    index ``i``, prim index ``j``, over the first ``data * prim`` ranks.

    JAX's layout rules (``spt_tpu/parallel/mesh.py:44-86``): ``data``
    defaults to all ranks over ``prim``; ranks are host-major (rank r on
    host r // (ranks per host)); and with ``hosts`` given, each prim group
    lies within one host, so the per-bounce prim collectives stay on a
    host's links and only the data axis's (once a render or a step) cross
    hosts.  Raises ValueError where the grid does not fit."""
    if data is None:
        if n_ranks % prim != 0:
            raise ValueError(f"{n_ranks} ranks not divisible by prim={prim}")
        data = n_ranks // prim
    if data < 1 or prim < 1:
        raise ValueError(f"mesh {data}x{prim}: both axes must be >= 1")
    if data * prim > n_ranks:
        raise ValueError(f"mesh {data}x{prim} exceeds {n_ranks} ranks")
    if hosts is not None:
        if (data * prim) % hosts != 0:
            raise ValueError(f"{data * prim} ranks not divisible by "
                             f"hosts={hosts}")
        per_host = data * prim // hosts
        if per_host % prim != 0:
            raise ValueError(
                f"prim={prim} does not divide the {per_host} ranks/host: a "
                f"prim group would straddle hosts and its collectives would "
                f"cross between them")
        # Host-major; contiguous ranks within a host form each prim group.
        return np.arange(data * prim).reshape(
            hosts, per_host // prim, prim).reshape(data, prim)
    return np.arange(data * prim).reshape(data, prim)


@dataclasses.dataclass
class RenderMesh:
    """This rank's place on the (data, prim) grid.

    ``data_idx``, ``prim_idx``: its indices (None for a rank outside the
    grid, which takes no part in the sharded functions); ``data_group``:
    the ranks that share its prim index (they hold other samples);
    ``prim_group``: the ranks that share its data index (they hold other
    leaf blocks); ``device``: where it renders; ``backend``: the groups'
    backend ("nccl" or "gloo")."""

    data: int
    prim: int
    data_idx: int | None
    prim_idx: int | None
    data_group: object
    prim_group: object
    device: torch.device
    backend: str

    def check_member(self) -> None:
        if self.data_idx is None:
            raise RuntimeError(
                f"rank {dist.get_rank()} is outside this {self.data}x"
                f"{self.prim} mesh")

    def samples_per_rank(self, spp: int) -> int:
        """The samples each data index renders: ``spp`` / ``data``, which
        must divide (ValueError)."""
        if spp % self.data != 0:
            raise ValueError(f"spp {spp} not divisible by the data axis "
                             f"{self.data}")
        return spp // self.data


def make_render_mesh(data: int | None = None, prim: int = 1,
                     hosts: int | None = None,
                     device: DeviceLike = None) -> RenderMesh:
    """The ``RenderMesh`` of this rank over the initialized process group
    (``rank_grid``'s layout).  Every rank of the world must call it, with
    the same arguments and in the same order as its other
    ``make_render_mesh`` calls: each creates one group per grid row and per
    grid column (``dist.new_group``, which every rank enters).  ``device``
    defaults to the card."""
    if not dist.is_initialized():
        raise RuntimeError("call init_distributed first")
    device = resolve_device(device)
    grid = rank_grid(dist.get_world_size(), data, prim, hosts)
    n_data, n_prim = grid.shape
    rank = dist.get_rank()
    backend = str(dist.get_backend())
    prim_groups = [dist.new_group(ranks=grid[i].tolist())
                   for i in range(n_data)]
    data_groups = [dist.new_group(ranks=grid[:, j].tolist())
                   for j in range(n_prim)]
    where = np.argwhere(grid == rank)
    if not len(where):
        return RenderMesh(n_data, n_prim, None, None, None, None, device,
                          backend)
    i, j = (int(v) for v in where[0])
    return RenderMesh(n_data, n_prim, i, j, data_groups[j], prim_groups[i],
                      device, backend)


def all_reduce(t: torch.Tensor, op, group, backend: str,
               stats: dict | None = None) -> torch.Tensor:
    """``dist.all_reduce`` of ``t`` in place over ``group``, returned.
    Under gloo a tensor on the card goes through a host copy made here (one
    copy each way), so that MIN and MAX take the same path as SUM.
    ``stats``, if given, gets the collective's host-clock milliseconds
    appended to ``"collective_ms"`` (the card synchronized on both sides)
    and its bytes added to ``"collective_bytes"``."""
    if stats is not None:
        _sync(t)
        t0 = time.perf_counter()
    if backend == "gloo" and t.device.type == "cuda":
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    if stats is not None:
        _sync(t)
        stats.setdefault("collective_ms", []).append(
            1e3 * (time.perf_counter() - t0))
        stats["collective_bytes"] = stats.get("collective_bytes", 0) \
            + t.numel() * t.element_size()
    return t


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
