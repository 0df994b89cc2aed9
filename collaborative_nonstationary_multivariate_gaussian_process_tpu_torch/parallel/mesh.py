"""Device-mesh construction and sharding helpers on `torch.distributed`.

The JAX package's `parallel/mesh.py`: a mesh with axes ("data", "chain"),
minibatch rows split over "data" for DSVI, MCMC chains and SMC particles
over "chain", the cross-shard statistics and gradient sums as collectives.

Here one process drives one card (or the CPU) and is one rank of a
`torch.distributed` process group, and a `Mesh` lays the group's ranks
out as a (data, chain) grid, a `DeviceMesh` with those dim names.  The mesh
hands out local tensors, never DTensors: every rank computes on its own
block with the port's kernels, which take plain tensors, and the paths
that use the mesh call its collectives explicitly (`all_reduce_`,
`all_gather`, `broadcast_`).  With the "gloo" backend a CUDA tensor is
staged through the host for a collective; with "nccl" it stays on the card
(and a CUDA graph can capture the collective).

In one process without a process group, `make_mesh()` is a 1 x 1 mesh with
no group: every collective is the identity and every path that takes a
mesh computes exactly what it computes without one.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "make_mesh",
    "make_pod_mesh",
    "DATA_AXIS",
    "CHAIN_AXIS",
    "shard_batch",
    "replicate",
    "initialize_distributed",
    "process_local_slice",
    "process_local_blocks",
    "global_batch_from_local",
]

DATA_AXIS = "data"
CHAIN_AXIS = "chain"
AXES = (DATA_AXIS, CHAIN_AXIS)


class Mesh:
    """Ranks laid out on a (data, chain) grid.

    `ranks` (data, chain) holds the global rank at each coordinate;
    `device_mesh` is the `DeviceMesh` over them, or None in one process
    without a process group (then `ranks` is [[0]] and every collective is
    the identity).  A layout built for its arithmetic alone (as
    `process_local_blocks` reads it) may also have no group.
    """

    axis_names = AXES

    def __init__(self, ranks, device_mesh=None):
        self.ranks = torch.as_tensor(ranks, dtype=torch.int64)
        if self.ranks.ndim != 2:
            raise ValueError(f"a mesh's ranks are a (data, chain) grid, not "
                             f"{tuple(self.ranks.shape)}")
        self.device_mesh = device_mesh
        self.rank = dist.get_rank() if device_mesh is not None else int(self.ranks.flatten()[0])
        self.backend = dist.get_backend() if device_mesh is not None else None

    @property
    def shape(self):
        return {DATA_AXIS: int(self.ranks.shape[0]), CHAIN_AXIS: int(self.ranks.shape[1])}

    def size(self, axis: str = DATA_AXIS) -> int:
        return self.shape[axis]

    def _where(self, rank: int) -> Tuple[int, int]:
        hit = (self.ranks == rank).nonzero()
        if hit.shape[0] != 1:
            raise ValueError(f"rank {rank} is not on this mesh {self.ranks.tolist()}")
        return int(hit[0, 0]), int(hit[0, 1])

    def coordinate(self, axis: str = DATA_AXIS) -> int:
        """This rank's index along `axis`."""
        return self._where(self.rank)[AXES.index(axis)]

    def row_slice(self, n_rows: int, axis: str = DATA_AXIS) -> slice:
        """This rank's block of `n_rows` rows split evenly over `axis`."""
        n, r = self.size(axis), self.coordinate(axis)
        if n_rows % n:
            raise ValueError(f"{n_rows} rows do not split evenly over {n} '{axis}' shards")
        return slice(r * (n_rows // n), (r + 1) * (n_rows // n))

    def _line(self, axis: str) -> list:
        """The global ranks along `axis` through this rank, in coordinate order."""
        d, c = self._where(self.rank)
        return (self.ranks[:, c] if axis == DATA_AXIS else self.ranks[d, :]).tolist()

    def group(self, axis: str):
        """The process group of `axis` through this rank, or None without
        a process group."""
        return None if self.device_mesh is None else self.device_mesh.get_group(axis)

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def all_reduce_(self, t: torch.Tensor, axis: str = DATA_AXIS, op: str = "sum") -> torch.Tensor:
        """Reduce `t` in place over `axis` ("sum" or "max"); returns `t`."""
        group = self.group(axis)
        if group is None:
            return t
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if self._staged(t):
            host = t.cpu()
            dist.all_reduce(host, red, group=group)
            t.copy_(host)
        else:
            dist.all_reduce(t, red, group=group)
        return t

    def all_gather(self, t: torch.Tensor, axis: str = CHAIN_AXIS) -> torch.Tensor:
        """Every rank's `t` along `axis`, concatenated on dim 0 in coordinate
        order (each rank's `t` has the same shape)."""
        group = self.group(axis)
        if group is None:
            return t
        src = t.cpu() if self._staged(t) else t
        wire = src.to(torch.uint8) if src.dtype == torch.bool else src.contiguous()
        parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, wire, group=group)
        by_rank = dict(zip(dist.get_process_group_ranks(group), parts))
        out = torch.cat([by_rank[r] for r in self._line(axis)])
        return out.to(device=t.device, dtype=t.dtype)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite `t` on every rank of the mesh with global rank `src`'s;
        returns `t`."""
        if self.device_mesh is None:
            return t
        if self._staged(t):
            host = t.cpu()
            dist.broadcast(host, src)
            t.copy_(host)
        else:
            dist.broadcast(t, src)
        return t


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(
    data: Optional[int] = None,
    chain: int = 1,
    devices: Optional[Sequence[int]] = None,
) -> Mesh:
    """A ("data", "chain") mesh over the ranks `devices` (global ranks,
    row-major; default every rank in order).  `data=None` takes every rank
    after the chain axis.  Every rank of the process group must be on the
    mesh (a `DeviceMesh` is built by all of them); in one process without
    a group the mesh is 1 x 1."""
    _, world = _world()
    devices = list(range(world) if devices is None else devices)
    if data is None:
        if len(devices) % chain:
            raise ValueError(f"{len(devices)} ranks do not split into chains of {chain}")
        data = len(devices) // chain
    if data * chain != world or sorted(devices[:data * chain]) != list(range(world)):
        raise ValueError(f"a mesh of {data} x {chain} over ranks {devices} must hold each of the "
                         f"{world} ranks of the process group once")
    layout = torch.tensor(devices[:data * chain], dtype=torch.int64).reshape(data, chain)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(layout)
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(layout, DeviceMesh(device_type, layout, mesh_dim_names=AXES))


def make_pod_mesh(
    data: Optional[int] = None,
    chain: int = 1,
    *,
    allow_split_physical_axes: bool = False,
) -> Mesh:
    """("data", "chain") mesh over ALL ranks of the process group.

    The JAX package permutes TPU devices so that mesh neighbours are ICI
    neighbours.  Launchers (torchrun, Slurm, Open MPI) number the ranks of
    one host consecutively, so the row-major layout keeps each run of
    `chain` neighbours (the adaptation reductions) on one host's NVLink
    where `chain` divides the ranks per host, and the gradient sum over
    "data" crosses hosts.  `allow_split_physical_axes` has no counterpart
    (a process group has no physical axes) and is accepted for the JAX
    signature."""
    _, world = _world()
    if data is None:
        if world % chain:
            raise ValueError(f"{world} ranks do not split into chains of {chain}")
        data = world // chain
    if data * chain != world:
        raise ValueError(f"pod mesh must use every rank: data*chain={data * chain} != {world}")
    return make_mesh(data, chain)


def shard_batch(mesh: Mesh, tree, axis: str = DATA_AXIS):
    """This rank's block of rows of each leaf (a tensor, or a tuple, list
    or dict of them) whose leading dim is split evenly over `axis`."""
    return _map(lambda t: t[mesh.row_slice(t.shape[0], axis)], tree)


def replicate(mesh: Mesh, tree):
    """Rank 0's value of each leaf on every rank of the mesh (copies,
    broadcast from rank 0)."""
    return _map(lambda t: mesh.broadcast_(t.detach().clone(), 0), tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(tree)


# ---------------------------------------------------------------------------
# Multi-host support
# ---------------------------------------------------------------------------


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    **kwargs,
) -> Tuple[int, int]:
    """Join the process group; returns (rank, world size).

    The counterpart of the JAX `jax.distributed.initialize` wrapper:
      - with `coordinator_address` ("host:port") and `num_processes`,
        `process_id`, joins `tcp://coordinator_address` as that rank;
      - else under a launcher (`_cluster_detected`: torchrun's
        WORLD_SIZE/RANK/MASTER_ADDR/MASTER_PORT, Slurm's SLURM_NTASKS/
        SLURM_PROCID or Open MPI's OMPI_COMM_WORLD_SIZE/OMPI_COMM_WORLD_RANK
        with MASTER_ADDR and MASTER_PORT) joins from the environment;
      - in a single process it does nothing and returns (0, 1);
      - a second call returns the group's (rank, world size).
    `backend` defaults to "nccl" where CUDA is available, else "gloo".  With
    "nccl" each rank then takes the card LOCAL_RANK (or rank modulo the
    cards of the host).  The decision reads only the arguments and the
    environment: it initializes neither CUDA nor a group before it."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if coordinator_address is not None or num_processes is not None:
        init = dict(init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                    rank=int(process_id))
        local = None
    elif _cluster_detected():
        rank, world = _launcher_rank_world(env)
        init = dict(init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                    world_size=world, rank=rank)
        local = env.get("LOCAL_RANK", env.get("SLURM_LOCALID",
                                              env.get("OMPI_COMM_WORLD_LOCAL_RANK")))
    else:
        return 0, 1
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, **init, **kwargs)
    if backend == "nccl":
        rank = dist.get_rank()
        torch.cuda.set_device(int(local) if local is not None else rank % torch.cuda.device_count())
    return dist.get_rank(), dist.get_world_size()


def _launcher_rank_world(env) -> Tuple[int, int]:
    for size, rank in (("WORLD_SIZE", "RANK"), ("SLURM_NTASKS", "SLURM_PROCID"),
                       ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK")):
        if int(env.get(size, "1")) > 1:
            return int(env[rank]), int(env[size])
    raise RuntimeError("no launcher environment")


def _cluster_detected() -> bool:
    """A multi-process launch, read from the environment alone: torchrun
    (WORLD_SIZE > 1), Slurm (SLURM_NTASKS > 1) or Open MPI
    (OMPI_COMM_WORLD_SIZE > 1)."""
    env = os.environ
    return any(int(env.get(v, "1") or "1") > 1
               for v in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"))


def process_local_blocks(mesh: Mesh, n_rows: int, axis: str = DATA_AXIS, ranks=None):
    """List of (start, size) row ranges that the ranks `ranks` (default
    this rank; a loader that feeds several ranks of a host passes them
    all) must load for a global array of `n_rows` rows split over `axis`,
    in ascending global order (the order `global_batch_from_local` expects
    them concatenated in).  The arithmetic of the JAX function: the axis
    coordinates of those ranks, each run of consecutive coordinates merged
    into one range, so a layout that interleaves the ranks gives several
    ranges; ranks not on the mesh get an empty list."""
    axis_size = mesh.size(axis)
    if n_rows % axis_size:
        raise ValueError(f"{n_rows} rows do not split evenly over {axis_size} '{axis}' shards")
    block = n_rows // axis_size
    ranks = {mesh.rank} if ranks is None else set(int(r) for r in ranks)
    a = AXES.index(axis)
    coords_here = sorted({int(idx[a]) for idx in (torch.isin(mesh.ranks, torch.tensor(
        sorted(ranks), dtype=torch.int64))).nonzero().tolist()})
    if not coords_here:
        return []
    blocks = []
    run_start = prev = coords_here[0]
    for c in coords_here[1:]:
        if c == prev + 1:
            prev = c
            continue
        blocks.append((run_start * block, (prev - run_start + 1) * block))
        run_start = prev = c
    blocks.append((run_start * block, (prev - run_start + 1) * block))
    return blocks


def process_local_slice(mesh: Mesh, n_rows: int, axis: str = DATA_AXIS, ranks=None):
    """(start, size) of the rows this rank (or `ranks`) must load; raises
    ValueError when they are not one contiguous run (then load with
    `process_local_blocks`)."""
    blocks = process_local_blocks(mesh, n_rows, axis, ranks)
    if len(blocks) != 1:
        raise ValueError(
            f"the '{axis}'-axis rows of ranks {ranks or [mesh.rank]} are not contiguous "
            f"(blocks={blocks}); load via process_local_blocks() instead"
        )
    return blocks[0]


def global_batch_from_local(mesh: Mesh, tree, axis: str = DATA_AXIS):
    """The global rows of each leaf from every rank's local rows (its
    `process_local_slice`), gathered over `axis` in coordinate order, the
    same on every rank.  The JAX function builds a sharded global array
    that moves no data; the port's mesh hands out local tensors, so the
    global batch is an all-gather.  One process: the leaves as they are."""
    return _map(lambda t: mesh.all_gather(t, axis), tree)
