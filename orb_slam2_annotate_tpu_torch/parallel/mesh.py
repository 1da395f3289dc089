"""Process groups for single- and multi-process runs (port of parallel/mesh.py).

One JAX device is one torch rank here: one process a card, in the default
process group.  ``init_multi_host`` starts that group; ``map_mesh`` is the
1-D mesh the live map's points (``shard_map_state``, parallel/points.py)
and the distributed BA (``dist_ba``) are split over.  The
backend is NCCL for CUDA tensors and gloo on the CPU; gloo also moves CUDA
tensors (through the host), which is the only way to run two ranks on one
card, since NCCL refuses two ranks on one GPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

def world_size() -> int:
    """Ranks in the default process group: 1 when none was started."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def init_multi_host(coordinator: str | None = None, num_processes: int | None = None,
                    process_id: int | None = None, device="cuda",
                    backend: str | None = None, timeout_s: float | None = None) -> None:
    """Start the default process group from the arguments, or else from
    torch's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, as
    ``torchrun`` sets them).  Does nothing when neither names a coordinator.

    coordinator: "host:port" of rank 0.  The backend is NCCL when `device`
    is a CUDA device, else gloo; `backend` overrides it (gloo for two ranks
    on one card).  With NCCL each process takes the card LOCAL_RANK (as
    ``torchrun`` sets it), else process_id modulo the cards.  `timeout_s`
    bounds the rendezvous and every collective (torch's default if None).
    """
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if coordinator is None:
        return
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        # process 0 is a value: `process_id or env` would misroute it
        process_id = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, **kw)


_HOST_GROUP = {}


def host_group():
    """A group of the default group's ranks that reduces CPU tensors: the
    default group itself under gloo, else a gloo group made at the first
    call (a collective: every rank must make it)."""
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    if "gloo" not in _HOST_GROUP:
        _HOST_GROUP["gloo"] = dist.new_group(backend="gloo")
    return _HOST_GROUP["gloo"]


def all_ranks(flag: bool) -> bool:
    """Whether `flag` holds on every rank of the default group: a host
    all_reduce(MIN), so each rank takes the same branch on a flag read from
    its own clock (a CUDA event's ``query()``).  The flag itself at a world
    of one."""
    if world_size() == 1:
        return bool(flag)
    f = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(f, op=dist.ReduceOp.MIN, group=host_group())
    return bool(f.item())


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: `size` ranks of `group` (None: a world of one with no
    process group), this process being `rank`."""

    group: object
    size: int
    rank: int
    axis: str = "mp"


def map_mesh(n_devices: int | None = None, axis: str = "mp") -> Mesh:
    """1-D mesh over every rank of the default group (a rank is a device);
    a world of one when no group was started.  `n_devices`, when given,
    must be that count."""
    if dist.is_available() and dist.is_initialized():
        mesh = Mesh(dist.group.WORLD, dist.get_world_size(), dist.get_rank(), axis)
    else:
        mesh = Mesh(None, 1, 0, axis)
    if n_devices not in (None, mesh.size):
        raise ValueError(f"map_mesh: {n_devices} devices asked, the world has {mesh.size}")
    return mesh


def shard_map_state(m, mesh: Mesh):
    """The map placed on the mesh: every rank keeps the rows of the points
    it owns (global id g on rank g % n at local row g // n,
    parallel/points.py), keyframe state replicated.  `m` is a whole map
    (the same on every rank); its point capacity grows to a multiple of
    the mesh size first.  At a world of one, the map as it is."""
    if mesh.size == 1:
        return m
    from ..worldmap import map_state as ms

    if m.n_shards != 1:
        raise ValueError("shard_map_state takes a whole map (points.full_map undoes a split)")
    n = mesh.size
    m = ms.grow_map(m, new_P=-(-m.P // n) * n)
    out = m.replace(**{k: getattr(m, k)[mesh.rank::n].contiguous() for k in ms.POINT_FIELDS})
    out.mesh = mesh
    return out
