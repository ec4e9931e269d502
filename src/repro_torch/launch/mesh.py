"""The data mesh over a process group (mirrors `repro.launch.mesh`).

The reference's `make_data_mesh(S)` lays S shards on the first S devices
of one JAX process; its stages run under `shard_map`, the owner
exchanges are `all_to_all` and the overflow counts `psum`.  Here a mesh
spans the W ranks of a `torch.distributed` process group, one device a
rank: rank r holds shards [r*S/W, (r+1)*S/W) on `cuda:{local_rank}` over
NCCL, or on the CPU over gloo when the caller asks for the CPU.  W
divides S.

`group_mesh` makes the handle the distributed stages take
(`core.exchange.DataMesh`) from a process group, and checks the group's
backend against the device.  `Mesh(S, group=g)` builds it.

    mesh = make_data_mesh(8)          # under torchrun --nproc-per-node W
    spawn(fn, 2, device="cpu", init_file=path)   # fn(rank), gloo

The reference's `make_production_mesh` (the (2, 16, 16) TPU pod mesh of
its GSPMD dry run) has no counterpart on eager cards.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.core.exchange import DataMesh

AXIS = "data"


def local_rank() -> int:
    """This process's card, `LOCAL_RANK` (set by torchrun and
    `join_group`)."""
    if "LOCAL_RANK" not in os.environ:
        raise RuntimeError("LOCAL_RANK is unset: start under torchrun "
                           "--nproc-per-node W, or through launch.mesh."
                           "spawn / join_group")
    return int(os.environ["LOCAL_RANK"])


def group_mesh(num_shards: int, group, *, device=None) -> DataMesh:
    """The handle of `num_shards` shards over the ranks of process group
    `group`.

    device=None means this rank's card, `cuda:{local_rank}` (made the
    current device), and needs an NCCL group; device="cpu" needs gloo.
    Anything else raises: the mesh never falls back to another device
    or backend.
    """
    if num_shards < 1:
        raise ValueError(f"a mesh needs num_shards >= 1, got {num_shards}")
    backend = str(dist.get_backend(group))
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if num_shards % world:
        raise ValueError(f"{num_shards} shards do not split evenly over "
                         f"{world} ranks")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        if "gloo" not in backend:
            raise ValueError(
                f"a mesh on the CPU exchanges over gloo, but the group's "
                f"backend is {backend!r}; pass a gloo group, or no device "
                f"for the card")
    elif dev.type == "cuda":
        if "nccl" not in backend:
            raise ValueError(
                f"a mesh on the card exchanges over nccl, but the group's "
                f"backend is {backend!r}; pass device='cpu' for gloo")
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass "
                               "device='cpu' with a gloo group")
        local = local_rank()
        if dev.index is not None and dev.index != local:
            raise ValueError(f"rank {rank} runs on cuda:{local}, not {dev}")
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    else:
        raise ValueError(f"no mesh on device {dev}")
    return DataMesh(num_shards, dev, group, rank, world)


def make_data_mesh(num_shards: int, *, device=None) -> DataMesh:
    """1-D data mesh of `num_shards` shards over the default process group
    (DESIGN.md §3.1): reads and k-mer ownership shard over one axis.

    Starts the default group from the torchrun environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT) when it is not yet up: NCCL on
    the card, gloo for device="cpu".
    """
    if not dist.is_initialized():
        missing = [v for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if v not in os.environ]
        if missing:
            raise RuntimeError(
                f"no process group is up and {', '.join(missing)} unset: "
                f"start under torchrun --nproc-per-node W, or through "
                f"launch.mesh.spawn / join_group")
        cpu = device is not None and torch.device(device).type == "cpu"
        if not cpu:
            torch.cuda.set_device(local_rank())
        dist.init_process_group("gloo" if cpu else "nccl",
                                init_method="env://")
    return group_mesh(num_shards, dist.group.WORLD, device=device)


def dp_axes(mesh) -> tuple:
    """Axes carrying data parallelism: the one data axis."""
    return (AXIS,)


def num_chips(mesh: DataMesh) -> int:
    return mesh.world_size


def join_group(rank: int, world_size: int, *, device, init_file) -> None:
    """Start the default group as rank `rank` of `world_size` over a
    `FileStore` at `init_file` (a path no earlier group used): NCCL on
    `cuda:{rank}` (one host), gloo for device="cpu".  Sets LOCAL_RANK in
    the environment, as torchrun does."""
    cpu = torch.device(device).type == "cpu"
    os.environ["LOCAL_RANK"] = str(rank)
    if not cpu:
        torch.cuda.set_device(rank)
    store = dist.FileStore(str(init_file), world_size)
    dist.init_process_group("gloo" if cpu else "nccl", store=store,
                            rank=rank, world_size=world_size)


def _rank_main(rank, fn, world_size, device, init_file, args):
    join_group(rank, world_size, device=device, init_file=init_file)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, *, device, init_file, args=()) -> None:
    """Run `fn(rank, *args)` in `world_size` fresh processes, each rank of
    one default group (`join_group`).  `fn` must be importable by name
    (module level).  A rank that raises fails the whole spawn: the others
    are stopped and the error is raised here."""
    torch.multiprocessing.spawn(
        _rank_main, args=(fn, world_size, str(device), str(init_file),
                          tuple(args)),
        nprocs=world_size, join=True)
