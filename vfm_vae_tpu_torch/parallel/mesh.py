"""Data parallelism over several processes (port of
vfm_vae_tpu/parallel/mesh.py: local_mesh, warm_up_collectives, shard_batch,
check_replica_consistency).

The JAX package runs one program over a device mesh and lets XLA insert
the collectives. The port does what the reference does by hand
(torch_utils/distributed.py, training_loop.py:272-289): one process per
card, started by torchrun, each holding a full replica of the parameters
and its own slice of the global batch. The gradients are averaged with an
all-reduce of flat buckets, the initial state is broadcast from rank 0, and
`check_replica_consistency` compares a crc32 of every tensor across the
processes. The backend is NCCL for CUDA devices and gloo for the CPU.

ZeRO-1 (the JAX package's sharding of the Adam moments over the data
axis, mesh.py:129-155) is not ported: every process keeps the whole
optimiser state.
"""

from __future__ import annotations

import datetime
import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# The reference all-reduces flattened gradients in pieces of 2^23 elements.
BUCKET_ELEMENTS = 2 ** 23
TIMEOUT_S = 1800.0  # for the process group and its collectives


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    return (dist.get_rank(), dist.get_world_size()) if active() else (0, 1)


def local_device(device) -> torch.device:
    """`device` with a CUDA device mapped onto cuda:LOCAL_RANK (torchrun's
    one card per process); a CPU device as it is."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def init_processes(device) -> Tuple[torch.device, bool]:
    """The process group from torchrun's RANK, WORLD_SIZE and LOCAL_RANK
    (MASTER_ADDR and MASTER_PORT: the env:// rendezvous), NCCL for a CUDA
    device and gloo for the CPU, then one barrier (the counterpart of
    warm_up_collectives: every process has joined before any step).
    Without WORLD_SIZE above 1, or with a group already made by the caller,
    nothing is made. Returns this process's device and whether this call
    made the group (its caller then takes it down)."""
    dev = local_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if active() or world <= 1:
        return dev, False
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    barrier(dev)
    return dev, True


def barrier(device=None) -> None:
    if not active():
        return
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda" and dist.get_backend() == "nccl":
        dist.barrier(device_ids=[dev.index if dev.index is not None else 0])
    else:
        dist.barrier()


@torch.no_grad()
def broadcast_modules(modules: Sequence[torch.nn.Module]) -> None:
    """Parameters and buffers of each module overwritten in place with rank
    0's (the reference broadcasts rank 0's initial weights to every rank)."""
    if not active():
        return
    for m in modules:
        for t in m.state_dict().values():
            dist.broadcast(t, 0)


@torch.no_grad()
def all_reduce_mean(tensors: Sequence[torch.Tensor],
                    bucket: int = BUCKET_ELEMENTS) -> List[torch.Tensor]:
    """The mean over the processes of each tensor, through flat buckets of
    at most `bucket` elements per dtype (one all-reduce each). Returns new
    tensors; at world 1 the inputs themselves."""
    tensors = list(tensors)
    if not active():
        return tensors
    world = dist.get_world_size()
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[Tuple[torch.dtype, torch.device], List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault((t.dtype, t.device), []).append(i)
    for idx in by_dtype.values():
        start = 0
        while start < len(idx):
            part, n = [], 0
            while start < len(idx) and (not part or n + tensors[idx[start]].numel() <= bucket):
                part.append(idx[start])
                n += tensors[idx[start]].numel()
                start += 1
            flat = torch.cat([tensors[i].reshape(-1) for i in part])
            dist.all_reduce(flat)
            flat.div_(world)
            off = 0
            for i in part:
                k = tensors[i].numel()
                out[i] = flat[off:off + k].view_as(tensors[i])
                off += k
    return out  # type: ignore[return-value]


def mean_across(t: torch.Tensor) -> torch.Tensor:
    """One tensor's mean over the processes (itself at world 1)."""
    return all_reduce_mean([t])[0]


def sum_across(t: torch.Tensor) -> torch.Tensor:
    """One tensor's sum over the processes, without gradient (itself at world 1)."""
    if not active():
        return t
    with torch.no_grad():
        t = t.clone()
        dist.all_reduce(t)
    return t


def mean_across_with_grad(t: torch.Tensor) -> torch.Tensor:
    """One tensor's mean over the processes as a differentiable function of
    this process's `t` (itself at world 1). Its backward all-reduces the
    incoming gradient, so a loss built on the mean and averaged over the
    processes with the gradients gets the global batch's gradient."""
    if not active():
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t) / dist.get_world_size()


def rank_slice(x: torch.Tensor) -> torch.Tensor:
    """This process's contiguous slice of a global batch (the leading axis
    split into world equal parts, rank r taking the r-th): the part that
    shard_batch places on a process's devices."""
    rank, world = rank_and_world()
    if x.shape[0] % world:
        raise ValueError(f"global batch {x.shape[0]} not divisible by {world} processes")
    m = x.shape[0] // world
    return x[rank * m:(rank + 1) * m]


def tensor_digest(t: torch.Tensor) -> int:
    """crc32 of a tensor's bytes."""
    t = t.detach().to("cpu").contiguous()
    return zlib.crc32(t.reshape(-1).view(torch.uint8).numpy().tobytes()) if t.numel() else 0


def check_replica_consistency(named: Dict[str, torch.Tensor]) -> None:
    """Assert that every tensor is bit-identical on every process (the
    reference's check_ddp_consistency): a crc32 of each tensor's bytes,
    all-gathered and compared. Raises RuntimeError naming the first
    tensors that diverge. Without a process group there is nothing to
    compare."""
    if not active() or not named:
        return
    names = sorted(named)
    mine = torch.tensor([tensor_digest(named[n]) for n in names], dtype=torch.int64)
    if dist.get_backend() == "nccl":
        mine = mine.to(torch.device("cuda", torch.cuda.current_device()))
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    stacked = torch.stack(every).cpu()
    bad = (stacked != stacked[:1]).any(0).nonzero().reshape(-1).tolist()
    if bad:
        raise RuntimeError(f"replica divergence across processes in tensors: "
                           f"{[names[i] for i in bad[:5]]}")
