"""Processes, collectives and data parallelism over torch.distributed.

Port of notsofar_tpu/parallel/mesh.py. The JAX package runs one SPMD
program over a device mesh: the batch is sharded over the 'dp' axis, the
parameters are replicated, and XLA inserts the gradient all-reduce. Here
each process (one per card, started by torchrun) reads its own shard of
the data (the loader's shard_index / num_shards take shard_batch's place)
and holds a full copy of the model:

* maybe_initialize_distributed: the default process group from the
  torchrun environment, NCCL on cuda and gloo on the CPU;
* replicate_module (replicate_tree): rank 0's weights and buffers on every
  rank; average_gradients: each gradient's mean over the ranks after the
  backward pass, the all-reduce XLA inserts under jit;
* all_reduce_sum: a differentiable sum over the ranks, for statistics of
  the global batch (the Conformer's batch norm in train mode);
  all_reduce_mean: a metric's mean over the ranks;
* barrier, all_reduce_max_host, gather_dicts_to_zero: the host-side
  collectives (the reference's utils/torch_utils.py);
* shard_sessions: inference sessions dealt round-robin across processes.

With one process (no group initialized) every collective is the identity.
"""
import os
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist


def process_rank_and_count():
    """(rank, world size) of the initialized process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def maybe_initialize_distributed(device=None) -> bool:
    """Initialize the default process group from the torchrun environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT; LOCAL_RANK names the
    card): NCCL when `device` is cuda (the default), gloo on the CPU. A
    no-op for one process or when a group exists. Returns whether a group
    is initialized."""
    if dist.is_initialized():
        return True
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return True


def _collective_device() -> torch.device:
    """Where a host value goes for a collective: NCCL reduces on the card."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, differentiable: the backward pass sums
    the incoming gradients over the ranks, which is the gradient of a
    statistic of the global batch. `t` itself with one process."""
    if process_rank_and_count()[1] == 1:
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t)


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of `t` over the ranks (no gradient)."""
    world = process_rank_and_count()[1]
    if world == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out / world


def replicate_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank (replicate_tree)."""
    if process_rank_and_count()[1] == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t, src=0)


def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace each gradient by its mean over the ranks, with one
    all-reduce of the flattened gradients. Every rank's loss is the mean
    over its local rows, and every rank holds as many rows (the loader pads
    the shards to one size), so the mean over ranks is the gradient of the
    global batch's loss."""
    world = process_rank_and_count()[1]
    if world == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= world
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def barrier():
    """Cross-process barrier; a no-op for one process (the reference's
    torch.distributed.barrier, utils/torch_utils.py:33-36)."""
    if process_rank_and_count()[1] > 1:
        dist.barrier()


def all_reduce_max_host(value: int) -> int:
    """Max of a host-side integer across processes (the reference's
    all_reduce-MAX word-count equalizer, utils/torch_utils.py:116-123)."""
    if process_rank_and_count()[1] == 1:
        return value
    t = torch.tensor([value], dtype=torch.int64, device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def gather_dicts_to_zero(d: dict) -> Optional[list]:
    """Gather per-process dicts of floats (one key set) to process 0 (the
    reduce_dict_to_rank0 equivalent, utils/torch_utils.py:159-185); None
    on the other processes."""
    rank, world = process_rank_and_count()
    if world == 1:
        return [d]
    keys = sorted(d)
    arr = torch.tensor([float(d[k]) for k in keys], dtype=torch.float64,
                       device=_collective_device())
    rows = [torch.empty_like(arr) for _ in range(world)]
    dist.all_gather(rows, arr)
    if rank != 0:
        return None
    return [dict(zip(keys, row.tolist())) for row in rows]


def shard_sessions(num_sessions: int, process_index: Optional[int] = None,
                   process_count: Optional[int] = None) -> List[int]:
    """Strided round-robin session assignment for this process (the
    NOTSOFAR baseline's DDPRowIterator without its dummy-row padding:
    inference issues no collectives per session, so ranks need not stay
    in lockstep)."""
    rank, count = process_rank_and_count()
    pi = rank if process_index is None else process_index
    pc = count if process_count is None else process_count
    return list(range(pi, num_sessions, pc))
