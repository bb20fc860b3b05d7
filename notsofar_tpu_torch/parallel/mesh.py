"""Session sharding across processes.

Port of notsofar_tpu/parallel/mesh.py::shard_sessions. The JAX package
reads its process index and count from jax; here they come from the
torch.distributed process group when one is initialized (rank and world
size), else (0, 1). The rest of the JAX module (device meshes, collectives
of per-process stats) is not ported.
"""
from typing import List, Optional

import torch.distributed as dist


def process_rank_and_count():
    """(rank, world size) of the initialized process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


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
