"""Scale-out across nodes: series sharding, and one mesh over processes.

Port of ``detprocess_tpu/parallel/multihost.py``:

1. ``split_series_for_host`` (:28) and ``output_series_num_for_host``
   (:47): each node takes a disjoint slice of the raw series and writes
   output series numbered ``base + node_num`` (the reference's SLURM
   pattern, features.py:502-504), with no communication between nodes.
2. :func:`initialize` (:55) and :func:`global_mesh` (:68): the JAX module
   starts ``jax.distributed`` and makes one mesh over every host's chips;
   here :func:`initialize` is ``torch.distributed.init_process_group``
   with the backend the caller names (NCCL where each process has its own
   card, gloo on the CPU or for processes that share a card), and
   :func:`global_mesh` is the mesh over every process's shards in rank
   order, on which ``parallel/mesh.py``'s functions run unchanged.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from detprocess_tpu_torch.parallel.collectives import Mesh


def split_series_for_host(series_list: Sequence[str],
                          node_num: Optional[int] = None,
                          nb_nodes: Optional[int] = None) -> List[str]:
    """This node's slice of ``series_list`` (``np.array_split`` into
    ``nb_nodes`` parts); the node defaults come from SLURM_PROCID and
    SLURM_NTASKS."""
    if node_num is None:
        node_num = int(os.environ.get("SLURM_PROCID", 0))
    if nb_nodes is None:
        nb_nodes = int(os.environ.get("SLURM_NTASKS", 0)) or 1
    if nb_nodes <= 1:
        return list(series_list)
    chunks = np.array_split(np.asarray(series_list, dtype=object), nb_nodes)
    return [str(s) for s in chunks[node_num]]


def output_series_num_for_host(base_series_num: int,
                               node_num: Optional[int] = None) -> int:
    """The node's output series number: the job's base plus its node
    number (default SLURM_PROCID)."""
    if node_num is None:
        node_num = int(os.environ.get("SLURM_PROCID", 0))
    return base_series_num + node_num


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_sec: float = 120.0):
    """Join the process group of ``num_processes`` processes at
    ``coordinator_address`` ("host:port", process 0 listens there) as
    process ``process_id``, over ``backend`` ("nccl" or "gloo", which the
    caller chooses: nothing picks one). Nothing happens for a single
    process, as in JAX. A peer that does not join, or a collective that
    waits on a lost one, fails after ``timeout_sec`` instead of hanging
    the run. Returns the default group, or None."""
    if num_processes in (None, 0, 1) and coordinator_address is None:
        return None
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize needs the coordinator address, the "
                         "process count and this process's id")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"initialize: backend must be 'nccl' or 'gloo', "
                         f"got {backend!r}")
    import torch.distributed as dist
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_sec))
    return dist.group.WORLD


def global_mesh(devices: Sequence) -> Mesh:
    """The mesh over every process's shards, in rank order (JAX
    ``global_mesh`` :68): this process's shards are ``devices``, and every
    process must give as many. Without :func:`initialize` it is the mesh
    of ``devices`` alone. With NCCL the process's current device becomes
    its first shard's, as NCCL needs."""
    import torch.distributed as dist
    group = (dist.group.WORLD
             if dist.is_available() and dist.is_initialized() else None)
    devices = [torch.device(d) for d in devices]
    if group is None:
        return Mesh(devices)
    counts = [None] * dist.get_world_size()
    if str(dist.get_backend()) == "nccl":
        torch.cuda.set_device(devices[0])
    dist.all_gather_object(counts, len(devices))
    if len(set(counts)) != 1:
        raise ValueError(f"global_mesh: every process must hold as many "
                         f"shards; they hold {counts}")
    return Mesh(devices, group=group)
