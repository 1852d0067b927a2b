"""Series sharding across nodes.

Copies of ``split_series_for_host`` (:28) and
``output_series_num_for_host`` (:47) of
``detprocess_tpu/parallel/multihost.py``: each node takes a disjoint
slice of the raw series and writes output series numbered
``base + node_num`` (the reference's SLURM pattern, features.py:502-504),
with no communication between nodes. The JAX module's ``initialize`` and
``global_mesh`` belong to the mesh (ROADMAP.md §1 item 7) and are not
ported.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np


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
