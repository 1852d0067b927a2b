"""The mesh and its collectives: ``psum``, ``all_gather`` of a few values
and ``ppermute`` to a neighbour.

The JAX package runs one controller over a ``jax.sharding.Mesh`` and
reduces inside ``shard_map`` with ``lax.psum``, ``lax.all_gather`` and
``lax.ppermute`` (``detprocess_tpu/parallel/mesh.py``). Here a
:class:`Mesh` is an ordered list of devices, one a shard; a device may
appear more than once (virtual shards, the counterpart of the JAX tests'
``--xla_force_host_platform_device_count``). A shard's value is a tensor on
its shard's device, and a collective takes this process's values as a list
in shard order.

Inside one process the collectives are tensor ops and ``.to(device)``
copies between shards. A mesh that carries a ``torch.distributed`` process
group spans every process's shards in rank order, each process holding the
same number; the collectives then also go through the group with the
backend the caller initialised it with (``parallel/multihost.initialize``):
NCCL takes tensors on the rank's card, gloo CPU tensors only, so with gloo
the small operands (a few scalars, a spectrum, a halo) are copied to the
host and back.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

EVENTS_AXIS = "events"        # the one axis a mesh shards (JAX mesh.py:30)


class Mesh:
    """This process's shards (``devices``, in order) and, for a mesh over
    several processes, their ``torch.distributed`` group.

    ``size`` counts the shards of every process; this process's shards are
    global shards ``offset`` … ``offset + len(devices) − 1``."""

    def __init__(self, devices: Sequence, group=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.group = group
        if group is None:
            self.rank, self.nproc, self.backend = 0, 1, None
        else:
            import torch.distributed as dist
            self.rank = dist.get_rank(group)
            self.nproc = dist.get_world_size(group)
            self.backend = str(dist.get_backend(group))
        self.size = len(self.devices) * self.nproc
        self.offset = self.rank * len(self.devices)
        # where a collective's operands go through the group
        self.comm_device = (self.devices[0] if self.backend == "nccl"
                            else torch.device("cpu"))

    @property
    def home(self) -> torch.device:
        """The first shard's device: reductions land there."""
        return self.devices[0]

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        procs = "" if self.group is None else (
            f", process {self.rank} of {self.nproc} ({self.backend})")
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"{self.size} shards{procs})")


def check_mesh(mesh, device: torch.device, processes: bool = True) -> Mesh:
    """``mesh`` as a caller on ``device`` takes it: a :class:`Mesh` whose
    shards are of ``device``'s type (a shell on the CPU does not run its
    shards on a card, nor the other way round); with ``processes`` False,
    of this process alone."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    kinds = {d.type for d in mesh.devices}
    if kinds != {torch.device(device).type}:
        raise ValueError(f"a mesh of {sorted(kinds)} shards for a caller on "
                         f"{device}")
    if not processes and mesh.group is not None:
        raise ValueError(
            "the shells shard one process's batches: give them a mesh of "
            "this process's devices (a mesh over processes shards the "
            "spectral means and the long trace)")
    return mesh


def bounds(n: int, parts: int) -> List[tuple]:
    """``np.array_split``'s (start, stop) of ``n`` items in ``parts``: the
    first ``n % parts`` parts take one more."""
    q, r = divmod(n, parts)
    out, start = [], 0
    for i in range(parts):
        stop = start + q + (i < r)
        out.append((start, stop))
        start = stop
    return out


def _through_group(mesh: Mesh, x: torch.Tensor):
    """``x`` as the group's backend takes it (real, on the comm device),
    and how to undo that."""
    is_complex = x.is_complex()
    y = torch.view_as_real(x) if is_complex else x
    is_bool = y.dtype == torch.bool
    if is_bool:
        y = y.to(torch.uint8)
    y = y.to(mesh.comm_device).contiguous()

    def back(z: torch.Tensor, device) -> torch.Tensor:
        z = z.to(device)
        if is_bool:
            z = z.bool()
        return torch.view_as_complex(z) if is_complex else z
    return y, back


def psum(mesh: Mesh, values: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum over every shard of the mesh of its value (one a local
    shard, equal shapes), on the mesh's first device."""
    total = values[0].to(mesh.home)
    for v in values[1:]:
        total = total + v.to(mesh.home)
    if mesh.group is None:
        return total
    import torch.distributed as dist
    buf, back = _through_group(mesh, total)
    dist.all_reduce(buf, group=mesh.group)
    return back(buf, mesh.home)


def all_gather(mesh: Mesh, values: Sequence[torch.Tensor]) -> torch.Tensor:
    """[size, ...]: every shard's value (equal shapes) in global shard
    order, on the mesh's first device."""
    local = torch.stack([v.to(mesh.home) for v in values])
    if mesh.group is None:
        return local
    import torch.distributed as dist
    buf, back = _through_group(mesh, local)
    out = [torch.empty_like(buf) for _ in range(mesh.nproc)]
    dist.all_gather(out, buf, group=mesh.group)
    return back(torch.cat(out), mesh.home)


def ppermute(mesh: Mesh, values: Sequence[torch.Tensor],
             shift: int) -> List[Optional[torch.Tensor]]:
    """Each local shard's copy, on its own device, of the value of the
    shard ``shift`` places before it in the mesh (``shift=1``: its left
    neighbour's, ``-1``: its right neighbour's); None where that shard
    does not exist (the mesh's edges). Between processes only neighbours
    exchange (|shift| = 1): each process's edge value goes to the next or
    previous process through one all_gather of equal shapes."""
    if shift not in (1, -1):
        raise ValueError("ppermute exchanges with a neighbour: shift ±1")
    n = len(values)
    out: List[Optional[torch.Tensor]] = []
    other = None
    if mesh.group is not None:
        edge = values[-1] if shift == 1 else values[0]
        import torch.distributed as dist
        buf, back = _through_group(mesh, edge)
        got = [torch.empty_like(buf) for _ in range(mesh.nproc)]
        dist.all_gather(got, buf, group=mesh.group)
        src = mesh.rank - shift
        if 0 <= src < mesh.nproc:
            other = (got[src], back)
    for i in range(n):
        j = i - shift
        if 0 <= j < n:
            out.append(values[j].to(mesh.devices[i]))
        elif other is not None:
            out.append(other[1](other[0], mesh.devices[i]))
        else:
            out.append(None)
    return out


def gather_host(mesh: Mesh, value):
    """A list of every process's ``value`` (any picklable object, e.g.
    numpy arrays of its shards' results) in rank order; ``[value]`` for a
    single process."""
    if mesh.group is None:
        return [value]
    import torch.distributed as dist
    out = [None] * mesh.nproc
    dist.all_gather_object(out, value, group=mesh.group)
    return out
