"""Sharding over a device mesh: event batches, the spectral means, and one
long trace split in time.

Port of ``detprocess_tpu/parallel/mesh.py``. The JAX module runs each
function inside ``shard_map`` over a ``jax.sharding.Mesh``; here a
:class:`~detprocess_tpu_torch.parallel.collectives.Mesh` is an ordered
list of devices, a function runs once a shard on the shard's tensors, and
the reductions are the collectives of ``parallel/collectives.py``. A value
"sharded" over the mesh is a list of this process's shards, each on its
device (:func:`shard_batch`, :func:`shard_time`).

- the **events** axis (:data:`EVENTS_AXIS`) splits event batches over the
  shards; events are independent, so the results do not depend on the
  split. :func:`shard_batch` splits unevenly where the batch does not
  divide (``np.array_split``), where the JAX package pads to equal shards;
- :func:`sharded_psd` and :func:`sharded_csd` reduce the spectral sums and
  the count with one ``psum`` each; the CSD comes back complex (the JAX
  package's (re, im) stacking is a TPU transfer workaround);
- :func:`sharded_longtrace_trigger` splits one continuous trace in time,
  with a halo of one template length from the neighbours and the exact
  cross-shard merge of ``ops/trigger.find_triggers_sharded``.

Every rFFT is ``ops/fft.rfft`` (the hand-written kernel on the card): one
launch a shard. Nothing is compiled, so the JAX module's cache of jitted
spectral functions (``_SPECTRAL_CACHE`` :85) has no counterpart.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from detprocess_tpu_torch.ops import spectral
from detprocess_tpu_torch.ops import trigger as trig
from detprocess_tpu_torch.parallel.collectives import (EVENTS_AXIS, Mesh,
                                                       bounds, psum,
                                                       ppermute)

__all__ = ["EVENTS_AXIS", "Mesh", "make_mesh", "shard_batch", "shard_time",
           "replicate", "sharded_map", "unshard", "sharded_psd",
           "sharded_csd", "sharded_trigger", "sharded_longtrace_trigger",
           "merge_sharded_triggers"]


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh of ``n_devices`` shards (JAX ``make_mesh`` :33).

    On CUDA (``device`` None or a CUDA device) it takes the first
    ``n_devices`` cards (all of them for None) and refuses more than
    ``torch.cuda.device_count()``: a run that reports success while
    under-sharded hides a misconfiguration. With ``device="cpu"`` it makes
    ``n_devices`` (default 1) virtual shards on the CPU. Virtual shards on
    one card are made explicitly: ``Mesh([torch.device("cuda", 0)] * n)``.
    """
    if device is not None and torch.device(device).type == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1))
    if device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"make_mesh: no mesh on {device}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("make_mesh: no CUDA device (torch.cuda."
                           "is_available() is False); pass device='cpu' "
                           "for virtual CPU shards")
    n = count if n_devices is None else int(n_devices)
    if n > count:
        raise ValueError(
            f"requested a {n}-device mesh but only {count} CUDA device(s) "
            f"are available; for virtual shards on one card pass "
            f"Mesh([torch.device('cuda', 0)] * {n})")
    if n < 1:
        raise ValueError(f"make_mesh: {n} devices")
    from detprocess_tpu_torch import device as dev
    dev.set_full_f32()
    return Mesh([torch.device("cuda", i) for i in range(n)])


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch) -> list:
    """This process's shards of a global batch (a tensor or a dict, tuple
    or list of tensors whose leading axis is the events): the mesh's
    ``size`` parts of ``np.array_split`` (the first ``B % size`` one event
    longer; a part may be empty), each on its shard's device (JAX
    ``shard_batch`` :54)."""
    def part(i):
        def cut(x):
            lo, hi = bounds(x.shape[0], mesh.size)[mesh.offset + i]
            return torch.as_tensor(x[lo:hi]).to(mesh.devices[i])
        return _tree_map(cut, batch)
    return [part(i) for i in range(len(mesh))]


def shard_time(mesh: Mesh, trace: torch.Tensor) -> list:
    """This process's shards of one trace [..., L] split in time into
    ``size`` equal parts, each on its shard's device; L must divide
    evenly."""
    l = trace.shape[-1]
    if l % mesh.size:
        raise ValueError(f"a trace of {l} samples does not split evenly "
                         f"over {mesh.size} shards")
    l_loc = l // mesh.size
    return [trace[..., (mesh.offset + i) * l_loc:
                  (mesh.offset + i + 1) * l_loc].to(d)
            for i, d in enumerate(mesh.devices)]


def replicate(mesh: Mesh, tree) -> list:
    """A copy of ``tree`` (tensors, or numpy arrays made tensors) on each
    shard's device, one a device: virtual shards share it (JAX
    ``replicate`` :62)."""
    copies: dict = {}
    out = []
    for d in mesh.devices:
        if d not in copies:
            copies[d] = _tree_map(
                lambda x: torch.as_tensor(x).to(d)
                if isinstance(x, torch.Tensor) or hasattr(x, "__array__")
                else x, tree)
        out.append(copies[d])
    return out


def sharded_map(mesh: Mesh, fn):
    """``fn(local_batch, args)`` once a shard (JAX ``sharded_map`` :69):
    the returned function takes the shards of :func:`shard_batch` and of
    :func:`replicate` and returns the shards' outputs in order."""
    def wrapped(batch_shards, arg_shards):
        return [fn(b, a) for b, a in zip(batch_shards, arg_shards)]
    return wrapped


def unshard(mesh: Mesh, shards):
    """The shards' outputs (tensors, or trees of them, events leading)
    concatenated in shard order on the mesh's first device."""
    first = shards[0]

    def cat(*xs):
        return torch.cat([x.to(mesh.home) for x in xs])

    if isinstance(first, torch.Tensor):
        return cat(*shards)
    if isinstance(first, dict):
        return {k: cat(*(s[k] for s in shards)) for k in first}
    return type(first)(*(None if f is None else cat(*(s[i] for s in shards))
                         for i, f in enumerate(first)))


def sharded_psd(mesh: Mesh, fs: float, window=None):
    """The Welch PSD over an event-sharded batch (JAX ``sharded_psd``
    :88): a function of the shards [b, N] → the two-sided PSD [N] on the
    mesh's first device. Each shard sums |X|² of its rFFT spectra; one
    psum adds the sums, another the counts. ``window`` None or "hann"."""
    def fn(shards):
        n = shards[0].shape[-1]
        _, scale = spectral.window_and_scale(n, window, shards[0].dtype,
                                             "cpu")
        sums = [torch.zeros(n // 2 + 1, dtype=torch.float64)]
        for x in shards:
            if x.shape[-2]:                # an empty shard adds nothing
                spec, _ = spectral.half_spectrum(x, window)
                sums.append((spec.real ** 2 + spec.imag ** 2).sum(
                    dim=-2).to(torch.float64))
        count = torch.tensor(float(sum(x.shape[-2] for x in shards)),
                             dtype=torch.float64)
        mean = psum(mesh, sums) / psum(mesh, [count])
        psd = spectral.mirror(mean, n) * (scale / (n * fs))
        return psd.to(shards[0].dtype)
    return fn


def sharded_csd(mesh: Mesh, fs: float, window=None):
    """The CSD over an event-sharded batch [b, C, N] (JAX ``sharded_csd``
    :123): a function of the shards → the complex two-sided CSD [C, C, N]
    on the mesh's first device. Each shard sums X·X^H of its rFFT spectra
    (one launch for all its channels); one psum adds the sums, another
    the counts."""
    def fn(shards):
        c, n = shards[0].shape[-2:]
        _, scale = spectral.window_and_scale(n, window, shards[0].dtype,
                                             "cpu")
        sums = [torch.zeros(c, c, n // 2 + 1, dtype=torch.complex128)]
        for x in shards:
            if x.shape[0]:                 # an empty shard adds nothing
                spec, _ = spectral.half_spectrum(x, window)   # [b, C, F]
                sums.append(torch.einsum("bik,bjk->ijk", spec,
                                         spec.conj()).to(torch.complex128))
        count = torch.tensor(float(sum(x.shape[0] for x in shards)),
                             dtype=torch.float64)
        mean = psum(mesh, sums) / psum(mesh, [count])
        csd = spectral.mirror(mean, n, conj=True) * (scale / (n * fs))
        return csd.to(trig._COMPLEX[shards[0].dtype])
    return fn


def sharded_trigger(mesh: Mesh, kernel: trig.TriggerKernel,
                    threshold: float, pileup_window: int, capacity: int):
    """Continuous-trace triggering sharded over the events axis (JAX
    ``sharded_trigger`` :250): a function of the shards [E, C, L] → one
    :class:`~detprocess_tpu_torch.ops.trigger.TriggerSet` of the whole
    batch (indices [E, K], Δχ² [E, K], amplitudes [E, M, K], counts [E])
    on the mesh's first device. Each shard runs the FIR, Δχ² and the merge
    on its own events; events are independent, so there is no collective.
    An empty shard is skipped."""
    def one(x):
        q, _ = trig.of_fir_blocks(x, kernel)
        d, a = trig.delta_chi2_blocks(q, kernel.iw_matrix)
        return trig.find_triggers_blocks(d, a, threshold, pileup_window,
                                         capacity)

    def fn(shards):
        outs = [one(x) for x in shards if x.shape[0] > 0]
        return unshard(mesh, outs)
    return fn


class LongTraceTriggers(NamedTuple):
    """:func:`sharded_longtrace_trigger`'s result over this process's
    shards, each shard's ``capacity_per_shard`` slots in shard order."""

    indices: torch.Tensor      # [D·K] global int64, −1 = empty slot
    dchi2: torch.Tensor        # [D·K]
    amplitudes: torch.Tensor   # [M, D·K]
    count: torch.Tensor        # [D] each shard's winners kept
    count_total: torch.Tensor  # groups found on every shard of the mesh


def sharded_longtrace_trigger(mesh: Mesh, kernel: trig.TriggerKernel,
                              threshold: float, pileup_window: int,
                              capacity_per_shard: int):
    """One continuous trace split in time over the mesh (JAX
    ``sharded_longtrace_trigger`` :157). Returns a function of the shards
    [C, L/D] (:func:`shard_time`) → :class:`LongTraceTriggers`.

    1. **Halo.** q(T) depends on x[T − p … T − p + Nt − 1], so each shard
       takes the last max(p, 1) samples of its left neighbour and the first
       max(Nt − p, 1) of its right one (``ppermute``); at the trace's ends
       the halo is zeros, as the unsharded FIR pads.
    2. The overlap-save FIR (``ops/trigger.of_fir_blocks``) on the extended
       shard, kept at [halo, halo + L/D); the trace's first and last Nt
       samples zeroed, as unsharded; Δχ² and the amplitudes.
    3. ``ops/trigger.find_triggers_sharded``: the exact merge across
       shards, with global indices and a global ``count_total``.

    The result equals the unsharded FIR, Δχ² and
    ``find_triggers_tiled`` on the whole trace (up to the FIR's rounding:
    the segments differ). A shard must be at least Nt samples long and a
    whole number of merge tiles; L must divide evenly over the shards.
    """
    nt, p = kernel.nt, kernel.pretrigger
    halo_l, halo_r = max(p, 1), max(nt - p, 1)
    g = trig._tile_size(pileup_window)

    def fn(shards) -> LongTraceTriggers:
        shape = shards[0].shape
        if any(x.shape != shape for x in shards):
            raise ValueError("the time shards must have equal shapes")
        l_loc = shape[-1]
        if l_loc < nt:
            raise ValueError(
                f"per-shard length {l_loc} is smaller than the template "
                f"length {nt}; use fewer shards or longer traces")
        if l_loc % g:
            raise ValueError(
                f"per-shard length {l_loc} is not a multiple of the merge "
                f"tile {g} (pileup window {pileup_window})")
        l_glob = mesh.size * l_loc
        lefts = ppermute(mesh, [x[..., -halo_l:] for x in shards], 1)
        rights = ppermute(mesh, [x[..., :halo_r] for x in shards], -1)
        ds, amps, offsets = [], [], []
        for i, x in enumerate(shards):
            t0 = (mesh.offset + i) * l_loc
            left = (torch.zeros_like(x[..., :halo_l]) if lefts[i] is None
                    else lefts[i])
            right = (torch.zeros_like(x[..., :halo_r]) if rights[i] is None
                     else rights[i])
            ext = torch.cat([left, x, right], dim=-1)
            q_ext, _ = trig.of_fir_blocks(ext, kernel,
                                          valid_range=(0, ext.shape[-1]))
            q = q_ext.flatten(-2)[..., halo_l: halo_l + l_loc]
            tt = torch.arange(l_loc, device=x.device) + t0
            q = q * ((tt >= nt) & (tt < l_glob - nt))
            d, a = trig.delta_chi2(q, kernel.iw_matrix)
            ds.append(d)
            amps.append(a)
            offsets.append(t0)
        sets = trig.find_triggers_sharded(mesh, ds, amps, threshold,
                                          pileup_window, capacity_per_shard,
                                          offsets)
        home = mesh.home
        return LongTraceTriggers(
            indices=torch.cat([s.indices.to(home) for s in sets]),
            dchi2=torch.cat([s.dchi2.to(home) for s in sets]),
            amplitudes=torch.cat([s.amplitudes.to(home) for s in sets],
                                 dim=-1),
            count=torch.stack([s.count.to(home) for s in sets]),
            count_total=sets[0].count_total.to(home))
    return fn


def merge_sharded_triggers(indices, dchi2, amplitudes):
    """The sharded long-trace output as one time-ordered trigger list
    (host numpy; the −1 empty slots dropped), JAX
    ``merge_sharded_triggers`` :240."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else \
            np.asarray(x)

    indices = host(indices)
    keep = indices >= 0
    order = np.argsort(indices[keep], kind="stable")
    return (indices[keep][order], host(dchi2)[keep][order],
            host(amplitudes)[:, keep][:, order])

