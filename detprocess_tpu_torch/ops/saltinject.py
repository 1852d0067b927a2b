"""Salt injection on the device: a batch's simulated pulses added into its
traces after the ADC conversion.

Port of ``detprocess_tpu/ops/saltinject.py`` (``SaltPlan`` :39,
``empty_plan`` :55, ``inject_salts`` :62, ``DeviceInjector`` :88;
``adc_convert`` :26 is ``ops/adc.py``). The host plans each batch as small
[E, K] arrays (start sample, channel row, template row, amplitude), and
:func:`inject_salts` adds each event's scaled templates into its traces
with one ``index_add_`` on the flat [E·C·N] view, so a salted run keeps the
2-byte int16 upload. The JAX package computes this in XLA, not in a Pallas
kernel; the port runs it in torch ops.

Where the port departs from the JAX functions (ROADMAP.md §3, "Known
faults in the reference"):

- positions outside [0, N) are dropped at both ends of the trace, as the
  host injector (``Salting.inject_raw_salt``) clips them. JAX's
  ``mode="drop"`` scatter normalises a negative position first, so a start
  in [−N, 0) wraps the template's head to the end of the trace;
- the planner gives slots only to the salts whose template overlaps
  [0, N) of the trace it plans for. In windowed mode JAX gives every salt
  of the event a slot, so a window can lose its own salt to the
  ``max_salts_per_event`` overflow of salts far outside it;
- channels are mapped by name onto the channel axis that was uploaded,
  not by position in the caller's list;
- templates and amplitudes are kept in float64 and cast to the run's
  dtype on the device (JAX keeps both in float32).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


class SaltPlan(NamedTuple):
    """One batch's injection arrays, built on the host.

    idx  [E, K] int64   — template start (its sample 0) in trace
                          coordinates; may be negative (clipped add)
    chan [E, K] int64   — row of the traces' channel axis
    tid  [E, K] int64   — row of the template stack
    amp  [E, K] float64 — template scale; 0 disables the slot
    """

    idx: np.ndarray
    chan: np.ndarray
    tid: np.ndarray
    amp: np.ndarray

    def to(self, device) -> "SaltPlan":
        """The plan as tensors on ``device``."""
        return SaltPlan(*(torch.as_tensor(a, device=device) for a in self))


def empty_plan(nevents: int, k: int) -> SaltPlan:
    return SaltPlan(np.zeros((nevents, k), np.int64),
                    np.zeros((nevents, k), np.int64),
                    np.zeros((nevents, k), np.int64),
                    np.zeros((nevents, k), np.float64))


def inject_salts(traces: torch.Tensor, idx: torch.Tensor, chan: torch.Tensor,
                 tid: torch.Tensor, amp: torch.Tensor,
                 templates: torch.Tensor) -> torch.Tensor:
    """Add ``amp[e,k] · templates[tid[e,k]]`` into channel ``chan[e,k]`` of
    event ``e`` from sample ``idx[e,k]``, in place; returns ``traces``.

    traces [E, C, N], contiguous; templates [T, NT]; the plan's arrays
    [E, K] on the traces' device. Positions outside [0, N) and channels
    outside [0, C) are masked to an add of 0 at position 0: neither
    ``index_add_`` nor ``scatter_add_`` has a drop mode. The values are
    formed in the traces' dtype."""
    if not traces.is_contiguous():
        raise ValueError("inject_salts adds into a contiguous [E, C, N] "
                         "batch")
    e, c, n = traces.shape
    nt = templates.shape[-1]
    dev = traces.device
    pos = idx[:, :, None] + torch.arange(nt, device=dev)            # [E,K,NT]
    keep = ((pos >= 0) & (pos < n)
            & ((chan >= 0) & (chan < c))[:, :, None])
    row = torch.arange(e, device=dev)[:, None] * c + chan           # [E, K]
    flat = torch.where(keep, row[:, :, None] * n + pos, 0)
    vals = (amp.to(traces.dtype)[:, :, None]
            * templates.to(traces.dtype)[tid])
    vals = torch.where(keep, vals, torch.zeros((), dtype=traces.dtype,
                                               device=dev))
    traces.view(-1).index_add_(0, flat.reshape(-1), vals.reshape(-1))
    return traces


class DeviceInjector:
    """The host planner and the template stack of batched injection.

    Built by ``Salting.make_device_injector(channel_list)``. A shell calls
    :meth:`inject` on each batch it has uploaded and converted: the host
    :meth:`plan` of the batch's (series, event) numbers and, in windowed
    mode, its window starts, moved to the card and added there with
    :func:`inject_salts` on the ``templates`` stack (float64 [T, NTmax],
    zero-padded rows), cast once to the traces' dtype and device."""

    def __init__(self, salt_table: dict, template_lookup,
                 channel_list: Sequence[str],
                 max_salts_per_event: int = 16):
        self.channel_list = list(channel_list)
        self.k = int(max_salts_per_event)
        chans = np.asarray(salt_table["salt_channel"]).astype(str)
        tags = (np.asarray(salt_table["salt_template_tag"]).astype(str)
                if "salt_template_tag" in salt_table
                else np.full(len(chans), "default"))
        pairs = sorted(set(zip(chans.tolist(), tags.tolist())))
        tmpls, pretrig = [], []
        for chan, tag in pairs:
            tmpl, pre = template_lookup(chan, tag)
            tmpls.append(np.asarray(tmpl, np.float64))
            pretrig.append(int(pre))
        ntmax = max((t.shape[-1] for t in tmpls), default=1)
        stack = np.zeros((max(len(tmpls), 1), ntmax))
        for i, t in enumerate(tmpls):
            stack[i, :t.shape[-1]] = t
        self.templates = stack
        tid_of = {pair: i for i, pair in enumerate(pairs)}
        tid = np.array([tid_of[p] for p in zip(chans.tolist(),
                                               tags.tolist())], np.int64)
        lengths = np.array([t.shape[-1] for t in tmpls], np.int64)
        self._names = sorted(set(chans.tolist()))
        code = {name: i for i, name in enumerate(self._names)}
        series = np.asarray(salt_table["series_number"]).astype(np.int64)
        events = np.asarray(salt_table["event_number"]).astype(np.int64)
        # salts sorted by (series, event), in table order within an event
        order = np.lexsort((events, series))
        start = (np.asarray(salt_table["trigger_index"]).astype(np.int64)
                 - np.asarray(pretrig, np.int64)[tid])
        self._start = start[order]
        self._len = lengths[tid][order]
        self._tid = tid[order]
        self._chan = np.array([code[c] for c in chans[order].tolist()],
                              np.int64)
        self._amp = np.asarray(salt_table["salt_amplitude"],
                               np.float64)[order]
        s, ev = series[order], events[order]
        cut = np.flatnonzero((np.diff(s) != 0) | (np.diff(ev) != 0)) + 1
        lo = np.concatenate([[0], cut]).astype(np.int64)
        hi = np.concatenate([cut, [len(s)]]).astype(np.int64)
        self._ranges = {(int(s[a]), int(ev[a])): (int(a), int(b))
                        for a, b in zip(lo, hi) if b > a}
        self._device_templates: dict = {}

    def inject(self, traces: torch.Tensor, series_number, event_number,
               window_starts=None,
               channels: Optional[Sequence[str]] = None) -> SaltPlan:
        """Add the batch's salts into ``traces`` [E, C, N] in place (see
        :meth:`plan` for the arguments); returns the plan."""
        key = (traces.device, traces.dtype)
        if key not in self._device_templates:
            self._device_templates[key] = torch.as_tensor(
                self.templates, dtype=traces.dtype, device=traces.device)
        plan = self.plan(series_number, event_number, traces.shape[-1],
                         window_starts, channels)
        inject_salts(traces, *plan.to(traces.device),
                     self._device_templates[key])
        return plan

    def plan(self, series_number, event_number, nb_samples: int,
             window_starts=None,
             channels: Optional[Sequence[str]] = None) -> SaltPlan:
        """The batch's SaltPlan: event ``i`` is (``series_number[i]``,
        ``event_number[i]``), its traces ``nb_samples`` long from sample
        ``window_starts[i]`` of the event (0 when None), their channel rows
        named by ``channels`` (default: the injector's channel list).

        Only salts on a channel of the injector's list that is also a row
        of the traces, and whose template overlaps the traces, take a
        slot; K is the most slots an event of the batch takes (at least
        1, at most ``max_salts_per_event``, beyond which salts are dropped
        with a warning)."""
        series = np.asarray(series_number).astype(np.int64)
        events = np.asarray(event_number).astype(np.int64)
        nev = len(series)
        ws = (np.zeros(nev, np.int64) if window_starts is None
              else np.asarray(window_starts).astype(np.int64))
        rows = list(self.channel_list if channels is None else channels)
        wanted = set(self.channel_list)
        lookup = np.array([rows.index(c) if c in rows and c in wanted
                           else -1 for c in self._names] + [-1], np.int64)
        bounds = np.array([self._ranges.get((int(a), int(b)), (0, 0))
                           for a, b in zip(series, events)],
                          np.int64).reshape(nev, 2)
        cnt = bounds[:, 1] - bounds[:, 0]
        ev = np.repeat(np.arange(nev), cnt)
        sel = (np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt,
                                                     cnt)
               + np.repeat(bounds[:, 0], cnt))
        row = lookup[self._chan[sel]]
        start = self._start[sel] - ws[ev]
        keep = ((row >= 0) & (start < nb_samples)
                & (start + self._len[sel] > 0))
        ev, sel, row, start = ev[keep], sel[keep], row[keep], start[keep]
        slot = np.arange(len(ev)) - np.searchsorted(ev, ev, side="left")
        over = slot >= self.k
        if over.any():
            print(f"WARNING: {int(over.sum())} salts dropped — more than "
                  f"max_salts_per_event={self.k} in one event; raise "
                  f"make_device_injector(max_salts_per_event=...)")
            ev, sel, row, start, slot = (a[~over] for a in (ev, sel, row,
                                                             start, slot))
        p = empty_plan(nev, int(slot.max()) + 1 if len(slot) else 1)
        p.idx[ev, slot] = start
        p.chan[ev, slot] = row
        p.tid[ev, slot] = self._tid[sel]
        p.amp[ev, slot] = self._amp[sel]
        return p


def split_injector(injector):
    """``(host, device)``: the injector a shell's ``set_salting`` was given,
    as a host callable or as a :class:`DeviceInjector`, the other None."""
    if isinstance(injector, DeviceInjector):
        return None, injector
    return injector, None
