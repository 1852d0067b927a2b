"""Noise: PSDs and CSDs of randoms' windows, after the quality cuts.

Port of ``detprocess_tpu/pipelines/noise.py::Noise`` (:34; the reference's
detprocess/core/noise.py): sample randoms (``pipelines/randoms``), read
their windows onto the device, cut them (``ops/autocuts``), and store the
two-sided PSD of each channel (``calc_psd`` :137) and the CSD of a channel
list (``calc_csd`` :205) with their metadata, and each channel's offset:
the mean over the kept windows of each window's median (:191-192; numpy's
median, the mean of the two middle values for even N).

Every spectrum is the half spectrum of ``ops/fft.rfft`` (the hand-written
kernel on the GPU): one launch a channel for all windows. ``calc_psd`` and
``calc_csd`` over the same channels and geometry share one read of the
windows, each channel's cut mask and its spectra; the CSD averages the
windows that every channel keeps. Compound channels (``a+b``, ``a-b``)
are the weighted sums of ``utils/channels.channel_combination_weights``.

The JAX class's complex-transfer workaround and ``jaxcache`` are TPU
matters and are not ported; ``mesh=`` (the multi-chip mean) raises
``NotImplementedError`` until ROADMAP §1 item 7. ``device=None`` means
the GPU (``device.require_cuda``).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Optional, Sequence

import numpy as np
import torch

from detprocess_tpu_torch import device as dev
from detprocess_tpu_torch.io.filterdata import FilterData
from detprocess_tpu_torch.io.rawdata import RawIndex
from detprocess_tpu_torch.ops import autocuts as cuts
from detprocess_tpu_torch.ops import spectral
from detprocess_tpu_torch.pipelines.randoms import Randoms
from detprocess_tpu_torch.utils import channels as chutils


def torch_dtype(dtype, device: torch.device) -> torch.dtype:
    """``dtype`` (numpy or torch) as a torch dtype; None is float32 on
    the GPU and float64 on the CPU."""
    if dtype is None:
        return torch.float32 if device.type == "cuda" else torch.float64
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype)).dtype


def median_offset(traces: torch.Tensor) -> float:
    """The mean over traces [B, N] of each trace's median (numpy's: the
    mean of the two middle values for even N)."""
    n = traces.shape[-1]
    s = torch.sort(traces, dim=-1).values
    med = (s[:, (n - 1) // 2].double() + s[:, n // 2].double()) / 2
    return float(med.mean())


class _Windows:
    """One read of the randoms' windows [B, C, N] of ``channels`` and
    what is derived from them: each channel's keep-mask (all channels
    cut at once, as a [C, B] mask) and half spectrum."""

    def __init__(self, key, traces: torch.Tensor, channels: list):
        self.key = key
        self.traces = traces
        self.channels = channels
        self.spectra: dict = {}
        self._cuts: dict = {}

    def mask(self, chan: str, nsigma: float):
        """(keep-mask [B], passes of each metric's clip) of ``chan``."""
        if nsigma not in self._cuts:
            stages, passes = cuts.cut_stages(cuts.metrics(self.traces),
                                             nsigma)
            self._cuts[nsigma] = (stages[-1], passes)
        final, passes = self._cuts[nsigma]
        c = self.channels.index(chan)
        return final[c], [int(p[c]) for p in passes]


class Noise(FilterData):
    """PSD/CSD estimation from randoms over continuous raw data (a
    :class:`RawIndex` or pytesdaq paths)."""

    def __init__(self, raw=None, verbose: bool = True, device=None):
        super().__init__(verbose=verbose)
        self._device = (dev.require_cuda() if device is None
                        else torch.device(device))
        self._index = (None if raw is None else raw
                       if isinstance(raw, RawIndex)
                       else RawIndex.from_files(raw))
        self._randoms: Optional[dict] = None
        self._windows: Optional[_Windows] = None
        self._offset: dict = {}
        self._fs: Optional[float] = None
        self.stats: dict = {"kept": {}, "passes": {}}

    def set_randoms(self, randoms):
        """Use an existing randoms table (a dict of columns or a
        DataFrame)."""
        if hasattr(randoms, "columns"):
            randoms = {c: randoms[c].to_numpy() for c in randoms.columns}
        self._randoms = randoms
        self._windows = None

    def clear_randoms(self):
        """Drop the randoms and what was derived from them; the stored
        filter data stays."""
        self._randoms = None
        self._windows = None
        self._offset = {}
        self._fs = None

    def get_randoms(self) -> Optional[dict]:
        return self._randoms

    def get_sample_rate(self) -> Optional[float]:
        """The sample rate (Hz), once calc_psd or calc_csd has run."""
        return self._fs

    def get_offset(self, channel: str) -> Optional[float]:
        """The channel's offset from calc_psd (None, with a warning,
        before)."""
        if channel not in self._offset:
            print(f"WARNING: No offset available for channel {channel}. "
                  "You need to calculate psd first! Returning None.")
            return None
        return self._offset[channel]

    def generate_randoms(self, random_rate: Optional[float] = None,
                         nrandoms: Optional[int] = None,
                         min_separation_msec: float = 100.0,
                         edge_exclusion_msec: float = 50.0,
                         seed: Optional[int] = None, timer=None) -> dict:
        """Sample randoms from the raw data (``Randoms.process``)."""
        if self._index is None:
            raise ValueError("raw data required to generate randoms")
        stage = timer.stage if timer is not None else (
            lambda name: nullcontext())
        with stage("randoms"):
            table = Randoms(self._index, verbose=self._verbose,
                            device=self._device).process(
                random_rate=random_rate, nrandoms=nrandoms,
                min_separation_msec=min_separation_msec,
                edge_exclusion_msec=edge_exclusion_msec, seed=seed)
        self.set_randoms(table)
        return table

    def _get_windows(self, channels: list, n: int, p: int, dtype,
                     timer) -> _Windows:
        """The windows of ``channels`` (read once for a geometry)."""
        if self._randoms is None:
            raise ValueError("no randoms available — call generate_randoms "
                             "or set_randoms first")
        key = (tuple(channels), n, p, dtype)
        if self._windows is None or self._windows.key != key:
            self._windows = None
            randoms = Randoms(self._index, verbose=False, device=self._device)
            traces = randoms.read_random_traces(
                self._randoms, n, p, channels=channels, dtype=dtype,
                timer=timer)
            self.stats.update(randoms.stats)
            self._windows = _Windows(key, traces, list(channels))
        return self._windows

    def _geometry(self, n, p):
        md = self._index.get_metadata()
        fs = float(md["sample_rate"])
        n = n or int(md["nb_samples"])
        return fs, n, (p if p is not None else n // 2)

    @staticmethod
    def _spectrum(win: _Windows, name: str, traces: torch.Tensor, window,
                  stage):
        if (name, window) not in win.spectra:
            with stage("spectra"):
                win.spectra[(name, window)] = spectral.half_spectrum(
                    traces, window)
        return win.spectra[(name, window)]

    def calc_psd(self, channels: Sequence[str] | str,
                 trace_length_samples: Optional[int] = None,
                 pretrigger_length_samples: Optional[int] = None,
                 nsigma_cut: float = 2.5, tag: str = "default",
                 window: Optional[str] = None, dtype=None, mesh=None,
                 timer=None):
        """Each channel's two-sided PSD of the kept randoms, stored as
        ``psd_{tag}``, and its offset."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh=: the multi-GPU spectral mean is ROADMAP §1 item 7")
        if isinstance(channels, str):
            channels = [channels]
        stage = timer.stage if timer is not None else (
            lambda name: nullcontext())
        fs, n, p = self._geometry(trace_length_samples,
                                  pretrigger_length_samples)
        dtype = torch_dtype(dtype, self._device)
        reader_channels = self._index.channels
        combos = []
        for chan in channels:
            subs, weights = chutils.channel_combination_weights(
                chan, reader_channels)
            combos.append((chan, subs, weights))
        needed = sorted({s for _, subs, _ in combos for s in subs},
                        key=reader_channels.index)
        win = self._get_windows(needed, n, p, dtype, timer)
        if win.traces.numel() == 0:
            raise ValueError("no traces available for PSD estimation")
        for chan, subs, weights in combos:
            if len(subs) == 1 and weights[0] == 1.0:
                tr = win.traces[:, needed.index(subs[0])]
                with stage("autocuts"):
                    mask, passes = win.mask(subs[0], nsigma_cut)
            else:
                tr = sum(w * win.traces[:, needed.index(s)]
                         for s, w in zip(subs, weights))
                with stage("autocuts"):
                    stages, passes = cuts.cut_stages(cuts.metrics(tr),
                                                     nsigma_cut)
                mask, passes = stages[-1], [int(p) for p in passes]
            kept = torch.nonzero(mask).flatten()
            nkept = len(kept)
            if nkept == 0:
                raise ValueError(
                    f"autocuts rejected all {len(mask)} randoms for "
                    f"channel {chan} (nsigma_cut={nsigma_cut}) — a PSD "
                    "from zero traces would be all-NaN and poison every "
                    "downstream OF weight; loosen the cut or inspect the "
                    "data")
            with stage("offsets"):
                self._offset[chan] = median_offset(tr[kept])
            self._fs = fs
            spectra, scale = self._spectrum(win, chan, tr, window, stage)
            with stage("spectra"):
                psd = spectral.mean_psd(spectra[kept], n, fs, scale)
                psd = psd.cpu().numpy()
            self.stats["kept"][chan] = nkept
            self.stats["passes"][chan] = passes
            self.set_psd(chan, psd, fs, tag=tag, metadata={
                "nb_randoms": nkept,
                "nb_randoms_total": int(len(mask)),
                "nb_pretrigger_samples": p,
            })
        return self

    def calc_csd(self, channels: Sequence[str],
                 trace_length_samples: Optional[int] = None,
                 pretrigger_length_samples: Optional[int] = None,
                 nsigma_cut: float = 2.5, tag: str = "default",
                 window: Optional[str] = None, dtype=None, mesh=None,
                 timer=None):
        """The CSD [C, C, N] of ``channels`` over the randoms every
        channel keeps, stored under ``'c1|c2|…'``."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh=: the multi-GPU spectral mean is ROADMAP §1 item 7")
        stage = timer.stage if timer is not None else (
            lambda name: nullcontext())
        channels = list(channels)
        fs, n, p = self._geometry(trace_length_samples,
                                  pretrigger_length_samples)
        dtype = torch_dtype(dtype, self._device)
        win = self._get_windows(channels, n, p, dtype, timer)
        if win.traces.numel() == 0:
            raise ValueError("no traces available for CSD estimation")
        with stage("autocuts"):
            mask = torch.stack([win.mask(c, nsigma_cut)[0]
                                for c in channels]).all(dim=0)
        kept = torch.nonzero(mask).flatten()
        if len(kept) == 0:
            raise ValueError(
                f"autocuts rejected all {len(mask)} randoms for CSD "
                f"estimation (nsigma_cut={nsigma_cut})")
        self._fs = fs
        spectra = []
        for c, chan in enumerate(channels):
            x, scale = self._spectrum(win, chan, win.traces[:, c], window,
                                      stage)
            spectra.append(x[kept])
        with stage("spectra"):
            csd = spectral.mean_csd(torch.stack(spectra, dim=1), n, fs,
                                    scale).cpu().numpy()
        self.stats["kept"]["|".join(channels)] = len(kept)
        self.set_csd(channels, csd, fs, tag=tag, metadata={
            "nb_randoms": len(kept),
            "nb_randoms_total": int(len(mask)),
            "nb_pretrigger_samples": p,
        })
        return self
