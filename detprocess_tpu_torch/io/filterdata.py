"""Filter data in memory: tagged templates, PSDs and CSDs per channel.

Port of the part of ``detprocess_tpu/io/filterfile.py::FilterData`` that
the feature shell reads (:223-325): ``set_template``/``get_template``,
``set_psd``/``get_psd`` (with ``fold``) and ``set_csd``/``get_csd``,
each with its metadata dict. A 1-D value keeps its index axis (time for
a template, two-sided frequency for a PSD) beside it, where the JAX
store keeps a ``pd.Series``.

:func:`check_fs_consistent` is the JAX check with its guard repaired: a
stored sample rate is compared whenever it is present, so a stored 0 is
refused (the JAX guard tests truthiness and lets 0 through).

:meth:`FilterData.load_hdf5` reads the JAX package's filter-file layout
(``/{channel}/{param}_{tag}`` groups with a ``_metadata`` attrs group;
``FilterData.load_hdf5`` :450 and ``_read_value`` :577). It imports h5py
when called.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np


def check_fs_consistent(fs_raw, metadata, what, channel, tag):
    """Raise if the sample rate stored with a filter item (``metadata``)
    differs from the raw data's ``fs_raw``; no stored rate passes."""
    got = (metadata or {}).get("sample_rate")
    if got is not None and float(got) != float(fs_raw):
        raise ValueError(
            f"sample rate is not consistent between raw data "
            f"({float(fs_raw):g} Hz) and {what} ({float(got):g} Hz) "
            f"for channel {channel} (tag '{tag}')")


def fold_spectrum(psd: np.ndarray, fs: float):
    """Fold a two-sided PSD onto the non-negative frequencies (all bins
    but DC, and Nyquist for even N, doubled): (freqs, folded)."""
    psd = np.asarray(psd)
    n = psd.shape[-1]
    nfold = n // 2 + 1
    folded = np.array(psd[..., :nfold], copy=True)
    if n % 2 == 0:
        folded[..., 1:-1] *= 2.0
    else:
        folded[..., 1:] *= 2.0
    freqs = np.abs(np.fft.fftfreq(n, d=1.0 / fs)[:nfold])
    return freqs, folded


def estimate_sampling_rate(freq_array: np.ndarray) -> float:
    """Sample rate from a one- or two-sided frequency axis."""
    freq_sorted = np.unique(np.sort(np.asarray(freq_array)))
    positive = freq_sorted[freq_sorted > 0]
    if positive.size == 0:
        raise ValueError("no positive frequencies; cannot infer sampling rate")
    df = positive[0]
    if freq_sorted[0] < 0:
        n = len(freq_array)
    else:
        n = 2 * (len(freq_array) - 1)
    return n * df


class FilterData:
    """Tagged filter store: ``{channel: {param_tag: (value, index,
    metadata)}}``."""

    def __init__(self, verbose: bool = True):
        self._verbose = verbose
        self._filter_data: dict = {}

    def channels(self):
        return list(self._filter_data.keys())

    def _set(self, channel: str, name: str, value, metadata: Optional[dict],
             index=None):
        md = copy.deepcopy(metadata) if metadata else {}
        md.setdefault("channel", channel)
        self._filter_data.setdefault(channel, {})[name] = (value, index, md)

    def _get(self, channel: str, name: str):
        if channel not in self._filter_data:
            raise KeyError(f"no data for channel {channel}")
        chan_dict = self._filter_data[channel]
        if name not in chan_dict:
            raise KeyError(f'no parameter "{name}" for channel {channel}')
        return chan_dict[name]

    # -- templates -------------------------------------------------------
    def set_template(self, channels, template: np.ndarray,
                     sample_rate: float,
                     pretrigger_length_samples: Optional[int] = None,
                     pretrigger_length_msec: Optional[float] = None,
                     tag: str = "default", metadata: Optional[dict] = None):
        """Store a time-domain template: [N], or [M, N] / [C, M, N] for
        several templates."""
        template = np.asarray(template)
        nbins = template.shape[-1]
        if pretrigger_length_samples is None:
            if pretrigger_length_msec is None:
                raise ValueError("pretrigger length required")
            pretrigger_length_samples = int(
                round(pretrigger_length_msec * 1e-3 * sample_rate))
        md = dict(metadata or {})
        md.update({
            "sample_rate": sample_rate,
            "nb_samples": nbins,
            "nb_pretrigger_samples": int(pretrigger_length_samples),
        })
        if isinstance(channels, str):
            channels = [channels]
        for chan in channels:
            # get_template makes the time axis from the sample rate
            self._set(chan, f"template_{tag}", template.copy(), md)

    def get_template(self, channel, tag: str = "default",
                     return_metadata: bool = False):
        arr, time, md = self._get(channel, f"template_{tag}")
        arr = np.asarray(arr)
        if time is None:
            fs = md.get("sample_rate")
            time = np.arange(arr.shape[-1]) / fs if fs else None
        if return_metadata:
            return arr, time, md
        return arr, time

    # -- PSD / CSD -------------------------------------------------------
    def set_psd(self, channels, psd: np.ndarray, sample_rate: float,
                tag: str = "default", metadata: Optional[dict] = None):
        """Store a two-sided PSD [N]."""
        psd = np.asarray(psd)
        n = psd.shape[-1]
        freqs = np.fft.fftfreq(n, d=1.0 / sample_rate)
        md = dict(metadata or {})
        md.update({"sample_rate": sample_rate, "nb_samples": n})
        if isinstance(channels, str):
            channels = [channels]
        for chan in channels:
            self._set(chan, f"psd_{tag}", psd.copy(), md, index=freqs)

    def get_psd(self, channel, tag: str = "default", fold: bool = False,
                return_metadata: bool = False):
        psd, freqs, md = self._get(channel, f"psd_{tag}")
        psd = np.asarray(psd)
        if freqs is None:
            freqs = np.fft.fftfreq(psd.shape[-1],
                                   d=1.0 / md.get("sample_rate"))
        if fold:
            fs = (md["sample_rate"] if "sample_rate" in md
                  else estimate_sampling_rate(freqs))
            freqs, psd = fold_spectrum(psd, fs)
        if return_metadata:
            return psd, freqs, md
        return psd, freqs

    def set_csd(self, channels, csd: np.ndarray, sample_rate: float,
                tag: str = "default", metadata: Optional[dict] = None):
        """Store a two-sided CSD [C, C, N] under the compound channel
        'ch1|ch2|…'."""
        csd = np.asarray(csd)
        md = dict(metadata or {})
        md.update({"sample_rate": sample_rate, "nb_samples": csd.shape[-1]})
        chan = channels if isinstance(channels, str) else "|".join(channels)
        self._set(chan, f"csd_{tag}", csd.copy(), md)

    def get_csd(self, channel, tag: str = "default", fold: bool = False,
                return_metadata: bool = False):
        csd, _, md = self._get(channel, f"csd_{tag}")
        csd = np.asarray(csd)
        fs = md.get("sample_rate")
        freqs = np.fft.fftfreq(csd.shape[-1], d=1.0 / fs) if fs else None
        if fold:
            freqs, csd = fold_spectrum(csd, fs)
        if return_metadata:
            return csd, freqs, md
        return csd, freqs

    # -- HDF5 adapter ----------------------------------------------------
    def load_hdf5(self, path: str, overwrite: bool = False) -> "FilterData":
        """Merge the filter file at ``path`` (the JAX package's layout)
        into the store; present parameters stay unless ``overwrite``."""
        import h5py

        with h5py.File(path, "r") as f:
            for chan in f:
                cg = f[chan]
                chan_dict = self._filter_data.setdefault(chan, {})
                for name in cg:
                    if not overwrite and name in chan_dict:
                        continue
                    g = cg[name]
                    value, index = _read_value(g)
                    md = dict(g["_metadata"].attrs) if "_metadata" in g \
                        else {}
                    chan_dict[name] = (value, index, md)
        return self


def _read_array(node):
    import h5py

    if isinstance(node, h5py.Group) and node.attrs.get("__complex__"):
        return node["re"][...] + 1j * node["im"][...]
    arr = node[...]
    if arr.dtype.kind == "S":
        arr = arr.astype(str)
    return arr


def _read_dict(vg) -> dict:
    import h5py

    out = dict(vg.attrs)
    out.pop("__subdict__", None)
    for k in vg:
        node = vg[k]
        if isinstance(node, h5py.Group) and node.attrs.get("__subdict__"):
            out[k] = _read_dict(node)
        else:
            out[k] = _read_array(node)
    return out


def _read_value(g):
    """(value, index) of one stored parameter group; a table comes back
    as a dict of columns."""
    import h5py

    kind = g.attrs.get("__type__", "array")
    if kind == "series":
        return _read_array(g["values"]), g["index"][...]
    if kind == "dataframe":
        data = {}
        for c in g.attrs["__columns__"]:
            node = g["columns"][c]
            if isinstance(node, h5py.Group) and node.attrs.get(
                    "__array_rows__"):
                stack = _read_array(node["stack"])
                lengths = node["lengths"][...]
                data[c] = [stack[i, : lengths[i]] if lengths[i] > 0
                           else None for i in range(len(lengths))]
            else:
                data[c] = _read_array(node)
        return data, None
    if kind == "array":
        return _read_array(g["values"]), None
    if kind == "dict":
        return _read_dict(g["values"]), None
    if kind == "scalar":
        return g.attrs["value"], None
    raise ValueError(f"unknown stored type: {kind}")
