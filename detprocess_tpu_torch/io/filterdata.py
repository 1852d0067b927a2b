"""Filter data in memory and in HDF5 files: tagged templates, PSDs and
CSDs, dPdI, IV-sweep and dIdV results per channel.

Port of ``detprocess_tpu/io/filterfile.py::FilterData``: the accessors
(``set_template``/``get_template``, ``set_psd``/``get_psd`` with
``fold``, ``set_csd``/``get_csd``, ``set_dpdi``/``get_dpdi`` :327-352,
the IV-sweep, dIdV and noise tables and results :363-424, ``has``,
``clear_data`` :175, ``set_data`` :203, ``describe`` :104), each value
with its metadata dict. A 1-D value keeps its index axis (time for a
template, two-sided frequency for a PSD) beside it, where the JAX store
keeps a ``pd.Series``; a table (a DataFrame there) is a :class:`Table`,
a dict of numpy columns.

:func:`check_fs_consistent` is the JAX check with its guard repaired: a
stored sample rate is compared whenever it is present, so a stored 0 is
refused (the JAX guard tests truthiness and lets 0 through).

:meth:`FilterData.load_hdf5` and :meth:`FilterData.save_hdf5` are h5py
adapters (h5py is imported when they are called) for the JAX package's
filter-file layout: ``/{channel}/{param}_{tag}`` groups with a
``_metadata`` attrs group (``save_hdf5`` :426, ``_write_value`` :467,
``_write_dict`` :530, ``_write_array`` :553, ``load_hdf5`` :450,
``_read_value`` :577).

:meth:`FilterData.save_npz` and :meth:`FilterData.load_npz` hold the same
store in one ``numpy.savez`` file for machines without h5py: the arrays
under keys of their own, and the layout (parameter kinds, dict values,
metadata) as JSON under ``__manifest__``. They write what ``save_hdf5``
writes and read back what ``load_hdf5`` reads (strings as unicode, None
dropped from dicts and metadata, a missing string cell as ""). The form
of a path is its suffix: :meth:`FilterData.save` and
:meth:`FilterData.load` take ``.npz`` as npz and ``.hdf5``/``.h5`` as
HDF5, and refuse any other by name.

The ``plot_*`` methods are the JAX store's delegates (io/filterfile.py
:75-102) into ``utils/plotting``, which imports matplotlib.
"""

from __future__ import annotations

import copy
import json
import os
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


class Table(dict):
    """A stored table: ``{column: numpy array}`` (or, for a column of
    array-valued cells, a list of arrays and None)."""


def as_table(table) -> Table:
    """A :class:`Table` of a dict of columns or of a DataFrame."""
    if isinstance(table, dict):
        return Table({k: v if isinstance(v, list) else np.asarray(v)
                      for k, v in table.items()})
    if hasattr(table, "columns"):
        return Table({str(c): table[c].to_numpy() for c in table.columns})
    raise ValueError("ERROR: Input is not a table (a dict of columns or a "
                     "DataFrame)!")


def records_table(rows) -> Table:
    """The :class:`Table` of a list of row dicts, as ``pd.DataFrame(rows)``
    lays it out: the columns in order of first appearance; a column of
    scalars becomes a numpy array (NaN where a row lacks it, a str column
    an object array, None where missing), a column with an array or dict
    cell a list (None where missing)."""
    cols: list = []
    for r in rows:
        for k in r:
            if k not in cols:
                cols.append(k)
    table = Table()
    for c in cols:
        cells = [r.get(c) for r in rows]
        present = [v for v in cells if v is not None]
        if any(isinstance(v, (np.ndarray, dict, list, tuple))
               for v in present):
            table[c] = cells
        elif any(isinstance(v, str) for v in present):
            table[c] = np.array(cells, dtype=object)
        elif present and all(isinstance(v, (int, np.integer))
                             and not isinstance(v, (bool, np.bool_))
                             for v in present) and len(present) == len(cells):
            table[c] = np.array(cells, dtype=np.int64)
        else:
            table[c] = np.array([np.nan if v is None else v for v in cells],
                                dtype=float)
    return table


class FilterData:
    """Tagged filter store: ``{channel: {param_tag: (value, index,
    metadata)}}``."""

    def __init__(self, verbose: bool = True):
        self._verbose = verbose
        self._filter_data: dict = {}

    @property
    def data(self) -> dict:
        """The store itself; stores that assign it share one dict."""
        return self._filter_data

    @property
    def verbose(self) -> bool:
        return self._verbose

    @verbose.setter
    def verbose(self, value: bool):
        self._verbose = bool(value)

    def channels(self):
        return list(self._filter_data.keys())

    def has(self, channel: str, name: str) -> bool:
        return name in self._filter_data.get(channel, {})

    def clear_data(self, channels=None, tag=None):
        """Clear everything; or drop ``channels``; or, with ``tag`` too,
        every parameter of those channels whose name contains ``tag``."""
        if channels is None and tag is not None:
            raise ValueError(
                'ERROR: "channels" argument needed when "tag" is provided')
        if channels is None:
            self._filter_data.clear()
            return
        if isinstance(channels, str):
            channels = [channels]
        for chan in channels:
            if chan not in self._filter_data:
                continue
            if tag is None:
                self._filter_data.pop(chan)
            else:
                for key in [k for k in self._filter_data[chan] if tag in k]:
                    self._filter_data[chan].pop(key)

    def set_data(self, data: dict, overwrite: bool = False):
        """Merge ``{channel: {param: (value, index, metadata)}}`` into the
        store; present parameters stay unless ``overwrite``."""
        if not isinstance(data, dict):
            raise ValueError("ERROR: filter data should be a dictionary!")
        for chan, params in data.items():
            if chan not in self._filter_data:
                self._filter_data[chan] = params
                continue
            for name, value in params.items():
                if overwrite or name not in self._filter_data[chan]:
                    self._filter_data[chan][name] = value

    def describe(self, channels=None):
        """Print each channel's parameters with type, shape, sample rate
        and pretrigger length (and SC/normal point counts of IV-sweep
        tables); ``channels`` filters by substring."""
        if isinstance(channels, str):
            channels = [channels]
        shown = [c for c in self._filter_data
                 if channels is None or any(u in c for u in channels)]
        print(f"List of channels: {shown}")
        for chan in shown:
            print(f"\nChannel {chan}:")
            for name, (val, index, md) in self._filter_data[chan].items():
                if isinstance(val, Table):
                    kind, shape = "table", None
                elif isinstance(val, np.ndarray):
                    kind = ("series" if index is not None
                            else f"{val.ndim}D numpy.array")
                    shape = val.shape
                else:
                    kind, shape = type(val).__name__, None
                msg = f" * {name}: {kind}"
                if shape is not None:
                    msg += f" {tuple(shape)}"
                extras = []
                if "sample_rate" in md:
                    extras.append(f"fs={float(md['sample_rate']):g} Hz")
                if "nb_pretrigger_samples" in md:
                    extras.append(
                        f"pretrigger={int(md['nb_pretrigger_samples'])}")
                if (name.startswith("ivsweep_data") and isinstance(val, Table)
                        and "state" in val):
                    st = np.asarray(val["state"]).astype(str)
                    extras.append(f"SC points={int((st == 'sc').sum())}")
                    extras.append(
                        f"normal points={int((st == 'normal').sum())}")
                if extras:
                    msg += "  [" + ", ".join(extras) + "]"
                print(msg)

    # -- plots (utils/plotting, matplotlib imported there) -----------------
    def plot_template(self, channels, tag="default", ax=None):
        from detprocess_tpu_torch.utils import plotting
        if isinstance(channels, str):
            channels = [channels]
        for chan in channels:
            ax = plotting.plot_template(self, chan, tag=tag, ax=ax)
        return ax

    def plot_psd(self, channels, tag="default", fold=True, ax=None):
        from detprocess_tpu_torch.utils import plotting
        return plotting.plot_psd(self, channels, tag=tag, fold=fold, ax=ax)

    def plot_csd(self, channels, tag="default", ax=None):
        from detprocess_tpu_torch.utils import plotting
        return plotting.plot_csd(self, channels, tag=tag, ax=ax)

    def plot_corrcoeff(self, channels, tag="default", lgcsmooth=True,
                       nwindow=7, ax=None):
        from detprocess_tpu_torch.utils import plotting
        return plotting.plot_corrcoeff(self, channels, tag=tag,
                                       lgcsmooth=lgcsmooth,
                                       nwindow=nwindow, ax=ax)

    def plot_ivsweep_offset(self, channel, tag="default", ax=None):
        from detprocess_tpu_torch.utils import plotting
        return plotting.plot_ivsweep_offset(self, channel, tag=tag, ax=ax)

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
        t = np.arange(nbins) / sample_rate if template.ndim == 1 else None
        if isinstance(channels, str):
            channels = [channels]
        for chan in channels:
            self._set(chan, f"template_{tag}", template.copy(), md, index=t)

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

    # -- dPdI --------------------------------------------------------------
    def set_dpdi(self, channels, dpdi: np.ndarray, freqs: np.ndarray,
                 poles: int, tag: str = "default",
                 metadata: Optional[dict] = None):
        md = dict(metadata or {})
        md["poles"] = int(poles)
        if isinstance(channels, str):
            channels = [channels]
        for chan in channels:
            self._set(chan, f"dpdi_{poles}poles_{tag}", np.asarray(dpdi), md)
            self._set(chan, f"dpdi_{poles}poles_{tag}_freqs",
                      np.asarray(freqs), md)

    def get_dpdi(self, channel, poles: int, tag: str = "default",
                 return_metadata: bool = False):
        dpdi, _, md = self._get(channel, f"dpdi_{poles}poles_{tag}")
        freqs, _, _ = self._get(channel, f"dpdi_{poles}poles_{tag}_freqs")
        if return_metadata:
            return np.asarray(dpdi), np.asarray(freqs), md
        return np.asarray(dpdi), np.asarray(freqs)

    # -- IV sweep, dIdV and noise results ----------------------------------
    def set_ivsweep_data_from_dict(self, data_dict: dict,
                                   tag: str = "default"):
        for chan, table in data_dict.items():
            self.set_ivsweep_data(chan, table, tag=tag)

    def set_ivsweep_data(self, channel, table, tag: str = "default",
                         metadata: Optional[dict] = None):
        self._set(channel, f"ivsweep_data_{tag}", as_table(table), metadata)

    def get_ivsweep_data(self, channel, tag: str = "default") -> Table:
        return self._get(channel, f"ivsweep_data_{tag}")[0]

    def set_ivsweep_results(self, channel, results: dict, measurement: str,
                            tag: str = "default",
                            metadata: Optional[dict] = None):
        self._set(channel, f"ivsweep_results_{measurement}_{tag}",
                  results, metadata)

    def get_ivsweep_results(self, channel, measurement: str,
                            tag: str = "default"):
        return self._get(channel,
                         f"ivsweep_results_{measurement}_{tag}")[0]

    def set_didv_results(self, channel, results: dict, poles: int,
                         tag: str = "default",
                         metadata: Optional[dict] = None):
        self._set(channel, f"didv_results_{poles}poles_{tag}", results,
                  metadata)

    def get_didv_results(self, channel, poles: int, tag: str = "default"):
        return self._get(channel, f"didv_results_{poles}poles_{tag}")[0]

    def set_didv_dataframe(self, channel, table,
                           metadata: Optional[dict] = None,
                           tag: str = "default"):
        """Store a dIdV-processing table under ``didv_processing_{tag}``."""
        self._set(channel, f"didv_processing_{tag}", as_table(table),
                  metadata)

    def get_didv_dataframe(self, channel, tag: str = "default") -> Table:
        return self._get(channel, f"didv_processing_{tag}")[0]

    def set_noise_dataframe(self, channel, table,
                            metadata: Optional[dict] = None,
                            tag: str = "default"):
        """Store a noise-processing table under ``noise_processing_{tag}``."""
        self._set(channel, f"noise_processing_{tag}", as_table(table),
                  metadata)

    def get_noise_dataframe(self, channel, tag: str = "default") -> Table:
        return self._get(channel, f"noise_processing_{tag}")[0]

    # -- files ---------------------------------------------------------------
    def save(self, path: str, overwrite: bool = True):
        """Write the store in the form of ``path``'s suffix (``.npz``, or
        ``.hdf5``/``.h5`` through h5py)."""
        if file_form(path) == "npz":
            self.save_npz(path, overwrite=overwrite)
        else:
            self.save_hdf5(path, overwrite=overwrite)

    def load(self, path: str, overwrite: bool = False) -> "FilterData":
        """Merge the filter file at ``path`` into the store, in the form of
        its suffix (``.npz``, or ``.hdf5``/``.h5`` through h5py)."""
        if file_form(path) == "npz":
            return self.load_npz(path, overwrite=overwrite)
        return self.load_hdf5(path, overwrite=overwrite)

    def save_npz(self, path: str, overwrite: bool = True):
        """Write the store at ``path`` as one ``.npz`` file; without
        ``overwrite`` an existing file's other parameters are kept."""
        store = self._filter_data
        if not overwrite and os.path.exists(path):
            old = FilterData(verbose=False).load_npz(path)
            for chan, params in store.items():
                old._filter_data.setdefault(chan, {}).update(params)
            store = old._filter_data
        writer = _NpzWriter()
        items = []
        for chan, params in store.items():
            for name, (value, index, md) in params.items():
                items.append({"channel": chan, "name": name,
                              "value": writer.value(value, index),
                              "metadata": writer.dict(md or {})})
        manifest = json.dumps({"format": NPZ_FORMAT, "items": items})
        with open(path, "wb") as f:
            np.savez(f, __manifest__=np.array(manifest), **writer.arrays)
        if self._verbose:
            print(f"INFO: filter data saved to {path}")

    def load_npz(self, path: str, overwrite: bool = False) -> "FilterData":
        """Merge the ``.npz`` filter file at ``path`` into the store;
        present parameters stay unless ``overwrite``."""
        with np.load(path, allow_pickle=False) as z:
            manifest = json.loads(str(z["__manifest__"]))
            if manifest.get("format") != NPZ_FORMAT:
                raise ValueError(f"'{path}' is not a filter file of this "
                                 f"package (format {manifest.get('format')!r},"
                                 f" expected {NPZ_FORMAT!r})")
            reader = _NpzReader(z)
            for item in manifest["items"]:
                chan_dict = self._filter_data.setdefault(item["channel"], {})
                if not overwrite and item["name"] in chan_dict:
                    continue
                value, index = reader.value(item["value"])
                chan_dict[item["name"]] = (value, index,
                                           reader.dict(item["metadata"]))
        return self

    # -- HDF5 adapter ----------------------------------------------------
    def save_hdf5(self, path: str, overwrite: bool = True):
        """Write the store at ``path`` in the JAX package's layout (mode
        "w", or "a" without ``overwrite``, replacing the parameters it
        writes)."""
        import h5py

        with h5py.File(path, "w" if overwrite else "a") as f:
            for chan, params in self._filter_data.items():
                cg = f.require_group(chan)
                for name, (value, index, md) in params.items():
                    if name in cg:
                        del cg[name]
                    g = cg.create_group(name)
                    _write_value(g, value, index)
                    mg = g.create_group("_metadata")
                    for k, v in (md or {}).items():
                        if v is None:
                            continue
                        try:
                            mg.attrs[k] = v
                        except TypeError:
                            mg.attrs[k] = str(v)
        if self._verbose:
            print(f"INFO: filter data saved to {path}")

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
                data[c] = _rows_of_stack(_read_array(node["stack"]),
                                         node["lengths"][...])
            else:
                data[c] = _read_array(node)
        return Table(data), None
    if kind == "array":
        return _read_array(g["values"]), None
    if kind == "dict":
        return _read_dict(g["values"]), None
    if kind == "scalar":
        return g.attrs["value"], None
    raise ValueError(f"unknown stored type: {kind}")


def _write_value(g, value, index):
    """One parameter's group: a 1-D array with its index as a series, a
    :class:`Table` as a dataframe, an array, a dict, or a scalar."""
    if isinstance(value, np.ndarray) and index is not None:
        g.attrs["__type__"] = "series"
        _write_array(g, "values", value)
        g.create_dataset("index", data=np.asarray(index))
    elif isinstance(value, Table):
        g.attrs["__type__"] = "dataframe"
        cols = g.create_group("columns")
        written = []
        for col, arr in value.items():
            if isinstance(arr, list) or np.asarray(arr).dtype == object:
                cells = list(arr)
                if _write_array_rows(cols, str(col), cells):
                    written.append(str(col))
                    continue
                if not _scalar_cells(cells):
                    continue      # cells that cannot be stored
                arr = np.asarray(cells, dtype=object)
            _write_array(cols, str(col), arr)
            written.append(str(col))
        g.attrs["__columns__"] = written
    elif isinstance(value, np.ndarray):
        g.attrs["__type__"] = "array"
        _write_array(g, "values", value)
    elif isinstance(value, dict):
        g.attrs["__type__"] = "dict"
        _write_dict(g.create_group("values"), value)
    else:
        g.attrs["__type__"] = "scalar"
        g.attrs["value"] = value


def _array_rows(cells):
    """Array-valued cells (one 1-D array a row, None where missing) as a
    NaN-padded stack and the rows' lengths; None when the cells are not
    such arrays."""
    rows = [np.asarray(v) for v in cells if isinstance(v, np.ndarray)]
    if not rows or not all(r.ndim == 1 for r in rows):
        return None
    width = max(r.shape[0] for r in rows)
    dt = complex if any(np.iscomplexobj(r) for r in rows) else float
    stack = np.full((len(cells), width), np.nan, dtype=dt)
    lengths = np.zeros(len(cells), dtype=np.int64)
    for i, v in enumerate(cells):
        if isinstance(v, np.ndarray):
            stack[i, : v.shape[0]] = v
            lengths[i] = v.shape[0]
    return stack, lengths


def _rows_of_stack(stack, lengths) -> list:
    return [stack[i, : lengths[i]] if lengths[i] > 0 else None
            for i in range(len(lengths))]


def _scalar_cells(cells) -> bool:
    """Cells a table column can store as strings or numbers."""
    return all(isinstance(v, (str, bytes, int, float, np.floating,
                              np.integer, type(None), bool)) for v in cells)


def _write_array_rows(cols, name: str, cells) -> bool:
    """Array-valued cells as a ``stack`` and ``lengths`` group; False when
    the cells are not such arrays (:func:`_array_rows`)."""
    packed = _array_rows(cells)
    if packed is None:
        return False
    stack, lengths = packed
    sub = cols.create_group(name)
    sub.attrs["__array_rows__"] = True
    _write_array(sub, "stack", stack)
    sub.create_dataset("lengths", data=lengths)
    return True


def _write_dict(vg, value: dict):
    """Scalars as attrs, arrays as datasets, nested dicts as
    ``__subdict__`` groups."""
    for k, v in value.items():
        if isinstance(v, dict):
            sub = vg.create_group(str(k))
            sub.attrs["__subdict__"] = True
            _write_dict(sub, v)
        elif isinstance(v, (np.ndarray, list)):
            _write_array(vg, str(k), np.asarray(v))
        elif v is None:
            continue
        else:
            try:
                vg.attrs[str(k)] = v
            except TypeError:
                vg.attrs[str(k)] = str(v)


def _write_array(parent, name, arr):
    """A dataset; strings as bytes, complex values as a re/im group."""
    arr = np.asarray(arr)
    if arr.dtype == object:
        arr = np.asarray(["" if v is None else str(v) for v in arr],
                         dtype="S")
    elif arr.dtype.kind == "U":
        arr = arr.astype("S")
    if np.iscomplexobj(arr):
        g = parent.create_group(name)
        g.attrs["__complex__"] = True
        g.create_dataset("re", data=arr.real)
        g.create_dataset("im", data=arr.imag)
    else:
        parent.create_dataset(name, data=arr)


# -- the npz form ---------------------------------------------------------

NPZ_FORMAT = "detprocess_tpu_torch.filterdata/1"
HDF5_SUFFIXES = (".hdf5", ".h5")


def file_form(path: str) -> str:
    """'npz' or 'hdf5' by the suffix of ``path``; any other is refused."""
    low = path.lower()
    if low.endswith(".npz"):
        return "npz"
    if low.endswith(HDF5_SUFFIXES):
        return "hdf5"
    raise ValueError(f"filter file '{path}': the suffix names no form "
                     "(.npz, or .hdf5/.h5 for HDF5)")


def _npz_array(arr) -> np.ndarray:
    """An array as ``_write_array`` stores it and ``_read_array`` reads it
    back: strings (and an object array's cells, None as "") as
    unicode."""
    arr = np.asarray(arr)
    if arr.dtype == object:
        return np.array(["" if v is None else str(v) for v in arr], dtype=str)
    if arr.dtype.kind == "S":
        return arr.astype(str)
    return arr


def _json_scalar(v):
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, complex):
        return {"__complex__": [v.real, v.imag]}
    if isinstance(v, bytes):
        return v.decode()
    if isinstance(v, (bool, int, float, str)):
        return v
    return str(v)


class _NpzWriter:
    """Arrays under keys a0, a1, …; everything else as JSON."""

    def __init__(self):
        self.arrays: dict = {}

    def array(self, arr) -> dict:
        key = f"a{len(self.arrays)}"
        self.arrays[key] = _npz_array(arr)
        return {"__array__": key}

    def dict(self, value: dict) -> dict:
        """A dict as ``_write_dict`` stores it: None dropped, lists as
        arrays, nested dicts kept."""
        out = {}
        for k, v in value.items():
            if isinstance(v, dict):
                out[str(k)] = {"__dict__": self.dict(v)}
            elif isinstance(v, (np.ndarray, list, tuple)):
                out[str(k)] = self.array(np.asarray(v))
            elif v is not None:
                out[str(k)] = _json_scalar(v)
        return out

    def value(self, value, index) -> dict:
        """One parameter as ``_write_value`` stores it."""
        if isinstance(value, np.ndarray) and index is not None:
            return {"kind": "series", "values": self.array(value),
                    "index": self.array(np.asarray(index))}
        if isinstance(value, Table):
            cols = []
            for col, arr in value.items():
                if isinstance(arr, list) or np.asarray(arr).dtype == object:
                    cells = list(arr)
                    packed = _array_rows(cells)
                    if packed is not None:
                        cols.append([str(col), {
                            "stack": self.array(packed[0]),
                            "lengths": self.array(packed[1])}])
                        continue
                    if not _scalar_cells(cells):
                        continue      # cells that cannot be stored
                    arr = np.asarray(cells, dtype=object)
                cols.append([str(col), self.array(arr)])
            return {"kind": "dataframe", "columns": cols}
        if isinstance(value, np.ndarray):
            return {"kind": "array", "values": self.array(value)}
        if isinstance(value, dict):
            return {"kind": "dict", "values": self.dict(value)}
        return {"kind": "scalar", "value": _json_scalar(value)}


class _NpzReader:
    def __init__(self, npz):
        self._npz = npz

    def item(self, v):
        if isinstance(v, dict):
            if "__array__" in v:
                return self._npz[v["__array__"]]
            if "__complex__" in v:
                return complex(*v["__complex__"])
            if "__dict__" in v:
                return self.dict(v["__dict__"])
        return v

    def dict(self, value: dict) -> dict:
        return {k: self.item(v) for k, v in value.items()}

    def value(self, spec: dict):
        kind = spec["kind"]
        if kind == "series":
            return self.item(spec["values"]), self.item(spec["index"])
        if kind == "dataframe":
            data = {}
            for col, node in spec["columns"]:
                data[col] = (_rows_of_stack(self.item(node["stack"]),
                                            self.item(node["lengths"]))
                             if "stack" in node else self.item(node))
            return Table(data), None
        if kind == "array":
            return self.item(spec["values"]), None
        if kind == "dict":
            return self.dict(spec["values"]), None
        if kind == "scalar":
            return self.item(spec["value"]), None
        raise ValueError(f"unknown stored type: {kind}")
