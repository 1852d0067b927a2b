"""Salting: simulated pulses injected into raw traces, and the trigger
efficiency they measure.

Port of ``detprocess_tpu/pipelines/salting.py`` (the reference's
detprocess/core/salting.py): :func:`sample_from_pdf` (:31),
:func:`sample_pdf_function` (:55), :func:`load_dm_pdf_file` (:71), the
:class:`Salting` class (:83) and :func:`salt_efficiency` (:479), on the
port's column tables (dicts of numpy columns, ``io/tables.py``). pandas is
imported only by the adapters that take a DataFrame
(:meth:`Salting.set_dataframe`, :func:`salt_efficiency`), h5py only by
:meth:`Salting.set_raw_data` and :meth:`Salting.save`.

- :meth:`Salting.generate_salt` draws the salts' times with the port's
  :class:`~detprocess_tpu_torch.pipelines.randoms.Randoms` (the JAX draws
  in the JAX order) and their energies from fixed values, a tabulated
  dR/dE, a pickled DM spectrum file or earlier :meth:`Salting.sample_DMpdf`
  draws, and scales each channel's share to a template amplitude by
  ``energy_norm_ev_per_amp`` or, without it, the energy normalization of
  the filter data's dPdI (``models/didv.energy_normalization``);
- :meth:`Salting.make_injector` gives the host injector, which adds the
  salts into an event's float traces as they are read
  (:meth:`Salting.inject_raw_salt`), and :meth:`Salting.make_device_injector`
  the device one (``ops/saltinject.DeviceInjector``), which keeps the
  int16 upload. Both map channels by name; the JAX injectors index the
  trace by position in the caller's list;
- :func:`salt_efficiency` matches salts to triggers of the same (series,
  event) by one sorted search instead of row loops.

The (series, event) index of the salts is built when the table is set,
so that reader threads only read it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from detprocess_tpu_torch.io import tables
from detprocess_tpu_torch.io.filterdata import FilterData
from detprocess_tpu_torch.models import didv
from detprocess_tpu_torch.ops.saltinject import DeviceInjector
from detprocess_tpu_torch.pipelines.randoms import Randoms
from detprocess_tpu_torch.utils.misc import create_series_name

EV_PER_JOULE = 6.241509074e18


def sample_from_pdf(energies: np.ndarray, drde: np.ndarray, nsamples: int,
                    rng: np.random.Generator) -> np.ndarray:
    """Inverse-transform sampling from a tabulated dR/dE spectrum; the CDF
    integrates by the trapezoid rule over the (often log-spaced) grid."""
    energies = np.asarray(energies, float)
    drde = np.clip(np.asarray(drde, float), 0, None)
    if len(energies) < 2:
        raise ValueError("need at least two tabulated energies")
    cdf = np.concatenate(
        [[0.0],
         np.cumsum(0.5 * (drde[1:] + drde[:-1]) * np.diff(energies))])
    if cdf[-1] <= 0:
        raise ValueError("PDF has no positive weight")
    cdf = cdf / cdf[-1]
    u = rng.random(nsamples)
    return np.interp(u, cdf, energies)


def sample_pdf_function(function, xrange, nsamples: int,
                        rng: np.random.Generator,
                        npoints: int = 10000) -> np.ndarray:
    """Inverse-transform sampling from a callable 1-D PDF over ``xrange``:
    a trapezoid CDF on an ``npoints`` grid, inverted at uniform draws."""
    x = np.linspace(xrange[0], xrange[1], num=npoints)
    pdf = np.clip(np.asarray(function(x), float), 0, None)
    cdf = np.concatenate(
        [[0.0], np.cumsum(0.5 * (pdf[1:] + pdf[:-1]) * np.diff(x))])
    if cdf[-1] <= 0:
        raise ValueError("PDF has no positive weight over xrange")
    cdf /= cdf[-1]
    return np.interp(rng.random(nsamples), cdf, x)


def load_dm_pdf_file(pdf_file: str) -> dict:
    """A pickled ``{mass_MeV: {"dmrate": callable}}`` spectrum dictionary
    (written with cloudpickle, since the rate models are closures)."""
    try:
        import cloudpickle as pickle_mod
    except ImportError:
        import pickle as pickle_mod
    with open(pdf_file, "rb") as f:
        return pickle_mod.load(f)


def _as_table(table) -> dict:
    """A dict of numpy columns from a table or a DataFrame."""
    if isinstance(table, dict):
        return {k: np.asarray(v) for k, v in table.items()}
    return {c: table[c].to_numpy() for c in table.columns}


def _event_index(series, events) -> dict:
    """{(series, event): row positions in table order} of a table."""
    series = np.asarray(series).astype(np.int64)
    events = np.asarray(events).astype(np.int64)
    order = np.lexsort((events, series))
    s, e = series[order], events[order]
    cut = np.flatnonzero((np.diff(s) != 0) | (np.diff(e) != 0)) + 1
    return {(int(series[g[0]]), int(events[g[0]])): g
            for g in np.split(order, cut) if len(g)}


class Salting:
    """Salt generation and injection."""

    def __init__(self, filter_data: FilterData | str, verbose: bool = True):
        if isinstance(filter_data, str):
            filter_data = FilterData(verbose=verbose).load(filter_data)
        self._filter_data = filter_data
        self._verbose = verbose
        self._table: Optional[dict] = None
        self._by_event: dict = {}
        self._templates: Dict[tuple, np.ndarray] = {}
        self._pretriggers: Dict[tuple, int] = {}
        self._rawdata = None
        self._fs: Optional[float] = None
        self._dm_energies = np.array([])
        self._channel_energies: Optional[list] = None

    # -- accessors (JAX :101-221) ------------------------------------------
    @property
    def dataframe(self) -> Optional[dict]:
        return self._table

    def get_dataframe(self) -> Optional[dict]:
        """The salting table (a dict of numpy columns)."""
        return self._table

    def clear_dataframe(self):
        self._set_table(None)

    def get_injectiontimes(self) -> Optional[dict]:
        """The injection times: the rows of the salting table."""
        return self._table

    def get_sample_rate(self) -> Optional[float]:
        """Sample rate of the raw data set by :meth:`set_raw_data`."""
        return self._fs

    def set_raw_data(self, raw_data, series=None, restricted: bool = False):
        """Attach the continuous raw data that salts go into: a group
        directory or a :class:`~detprocess_tpu_torch.io.rawdata.RawData`
        (pytesdaq or flat files); :meth:`generate_salt` then needs no
        ``raw_files``."""
        from detprocess_tpu_torch.io.rawdata import RawData

        if isinstance(raw_data, str):
            raw_data = RawData(raw_data, data_type="continuous",
                               series=series, restricted=restricted)
        elif not isinstance(raw_data, RawData):
            raise ValueError("ERROR: raw data argument should be either "
                             "a directory or RawData object")
        elif raw_data.restricted != restricted:
            raise ValueError(
                f"ERROR: Unable to use RawData object. It needs "
                f"requirement restricted = {restricted}!")
        self._rawdata = raw_data
        self._fs = float(raw_data.get_sample_rate())
        if self._verbose:
            print("INFO: Data used for salting generation:")
            raw_data.describe()
        return self

    def _raw_files_from_store(self):
        if self._rawdata is None:
            raise ValueError(
                "no raw data — pass raw_files or call set_raw_data first")
        files = []
        for flist in self._rawdata.get_data_files().values():
            files.extend(flist)
        return sorted(files)

    def sample_DMpdf(self, function, xrange, nsamples: int = 1000,
                     npoints: int = 10000, normalize_cdf: bool = True,
                     seed: Optional[int] = None):
        """Inverse-transform sampling of a dark-matter recoil PDF in keV.
        Returns the keV draws and keeps them (×1e3, in eV) for later
        :meth:`generate_salt` calls."""
        del normalize_cdf          # the CDF is always normalized over xrange
        rng = np.random.default_rng(seed)
        sampled = sample_pdf_function(function, xrange, nsamples, rng,
                                      npoints=npoints)
        self._dm_energies = np.append(self._dm_energies, sampled * 1e3)
        return sampled

    def get_DMenergies(self) -> np.ndarray:
        """The kept DM energies in eV."""
        return self._dm_energies

    def clear_DMenergies(self):
        self._dm_energies = np.array([])

    def channel_energy_split(self, mean: float = 0.5,
                             std_dev: float = 0.2, npairs: int = 10,
                             seed: Optional[int] = None) -> list:
        """Random per-channel energy-sharing pairs: Gaussian draws clipped
        to [0, 1] and normalized to sum to 1."""
        rng = np.random.default_rng(seed)
        splits = []
        for _ in range(npairs):
            pair = np.clip(rng.normal(loc=mean, scale=std_dev, size=2),
                           0.0, 1.0)
            if pair.sum() > 0:
                pair = pair / pair.sum()
            splits.append(pair)
        self._channel_energies = splits
        return splits

    def get_energy_perchannel(self):
        return self._channel_energies

    @staticmethod
    def set_energy_splits_to1(energysplits: list) -> list:
        """Every split fraction set to 1: the full energy in every
        channel."""
        for sublist in energysplits:
            sublist[:] = [1] * len(sublist)
        return energysplits

    def set_dataframe(self, table):
        """Use an existing salting table (a dict of numpy columns or a
        DataFrame). The templates are loaded per (channel,
        salt_template_tag), so injection uses the pulse shapes the salts
        were made with."""
        self._set_table(_as_table(table))
        self._load_table_templates()

    def _set_table(self, table: Optional[dict]):
        self._table = table
        self._by_event = ({} if table is None or not len(
            table.get("salt_channel", ())) else _event_index(
            table["series_number"], table["event_number"]))

    def _load_table_templates(self):
        """Load the template of every (channel, salt_template_tag) of the
        table, so that injection only reads them."""
        table = self._table
        if table is None:
            return
        chans = np.asarray(table.get("salt_channel", ())).astype(str).tolist()
        tags = (np.asarray(table["salt_template_tag"]).astype(str).tolist()
                if "salt_template_tag" in table else ["default"] * len(chans))
        for chan, tag in sorted(set(zip(chans, tags))):
            self._load_template(chan, template_tag=tag)

    def _load_template(self, chan, template_tag="default"):
        key = (chan, template_tag)
        if key not in self._templates:
            tmpl, _, md = self._filter_data.get_template(
                chan, tag=template_tag, return_metadata=True)
            self._templates[key] = np.asarray(tmpl)
            self._pretriggers[key] = int(
                md.get("nb_pretrigger_samples",
                       np.asarray(tmpl).shape[-1] // 2))

    def _template_for(self, chan, tag="default"):
        key = (chan, tag)
        if key not in self._templates:
            self._load_template(chan, template_tag=tag)
        return self._templates[key], self._pretriggers[key]

    # -- generation (JAX :239) ---------------------------------------------
    def generate_salt(self, raw_files=None, channels: Sequence[str] = (),
                      energies=None, dm_pdf: Optional[tuple] = None,
                      pdf_file: Optional[str] = None,
                      pdf_xrange_kev: tuple = (1e-5, 1.0),
                      nsalt: int = 100,
                      energy_norm_ev_per_amp: float | dict | None = None,
                      dpdi_poles: int = 2, dpdi_tag: str = "default",
                      channel_fractions: Optional[dict] = None,
                      template_tag: str = "default",
                      min_separation_msec: float = 100.0,
                      edge_exclusion_msec: float = 50.0,
                      coincident: bool = True,
                      seed: Optional[int] = None) -> dict:
        """The salting table over the continuous exposure ``raw_files`` (a
        ``RawIndex`` or pytesdaq paths): ``energies`` (each repeated
        ``nsalt`` times), ``dm_pdf`` (energies_eV, dRdE) or ``pdf_file``
        sampled ``nsalt`` times (a mass), or the kept ``sample_DMpdf``
        draws; each salt's energy split over ``channels`` by
        ``channel_fractions`` (default equal), at one time for all
        channels (``coincident``) or one a channel. Amplitudes are the
        channel's energy over ``energy_norm_ev_per_amp`` (eV per unit
        template amplitude, one value or one a channel), or over the
        energy normalization of the filter data's dPdI, interpolated onto
        the template's frequency axis where the grids differ."""
        if raw_files is None:
            raw_files = self._raw_files_from_store()
        if not channels:
            raise ValueError("channels required")
        rng = np.random.default_rng(seed)
        for chan in channels:
            self._load_template(chan, template_tag)

        salt_masses = None
        if pdf_file is not None:
            if energies is not None:
                raise ValueError(
                    "pass either energies or a DM PDF file, not both")
            dists = load_dm_pdf_file(pdf_file)
            salt_energies, salt_masses = [], []
            for mass, data in dists.items():
                e = sample_pdf_function(data["dmrate"], pdf_xrange_kev,
                                        nsalt, rng) * 1e3
                salt_energies.extend(e)
                salt_masses.extend([mass] * nsalt)
            salt_energies = np.asarray(salt_energies)
            salt_masses = np.asarray(salt_masses)
        elif dm_pdf is not None:
            salt_energies = sample_from_pdf(dm_pdf[0], dm_pdf[1], nsalt, rng)
        elif energies is not None:
            salt_energies = np.repeat(np.atleast_1d(energies), nsalt)
        elif len(self._dm_energies):
            salt_energies = np.asarray(self._dm_energies)
        else:
            raise ValueError('"energies", "dm_pdf" or "pdf_file" required')
        ntot = len(salt_energies)

        # random times across the exposure; non-coincident salts draw one
        # time a channel. The table is made on the host: no trace is read.
        nchan = len(channels)
        ntimes = ntot if coincident else ntot * nchan
        times = Randoms(raw_files, verbose=False, device="cpu").process(
            nrandoms=ntimes, min_separation_msec=min_separation_msec,
            edge_exclusion_msec=edge_exclusion_msec, seed=seed,
            lgc_output=True)
        ntimes_got = len(times["trigger_index"])
        if ntimes_got < ntimes:
            ntot = ntimes_got if coincident else ntimes_got // nchan
            salt_energies = salt_energies[:ntot]

        fractions = channel_fractions or {c: 1.0 / nchan for c in channels}
        norms = np.array([self._energy_norm(chan, energy_norm_ev_per_amp,
                                            dpdi_poles, dpdi_tag,
                                            template_tag)
                          for chan in channels])
        salt = np.repeat(np.arange(ntot), nchan)
        ci = np.tile(np.arange(nchan), ntot)
        trow = salt if coincident else salt * nchan + ci
        e_chan = salt_energies[salt] * np.array(
            [fractions.get(c, 0.0) for c in channels], np.float64)[ci]
        n = len(salt)
        table = {"salt_id": salt.astype(np.int64) + 1}
        if salt_masses is not None:
            table["salt_dm_mass_mev"] = salt_masses[salt]
        table.update({
            "salt_channel": np.asarray(list(channels), dtype=object)[ci],
            "salt_energy_ev": e_chan,
            "salt_amplitude": e_chan / norms[ci],
            "salt_template_tag": np.full(n, template_tag, dtype=object),
            "trigger_index": times["trigger_index"][trow].astype(np.int64),
            "trigger_time": times["trigger_time"][trow],
            "series_number": times["series_number"][trow],
            "event_number": times["event_number"][trow],
            "dump_number": times["dump_number"][trow],
            "trigger_type": np.full(n, 6, np.int64),
        })
        self._set_table(table)
        return table

    def _energy_norm(self, chan, energy_norm_ev_per_amp, dpdi_poles,
                     dpdi_tag, template_tag) -> float:
        """eV per unit template amplitude of ``chan``."""
        if isinstance(energy_norm_ev_per_amp, dict):
            return float(energy_norm_ev_per_amp[chan])
        if energy_norm_ev_per_amp is not None:
            return float(energy_norm_ev_per_amp)
        try:
            dpdi, dpdi_freqs = self._filter_data.get_dpdi(
                chan, dpdi_poles, tag=dpdi_tag)
        except KeyError:
            raise ValueError(
                f"no energy_norm_ev_per_amp given and no "
                f"dpdi_{dpdi_poles}poles_{dpdi_tag} in the filter data for "
                f"channel {chan}") from None
        tmpl, _ = self._template_for(chan, template_tag)
        _, _, tmd = self._filter_data.get_template(
            chan, tag=template_tag, return_metadata=True)
        fs = float(tmd.get("sample_rate", 1.25e6))
        # the dPdI may be tabulated on any frequency grid; the
        # normalization multiplies fft(template)·dPdI bin by bin, so it is
        # interpolated onto the template's two-sided axis where they differ
        dpdi = np.asarray(dpdi)
        freqs_t = np.fft.fftfreq(tmpl.shape[-1], d=1.0 / fs)
        dpdi_freqs = (np.asarray(dpdi_freqs) if dpdi_freqs is not None
                      else None)
        if (dpdi_freqs is None or len(dpdi) != len(freqs_t)
                or not np.allclose(dpdi_freqs, freqs_t)):
            if dpdi_freqs is None:
                raise ValueError(
                    f"dPdI for {chan} has no frequency axis and does not "
                    f"match the template length")
            order = np.argsort(dpdi_freqs)
            dpdi = (np.interp(freqs_t, dpdi_freqs[order], dpdi.real[order])
                    + 1j * np.interp(freqs_t, dpdi_freqs[order],
                                     dpdi.imag[order]))
        joules = didv.energy_normalization(tmpl, dpdi, fs)
        return abs(joules) * EV_PER_JOULE

    # -- injection (JAX :401-465) ------------------------------------------
    def inject_raw_salt(self, traces: np.ndarray, admin: dict,
                        channel_list: Sequence[str], window_start: int = 0,
                        channels: Optional[Sequence[str]] = None
                        ) -> np.ndarray:
        """An event's traces [C, N] with its salts (matched by (series,
        event)) on the channels of ``channel_list`` added, clipped to the
        trace; ``channels`` names the rows (default: ``channel_list``),
        ``window_start`` is the first sample of a windowed read."""
        rows = self._by_event.get((int(admin["series_number"]),
                                   int(admin["event_number"])))
        if rows is None:
            return traces
        t = self._table
        names = list(channel_list if channels is None else channels)
        wanted = set(channel_list)
        out = np.array(traces, copy=True)
        nb = out.shape[-1]
        tags = t.get("salt_template_tag")
        for r in rows:
            chan = str(t["salt_channel"][r])
            if chan not in wanted or chan not in names:
                continue
            tmpl, pre = self._template_for(
                chan, "default" if tags is None else str(tags[r]))
            start = int(t["trigger_index"][r]) - pre - int(window_start)
            lo = max(start, 0)
            hi = min(start + tmpl.shape[-1], nb)
            if hi <= lo:
                continue
            out[names.index(chan), lo:hi] += (t["salt_amplitude"][r]
                                              * tmpl[lo - start:hi - start])
        return out

    def make_injector(self, channel_list: Sequence[str]):
        """The host injector for the shells' ``set_salting``: a callable
        ``(traces [C, N], admin, window_start=0, channels=None)`` that
        returns the traces with the salts on ``channel_list`` added
        (:meth:`inject_raw_salt`); ``channels`` names the rows of
        ``traces`` (default: ``channel_list``), and the shells pass the
        channels they read. Every template of the table is loaded here,
        so the reader threads that call it build nothing."""
        channel_list = list(channel_list)
        self._load_table_templates()

        def injector(traces, admin, window_start=0, channels=None):
            return self.inject_raw_salt(traces, admin, channel_list,
                                        window_start=window_start,
                                        channels=channels)
        return injector

    def make_device_injector(self, channel_list: Sequence[str],
                             max_salts_per_event: int = 16
                             ) -> DeviceInjector:
        """The device injector for the shells' ``set_salting``: the host
        plans [E, K] arrays a batch and the templates are added on the
        card after the ADC conversion, so the int16 upload is kept."""
        if self._table is None or not len(self._table["salt_channel"]):
            raise ValueError("no salting table — generate_salt or "
                             "set_dataframe first")
        return DeviceInjector(self._table, self._template_for, channel_list,
                              max_salts_per_event=max_salts_per_event)

    def save(self, output_path: str, group_name: str = "salting",
             series_name: Optional[str] = None, facility: int = 1,
             output_format: str = "hdf5") -> str:
        """Write the table as ``salting_{group}_{series}_F0001`` (HDF5 in
        vaex's layout through h5py, or parquet); returns the path."""
        os.makedirs(output_path, exist_ok=True)
        out_series = series_name or create_series_name(facility)
        path = tables.output_file_name(
            output_path, "salting", group_name, out_series, 1,
            tables.table_ext(output_format))
        tables.write_table(self._table, path, fmt=output_format)
        return path


def salt_efficiency(salt_table, trigger_table, match_window_samples: int = 20,
                    energy_bins=None) -> dict:
    """Trigger efficiency against injected energy.

    A salt is recovered when the trigger table holds a row of the same
    (series, event) within ``match_window_samples`` of its index. Returns
    one row a bin of ``energy_bins`` (default: 8 equal bins over the
    energies): ``energy_lo_ev, energy_hi_ev, energy_mean_ev, n_injected,
    n_recovered, efficiency, efficiency_err`` (binomial). A ``recovered``
    column is added to ``salt_table`` (a dict or a DataFrame) in place."""
    salts = _as_table(salt_table)
    trig = _as_table(trigger_table) if trigger_table is not None else {}
    if not len(salts.get("trigger_index", ())):
        raise ValueError("empty salting dataframe")
    w = int(match_window_samples)
    s_ti = salts["trigger_index"].astype(np.int64)
    recovered = np.zeros(len(s_ti), dtype=bool)
    if len(trig.get("trigger_index", ())):
        t_ti = trig["trigger_index"].astype(np.int64)
        keys = np.concatenate([
            np.stack([salts["series_number"], salts["event_number"]], 1),
            np.stack([trig["series_number"], trig["event_number"]], 1),
        ]).astype(np.int64)
        _, group = np.unique(keys, axis=0, return_inverse=True)
        group = group.reshape(-1).astype(np.int64)
        g_s, g_t = group[:len(s_ti)], group[len(s_ti):]
        # one sorted key a trigger: its (series, event) group, then index
        lo = min(int(s_ti.min()) - w, int(t_ti.min()))
        stride = max(int(s_ti.max()) + w, int(t_ti.max())) - lo + 1
        key_t = np.sort(g_t * stride + (t_ti - lo))
        first = np.searchsorted(key_t, g_s * stride + (s_ti - w - lo))
        last = g_s * stride + (s_ti + w - lo)
        recovered = (first < len(key_t)) & (
            key_t[np.minimum(first, len(key_t) - 1)] <= last)
    salt_table["recovered"] = recovered

    e = salts["salt_energy_ev"].astype(np.float64)
    if energy_bins is None:
        elo, ehi = float(e.min()), float(e.max())
        if elo == ehi:
            energy_bins = np.array([elo * 0.999, ehi * 1.001])
        else:
            energy_bins = np.linspace(elo, ehi * (1 + 1e-9), 9)
    energy_bins = np.asarray(energy_bins, dtype=float)
    cols = {k: [] for k in ("energy_lo_ev", "energy_hi_ev", "energy_mean_ev",
                            "n_injected", "n_recovered", "efficiency",
                            "efficiency_err")}
    for blo, bhi in zip(energy_bins[:-1], energy_bins[1:]):
        m = (e >= blo) & (e < bhi)
        n = int(m.sum())
        k = int(recovered[m].sum())
        eff = k / n if n else np.nan
        err = (np.sqrt(eff * (1 - eff) / n) if n and 0 <= eff <= 1
               else np.nan)
        for key, val in zip(cols, (blo, bhi, float(e[m].mean()) if n
                                   else np.nan, n, k, eff, err)):
            cols[key].append(val)
    return {k: np.asarray(v, np.int64 if k.startswith("n_") else np.float64)
            for k, v in cols.items()}
