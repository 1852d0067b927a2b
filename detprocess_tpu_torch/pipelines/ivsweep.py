"""IV/dIdV sweep processing and analysis.

Port of ``detprocess_tpu/pipelines/ivsweep.py``, the replacement of the
reference IVSweepProcessing (process/ivprocess.py) and IVSweepAnalysis
(core/ivsweep.py):

- :func:`discover_bias_points` (:32) maps a raw group's noise and dIdV
  series to bias points by their ``tes_bias`` (a flat series' manifest,
  or the h5py adapter).
- :class:`IVSweepProcessing` (:77) runs each bias point's trace work on
  ``device`` (``device=None`` means the GPU, ``device.require_cuda``):
  the point's noise traces of one channel go up once as stored (int16
  codes for pytesdaq data) and are converted there in float64; the noise
  cuts (``ops/autocuts``), the offset and its error and the average trace
  are float64 reductions there; the PSD of the kept traces is
  ``ops/spectral.welch_psd`` in the run's dtype, float32 on the GPU, so
  that its spectra come from the hand-written rFFT kernel (one launch a
  point); the dIdV traces go through ``ops/lockin`` in float64. The state
  tags (:159) follow by linearity of the offsets against |bias|.
- :class:`IVSweepAnalysis` (:182) is host work: the IBIS analysis
  (``models/ivbias``), the state-aware 1/2/3-pole dIdV fits with the
  small-signal parameters and the Rp/Rn cross-check, the noise model of
  the sweep (``pipelines/noisemodel``) and σ_E against bias. The fits run
  on the CPU in float64 (``models/didv``), as the JAX package pins them
  there; the fits of one pole count over all fitted points and their
  starting guesses are one batched LM call, each point's fit the one the
  JAX loop gives.

The sweep tables are the port's :class:`~detprocess_tpu_torch.io.
filterdata.Table` with the JAX DataFrames' columns in their order: a
scalar column a numpy array (NaN where a row lacks it), an array- or
dict-valued column a list (None where missing). Where pandas sorts by
|tes_bias| (``analyze_sweep``, :452-453) the port sorts stably, so rows of
equal |bias| keep their order (pandas promises no order for such ties).
``plot_didv_summary`` imports matplotlib when it is called; ``jaxcache``
is a TPU matter and is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from detprocess_tpu_torch import device as dev
from detprocess_tpu_torch.io.filterdata import (FilterData, Table, as_table,
                                                 records_table)
from detprocess_tpu_torch.io.upload import channel_to_device, read_channel
from detprocess_tpu_torch.models import didv as didv_models
from detprocess_tpu_torch.models import ivbias
from detprocess_tpu_torch.ops import autocuts as cuts
from detprocess_tpu_torch.ops import lockin, spectral
from detprocess_tpu_torch.pipelines.didv import raw_index, stage
from detprocess_tpu_torch.pipelines.noise import torch_dtype
from detprocess_tpu_torch.utils.misc import find_linear_segment


def discover_bias_points(raw_path: str, channel: str,
                         series: Optional[Sequence[str]] = None,
                         bias_tolerance_percent: float = 1.0) -> List[dict]:
    """The bias points of an IV/dIdV sweep's raw group: series are noise
    ("iv", "noise") or dIdV by their file prefix, each series' ``tes_bias``
    comes from its detector config, and series within
    ``bias_tolerance_percent`` of a point's bias join it. Ordered by
    |bias|, largest (normal branch) first; the input of
    :meth:`IVSweepProcessing.process`."""
    from detprocess_tpu_torch.io.rawdata import RawData, RawIndex

    points: dict = {}

    def scan(data_type, key):
        rd = RawData(raw_path, data_type=data_type, series=series)
        for _, files in rd.get_data_files().items():
            if not files:
                continue
            det = RawIndex.from_files(files).get_detector_config()
            cfg = det.get(channel, {})
            if "tes_bias" not in cfg:
                continue
            bias = float(cfg["tes_bias"])
            tol = abs(bias) * bias_tolerance_percent / 100.0 + 1e-15
            for b in points:
                if abs(b - bias) <= tol:
                    bias = b
                    break
            entry = points.setdefault(bias, {"tes_bias": bias,
                                             "noise_files": [],
                                             "didv_files": []})
            entry[key].extend(files)

    scan("iv", "noise_files")
    scan("noise", "noise_files")
    scan("didv", "didv_files")
    return [points[b] for b in sorted(points, key=abs, reverse=True)]


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

def table_len(table: Table) -> int:
    return len(next(iter(table.values()))) if table else 0


def table_rows(table: Table, rows) -> Table:
    """The rows ``rows`` (indices, in that order) of ``table``."""
    rows = [int(r) for r in rows]
    return Table({k: ([v[r] for r in rows] if isinstance(v, list)
                      else np.asarray(v)[rows]) for k, v in table.items()})


def table_copy(table: Table) -> Table:
    return Table({k: list(v) if isinstance(v, list) else np.array(v)
                  for k, v in table.items()})


def row_of(table: Table, i: int) -> dict:
    return {k: v[i] for k, v in table.items()}


def set_cell(table: Table, column: str, i: int, value):
    """``df.loc[i, column] = value`` for a float cell: a new column is
    appended, NaN but in row ``i``."""
    if column not in table:
        table[column] = np.full(table_len(table), np.nan)
    table[column][i] = value


def state_of(table: Table) -> np.ndarray:
    """The ``state`` column as str (NaN or None as '')."""
    return np.array([s if isinstance(s, str) else ""
                     for s in table["state"]])


# ---------------------------------------------------------------------------
# processing
# ---------------------------------------------------------------------------

class IVSweepProcessing(FilterData):
    """Raw sweep processing: per bias point, the noise PSD and DC offset
    and the lock-in dIdV, then the state tags. The caller gives each
    point's files (:func:`discover_bias_points` finds them)."""

    def __init__(self, verbose: bool = True, device=None):
        super().__init__(verbose=verbose)
        self._device = (dev.require_cuda() if device is None
                        else torch.device(device))

    def process(self, channel: str, bias_points: Sequence[dict],
                sgfreq: Optional[float] = None,
                sgamp: Optional[float] = None, rsh: float = 5e-3,
                nsigma_cut: float = 2.5, tag: str = "default",
                timer=None) -> Table:
        """Process a sweep of one channel. ``bias_points``: dicts with
        ``tes_bias`` [A] and ``noise_files`` and/or ``didv_files``
        (pytesdaq paths or an ``io/rawdata.RawIndex``). Returns and stores
        the bias points' table (``ivsweep_data_{tag}``). ``timer``: a
        ``utils.logging.StageTimer`` for the host seconds of the reads
        ("read") and of the device work up to its results on the host
        ("device")."""
        pin = self._device.type == "cuda"
        psd_dtype = torch_dtype(None, self._device)
        rows: List[dict] = []
        for bp in bias_points:
            row: dict = {"tes_bias": bp["tes_bias"]}
            if bp.get("noise_files"):
                index = raw_index(bp["noise_files"])
                fs = index.sample_rate
                with stage(timer, "read"):
                    host, conv = read_channel(index, channel, pin=pin)
                with stage(timer, "device"):
                    tr = channel_to_device(host, conv, self._device)
                    mask = cuts.autocuts_noise(tr, nsigma=nsigma_cut)
                    if not bool(mask.any()):
                        raise ValueError(
                            f"autocuts rejected all {len(mask)} noise "
                            f"traces at tes_bias={bp.get('tes_bias')} — a "
                            "NaN PSD/offset would poison the whole sweep; "
                            "loosen nsigma_cut or inspect the data")
                    kept = tr[mask]
                    psd = spectral.welch_psd(kept.to(psd_dtype), fs)
                    nkept = kept.shape[0]
                    row["psd"] = psd.double().cpu().numpy()
                    row["offset_noise"] = float(kept.mean())
                    row["offset_noise_err"] = float(
                        kept.mean(dim=-1).std(correction=0)
                        / np.sqrt(max(nkept, 1)))
                    row["fs"] = fs
                    row["avgtrace_noise"] = kept.mean(dim=0).cpu().numpy()
                del tr, kept
            if bp.get("didv_files"):
                if sgfreq is None or sgamp is None:
                    raise ValueError("sgfreq/sgamp required for dIdV data")
                index = raw_index(bp["didv_files"])
                fs = index.sample_rate
                with stage(timer, "read"):
                    host, conv = read_channel(index, channel, pin=pin)
                with stage(timer, "device"):
                    data = lockin.process_didv_traces(
                        channel_to_device(host, conv, self._device), fs,
                        sgfreq, sgamp, rsh, nsigma_cut=nsigma_cut)
                row["didv_freqs"] = data.freqs
                row["didv"] = data.didv
                row["didv_weights"] = data.weights
                row["offset_didv"] = data.offset
                row["offset_didv_err"] = data.offset_err
                row["sgfreq"] = sgfreq
                row["sgamp"] = sgamp
                row["fs"] = fs
            rows.append(row)

        table = self._tag_states(rows)
        self._set(channel, f"ivsweep_data_{tag}", table,
                  {"rsh": rsh, "channel": channel})
        return table

    @staticmethod
    def _tag_states(rows: List[dict]) -> Table:
        """The rows as a table with a ``state`` column: the linear segment
        of the offsets against |bias| from the largest bias is "normal",
        from the smallest "sc", the rest "transition"."""
        bias = np.array([r["tes_bias"] for r in rows])
        offs = np.array([r.get("offset_noise", r.get("offset_didv", np.nan))
                         for r in rows])
        order = np.argsort(-np.abs(bias))   # normal branch first
        state = np.array(["transition"] * len(rows), dtype=object)
        x, y = np.abs(bias[order]), offs[order]
        for idx in find_linear_segment(x, y):
            state[order[idx]] = "normal"
        for idx in find_linear_segment(x[::-1], y[::-1]):
            state[order[::-1][idx]] = "sc"
        return records_table([{**r, "state": s}
                              for r, s in zip(rows, state)])


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

class IVSweepAnalysis(FilterData):
    """Sweep analysis: IBIS, state-aware dIdV fits, the noise model and
    the energy resolution against bias, on the CPU in float64."""

    def __init__(self, verbose: bool = True):
        super().__init__(verbose=verbose)
        self._sweep_df: Dict[str, Table] = {}
        self._ibis: Dict[str, ivbias.IBISResult] = {}
        self._rsh: Dict[str, float] = {}
        self._rsh_err: Dict[str, float] = {}
        self._rp_user: Dict[str, float] = {}
        self._rp_user_err: Dict[str, float] = {}
        self._nnorm: Dict[str, int] = {}
        self._nsc: Dict[str, int] = {}
        self._tbath: Optional[float] = None
        self._tload_guess: Optional[float] = None
        self._tc: Dict[str, float] = {}
        self._gta: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def set_data_from_dataframe(self, channel: str, df, rsh: float = 5e-3):
        """The sweep table of ``channel`` (a Table, a dict of columns or a
        DataFrame)."""
        self._sweep_df[channel] = table_copy(as_table(df))
        self._rsh[channel] = rsh

    def set_data_from_processing(self, channel: str,
                                 proc: IVSweepProcessing,
                                 tag: str = "default", rsh: float = 5e-3):
        self.set_data_from_dataframe(
            channel, proc._get(channel, f"ivsweep_data_{tag}")[0], rsh)

    def set_data_from_file(self, file_name: str, channel: str = None,
                           tag: str = "default", rsh: float = 5e-3):
        """The sweep tables of an IV-sweep or filter file (.npz, or HDF5
        through h5py), with each table's stored Rshunt."""
        fd = FilterData(verbose=False).load(file_name)
        name = f"ivsweep_data_{tag}"
        channels = ([channel] if channel
                    else [c for c in fd.data if name in fd.data[c]])
        if not channels:
            raise ValueError(f"no ivsweep_data_{tag} found in {file_name}")
        for chan in channels:
            table, _, md = fd._get(chan, name)
            self.set_data_from_dataframe(chan, table,
                                         rsh=float((md or {}).get("rsh",
                                                                  rsh)))
        return self

    def set_nb_sc_normal_points(self, channel: str, nnorm: int, nsc: int):
        """Override the state counts of the tags."""
        self._nnorm[channel] = nnorm
        self._nsc[channel] = nsc

    def set_data_from_dict(self, data_dict: dict, rsh: float = 5e-3):
        """Sweep tables from {channel: table}."""
        for chan, df in data_dict.items():
            self.set_data_from_dataframe(chan, df, rsh=rsh)
        return self

    def clear(self, channels=None):
        """Drop the analysis state (and the stored filter data) of some or
        all channels."""
        stores = (self._sweep_df, self._ibis, self._nnorm, self._nsc)
        if channels is None:
            for store in stores:
                store.clear()
        else:
            for chan in [channels] if isinstance(channels, str) else channels:
                for store in stores:
                    store.pop(chan, None)
        self.clear_data(channels)

    @staticmethod
    def _broadcast_per_channel(channels, name, val):
        """A scalar applies to every channel; a list must match them."""
        if val is None:
            return [None] * len(channels)
        if isinstance(val, (int, float)):
            val = [val]
        if len(val) == 1:
            val = list(val) * len(channels)
        if len(val) != len(channels):
            raise ValueError(
                f'ERROR: "{name}" list should have length = # channels')
        return list(val)

    def set_rshunt(self, channels, rshunt=None, rshunt_err=None):
        """Rshunt (and its error) where the raw data lacks it."""
        if isinstance(channels, str):
            channels = [channels]
        rshunt = self._broadcast_per_channel(channels, "rshunt", rshunt)
        rshunt_err = self._broadcast_per_channel(channels, "rshunt_err",
                                                 rshunt_err)
        for chan, val, err in zip(channels, rshunt, rshunt_err):
            if val is not None:
                self._rsh[chan] = float(val)
            if err is not None:
                self._rsh_err[chan] = float(err)
        return self

    def set_rp(self, channels, rp=None, rp_err=None):
        """Rp for channels without SC points; ``analyze_sweep``'s
        default."""
        if isinstance(channels, str):
            channels = [channels]
        rp = self._broadcast_per_channel(channels, "rp", rp)
        rp_err = self._broadcast_per_channel(channels, "rp_err", rp_err)
        for chan, val, err in zip(channels, rp, rp_err):
            if val is not None:
                self._rp_user[chan] = float(val)
            if err is not None:
                self._rp_user_err[chan] = float(err)
        return self

    def set_tbath(self, tbath: float):
        self._tbath = float(tbath)

    def set_tload_guess(self, tload: float):
        self._tload_guess = float(tload)

    def set_tc(self, channel: str, tc: float):
        self._tc[channel] = float(tc)

    def set_gta(self, channel: str, gta: float):
        self._gta[channel] = float(gta)

    # -- result accessors ----------------------------------------------
    def get_didv_objects(self, channel: str):
        """{tes_bias: fit dict} of every dIdV-fitted point."""
        df = self._sweep_df.get(channel)
        if df is None or "didv_fits" not in df:
            return None
        out = {float(b): fits for b, fits in zip(df["tes_bias"],
                                                 df["didv_fits"])
               if isinstance(fits, dict) and fits}
        return out or None

    def get_ibis_qetpy_object(self, channel: str):
        """The :class:`~detprocess_tpu_torch.models.ivbias.IBISResult` that
        stands for qetpy's IBIS object."""
        return self._ibis.get(channel)

    def get_didv_summary(self, channel: str, tag: str = "default"):
        """The stored "didv" results of the state-aware fits, or None."""
        try:
            return self.get_ivsweep_results(channel, "didv", tag=tag)
        except (KeyError, ValueError):
            return None

    def get_resolution_data(self, channel: str):
        """{tes_bias: σ_E} of calc_energy_resolution, or None."""
        df = self._sweep_df.get(channel)
        if df is None or "energy_resolution" not in df:
            return None
        out = {float(b): float(s)
               for b, s in zip(df["tes_bias"], df["energy_resolution"])
               if np.isfinite(s)}
        return out or None

    # -- state-filtered fit drivers --------------------------------------
    def fit_didv_sc(self, channels=None, percent_rn_max: float = 0.05,
                    nb_points_max: int = 4, tag: str = "default",
                    **kwargs):
        """1-pole fits of the SC points only (the Rp cross-check)."""
        for chan in self._fit_channels(channels):
            self.analyze_didv(chan, tag=tag, enable_normal=False,
                              enable_transition=False,
                              sc_percent_rn_max=percent_rn_max,
                              nb_points_sc_max=nb_points_max, **kwargs)
        return self

    def fit_didv_normal(self, channels=None, percent_rn_min: float = 99.8,
                        nb_points_max: int = 4, tag: str = "default",
                        **kwargs):
        """1-pole fits of the normal points only (the Rn cross-check)."""
        for chan in self._fit_channels(channels):
            self.analyze_didv(chan, tag=tag, enable_sc=False,
                              enable_transition=False,
                              normal_percent_rn_min=percent_rn_min,
                              nb_points_normal_max=nb_points_max, **kwargs)
        return self

    def fit_didv_transition(self, channels=None,
                            percent_rn_min: float = 5.0,
                            percent_rn_max: float = 70.0,
                            poles=(2, 3), tag: str = "default", **kwargs):
        """2/3-pole fits and small-signal parameters of the transition
        points."""
        for chan in self._fit_channels(channels):
            self.analyze_didv(chan, poles=poles, tag=tag,
                              enable_sc=False, enable_normal=False,
                              transition_percent_rn_min=percent_rn_min,
                              transition_percent_rn_max=percent_rn_max,
                              **kwargs)
        return self

    def _fit_channels(self, channels):
        if channels is None:
            return list(self._sweep_df.keys())
        return [channels] if isinstance(channels, str) else list(channels)

    # ------------------------------------------------------------------
    def plot_didv_summary(self, channel: str, poles: int = 3,
                          save_path: Optional[str] = None):
        """The small-signal parameters l, β and τ0 of the ``poles`` fits
        against % Rn (or bias) over the sweep's points, one panel each;
        None, with a message, before ``analyze_didv``."""
        import matplotlib.pyplot as plt

        df = self._sweep_df[channel]
        cols = [f"didv_{poles}poles_{k}" for k in ("l", "beta", "tau0")]
        have = [c for c in cols if c in df]
        if not have:
            print(f"ERROR: No dIdV analysis done for {channel}")
            return None
        fig, axes = plt.subplots(len(have), 1, sharex=True,
                                 figsize=(6, 2.2 * len(have)))
        if len(have) == 1:
            axes = [axes]
        x = df.get("percent_rn", df["tes_bias"])
        for ax, col in zip(axes, have):
            ax.errorbar(x, df[col], yerr=df.get(col + "_err"), fmt="o",
                        ms=4)
            ax.set_ylabel(col.split("_")[-1])
            ax.grid(alpha=0.3)
        axes[-1].set_xlabel("percent Rn" if "percent_rn" in df
                            else "TES bias [A]")
        fig.suptitle(f"{channel} {poles}-pole dIdV summary")
        fig.tight_layout()
        if save_path:
            fig.savefig(save_path, dpi=120)
        return fig

    def analyze_sweep(self, channel: str, offset_key: str = "offset_noise",
                      rp: Optional[float] = None,
                      tag: str = "default") -> Table:
        """The IBIS bias analysis over the sweep: rows sorted by |bias|
        (largest first), rows without a finite offset dropped, and i0, r0,
        p0 with errors and percent_rn added."""
        if rp is None:
            rp = self._rp_user.get(channel)
        df = self._sweep_df[channel]
        df = table_rows(df, np.argsort(-np.abs(np.asarray(
            df["tes_bias"], dtype=float)), kind="stable"))
        finite = np.isfinite(np.asarray(df[offset_key], dtype=float))
        if not finite.all():
            if self._verbose:
                print(f"INFO: dropping {int((~finite).sum())} bias points "
                      f"without {offset_key} from the IBIS analysis")
            df = table_rows(df, np.flatnonzero(finite))
        if table_len(df) < 3:
            raise ValueError(
                f"only {table_len(df)} bias points with finite "
                f"{offset_key}")
        ibias = np.asarray(df["tes_bias"], dtype=float)
        imeas = np.asarray(df[offset_key], dtype=float)
        err_key = offset_key + "_err"
        imeas_err = (np.asarray(df[err_key], dtype=float)
                     if err_key in df else None)

        states = state_of(df) if "state" in df else None
        nnorm = self._nnorm.get(channel, int((states == "normal").sum())
                                if states is not None else 3)
        nsc = self._nsc.get(channel, int((states == "sc").sum())
                            if states is not None else 3)
        nnorm = max(nnorm, 2)
        nsc = max(nsc, 0)

        res = ivbias.analyze_ibis(ibias, imeas, self._rsh[channel],
                                  nnorm=nnorm, nsc=nsc,
                                  imeas_err=imeas_err, rp=rp)
        self._ibis[channel] = res
        for key in ("i0", "i0_err", "r0", "r0_err", "p0", "p0_err"):
            df[key] = np.asarray(getattr(res, key), dtype=float)
        df["percent_rn"] = res.r0 / res.rn * 100.0
        self._sweep_df[channel] = df
        results = {
            "rn": res.rn, "rn_err": res.rn_err,
            "rp": res.rp, "rp_err": res.rp_err,
            "ioffset": res.ioffset, "ioffset_err": res.ioffset_err,
            "rshunt": self._rsh[channel],
            "nnorm": nnorm, "nsc": nsc,
        }
        self.set_ivsweep_results(channel, results, "noise", tag=tag)
        self.set_ivsweep_data(channel, df, tag=tag)
        return df

    def get_ibis(self, channel: str) -> ivbias.IBISResult:
        return self._ibis[channel]

    # ------------------------------------------------------------------
    def analyze_didv(self, channel: str, poles=(2, 3),
                     tag: str = "default",
                     enable_sc: bool = True,
                     enable_normal: bool = True,
                     enable_transition: bool = True,
                     nb_points_sc_max: int = 4,
                     nb_points_normal_max: int = 4,
                     sc_percent_rn_max: float = 0.05,
                     normal_percent_rn_min: float = 99.8,
                     transition_percent_rn_min: float = 5.0,
                     transition_percent_rn_max: float = 70.0) -> Table:
        """State-aware dIdV fits across the sweep (reference
        core/ivsweep.py:762-826, dispatch :1600-1799):

        - **SC points**, 1 pole: the TES is a short, so dVdI(0) = A =
          Rsh + Rp and Rp = A − Rsh; the smallest-|bias| points, up to
          ``nb_points_sc_max``; the summary holds their mean and spread
          and the median inductance;
        - **normal points**, 1 pole: A = Rsh + Rp + Rn, so
          Rn = A − Rsh − Rp_IV; the largest-|bias| points, up to
          ``nb_points_normal_max``;
        - **transition points**, 2/3 poles within the percent-Rn window:
          small-signal parameters with covariance errors, the
          infinite-loop-gain bias point, and ``didv_{p}poles_*`` columns.

        The dIdV Rp and Rn are held against the IBIS values: beyond 3σ
        (combined) and 10 % they print a WARNING. The results are stored
        as the ``ivsweep_results`` "didv" entry (``sc_didv_fit_rp``,
        ``normal_didv_fit_rn``, ``{sc,normal}_didv_fit_L``)."""
        df = self._sweep_df[channel]
        if "didv" not in df:
            raise ValueError("no dIdV data in the sweep dataframe")
        rsh = self._rsh[channel]
        ibis = self._ibis.get(channel)
        rp_iv = ibis.rp if ibis is not None else 0.0
        n = table_len(df)

        def _state(row):
            if isinstance(row.get("state"), str):
                return row["state"]
            # percent_rn thresholds when there are no linearity tags
            prn = row.get("percent_rn", np.nan)
            if np.isfinite(prn):
                if prn < sc_percent_rn_max:
                    return "sc"
                if prn > normal_percent_rn_min:
                    return "normal"
            return "transition"

        idx_by_state = {"sc": [], "normal": [], "transition": []}
        for i in range(n):
            row = row_of(df, i)
            if isinstance(row.get("didv"), np.ndarray):
                idx_by_state[_state(row)].append(i)
        absb = np.abs(np.asarray(df["tes_bias"], dtype=float))
        sc_idx = sorted(idx_by_state["sc"],
                        key=lambda i: absb[i])[:nb_points_sc_max]
        norm_idx = sorted(idx_by_state["normal"], key=lambda i: absb[i],
                          reverse=True)[:nb_points_normal_max]
        trans_idx = []
        for i in sorted(idx_by_state["transition"], key=lambda i: absb[i],
                        reverse=True):
            prn = row_of(df, i).get("percent_rn", np.nan)
            if (np.isfinite(prn)
                    and not (transition_percent_rn_min <= prn
                             <= transition_percent_rn_max)):
                continue
            trans_idx.append(i)

        df = table_copy(df)
        # seed from earlier fits, so that the state-filtered drivers add
        # to one another instead of replacing each other's
        if "didv_fits" in df:
            fits_col = [dict(v) if isinstance(v, dict) else {}
                        for v in df["didv_fits"]]
        else:
            fits_col = [{} for _ in range(n)]
        poles_list = [poles] if isinstance(poles, int) else list(poles)
        try:
            results_didv = dict(self.get_ivsweep_results(
                channel, "didv", tag=tag) or {})
        except (KeyError, ValueError):
            results_didv = {}
        results_didv.update({"rshunt": rsh, "rp": rp_iv})
        if ibis is not None:
            results_didv.update({"rn": ibis.rn, "rn_err": ibis.rn_err,
                                 "rp_err": ibis.rp_err})

        def fit_points(indices, p):
            return didv_models.fit_didv_many(
                [(df["didv_freqs"][i], df["didv"][i],
                  df["didv_weights"][i] if "didv_weights" in df else None)
                 for i in indices], poles=p)

        # --- 1-pole SC / normal fits --------------------------------------
        for data_type, indices, enabled in (("sc", sc_idx, enable_sc),
                                            ("normal", norm_idx,
                                             enable_normal)):
            if not enabled or not indices:
                continue
            rpn_list, rpn_err_list, l_list = [], [], []
            for i, fit in zip(indices, fit_points(indices, 1)):
                fits_col[i]["fit_1poles"] = fit
                a = float(fit.params[0])
                a_err = float(np.sqrt(max(fit.cov[0, 0], 0.0)))
                rpn_list.append(a - rsh - (rp_iv if data_type == "normal"
                                           else 0.0))
                rpn_err_list.append(a_err)
                l_list.append(float(fit.params[0] * fit.params[1]))
                set_cell(df, "didv_1poles_rtot", i, a)
                set_cell(df, "didv_1poles_chi2", i, fit.cost)
            fit_val = float(np.mean(rpn_list))
            # the spread across points if several, else the fit error
            fit_err = (float(np.std(rpn_list)) if len(rpn_list) > 1
                       else rpn_err_list[0])
            fit_err = max(fit_err, float(np.mean(rpn_err_list)))
            name = "rp" if data_type == "sc" else "rn"
            results_didv[f"{data_type}_didv_fit_{name}"] = fit_val
            results_didv[f"{data_type}_didv_fit_{name}_err"] = fit_err
            results_didv[f"{data_type}_didv_fit_L"] = float(
                np.median(l_list))
            if ibis is not None:
                iv_val = ibis.rp if data_type == "sc" else ibis.rn
                iv_err = ibis.rp_err if data_type == "sc" else ibis.rn_err
                sigma = float(np.hypot(fit_err, iv_err))
                dev_ = abs(fit_val - iv_val)
                if (dev_ > 3 * sigma
                        and dev_ > 0.1 * max(abs(iv_val), 1e-12)):
                    print(f"WARNING: {channel} {name} from "
                          f"{data_type} dIdV fit = {fit_val*1e3:.3f} mOhms "
                          f"disagrees with IV sweep "
                          f"{iv_val*1e3:.3f} ± {iv_err*1e3:.3f} mOhms "
                          f"({dev_/max(sigma,1e-30):.1f}σ) — check Rshunt "
                          "or the SC/normal point selection")
                if self._verbose:
                    print(f"{channel} {name} from dIdV fit = "
                          f"{fit_val*1e3:.3f} ± {fit_err*1e3:.3f} mOhms; "
                          f"from IV sweep = {iv_val*1e3:.3f} ± "
                          f"{iv_err*1e3:.3f} mOhms")

        # --- 2/3-pole transition fits -------------------------------------
        if enable_transition and trans_idx:
            fits = {p: dict(zip(trans_idx, fit_points(trans_idx, p)))
                    for p in poles_list if p != 1}
            for i in trans_idx:
                row = row_of(df, i)
                for p in fits:
                    fit = fits[p][i]
                    fits_col[i][f"fit_{p}poles"] = fit
                    set_cell(df, f"didv_{p}poles_chi2", i, fit.cost)
                    if "r0" not in row or not np.isfinite(row.get("r0",
                                                                  np.nan)):
                        continue
                    ssp = didv_models.smallsignal_with_errors(
                        fit, row["r0"], rsh + rp_iv)
                    fits_col[i][f"ssp_{p}poles"] = ssp
                    for key in ("l", "beta", "tau0", "L"):
                        set_cell(df, f"didv_{p}poles_{key}", i, ssp[key])
                        set_cell(df, f"didv_{p}poles_{key}_err", i,
                                 ssp[f"{key}_err"])
                    if p == 3:
                        set_cell(df, "didv_3poles_gratio", i,
                                 ssp["gratio"])
                    ilg = didv_models.biasparams_ilg(
                        fit.params, rsh + rp_iv, rsh,
                        float(row["tes_bias"]), poles=p)
                    for key in ("r0", "i0", "p0"):
                        set_cell(df, f"didv_{p}poles_{key}_infinite_lgain",
                                 i, ilg[key])

        df["didv_fits"] = fits_col
        self._sweep_df[channel] = df
        self.set_ivsweep_results(channel, results_didv, "didv", tag=tag)
        self.set_ivsweep_data(channel, df, tag=tag)
        return df

    def analyze_noise(self, channel: str, tc: Optional[float] = None,
                      tbath: Optional[float] = None,
                      tload_guess: Optional[float] = None,
                      poles: int = 2) -> dict:
        """The noise model across the sweep: the SQUID noise averaged
        over the normal points, Tload from the SC points, then the
        Irwin–Hilton budget of each transition point from its dIdV
        small-signal parameters, bias point and measured PSD. Needs
        analyze_sweep and analyze_didv first. Returns {"squid_noise",
        "tload", "normal_fit", "budgets": {bias: budget}} and adds a
        ``noise_budget`` column."""
        from detprocess_tpu_torch.pipelines.noisemodel import NoiseModel

        tc = self._tc.get(channel) if tc is None else tc
        tbath = self._tbath if tbath is None else tbath
        if tload_guess is None:
            tload_guess = (self._tload_guess
                           if self._tload_guess is not None else 0.03)
        if tc is None or tbath is None:
            raise ValueError(
                f'tc/tbath required for channel {channel} — pass them or '
                'call set_tc/set_tbath first')

        df = self._sweep_df[channel]
        if "didv_fits" not in df:
            raise ValueError('run "analyze_didv" first')
        if "psd" not in df:
            raise ValueError(f"no PSD available for channel {channel} — "
                             "is it a dIdV-only sweep?")
        ibis = self._ibis[channel]
        rl = self._rsh[channel] + ibis.rp
        nm = NoiseModel(verbose=False)
        states = state_of(df)
        rows = [row_of(df, i) for i in range(table_len(df))]

        def freqs_of(row):
            return np.fft.fftfreq(len(row["psd"]), d=1.0 / row["fs"])

        def batched(state, fit):
            """fit(psds, freqs) of the rows of ``state`` with a PSD, one
            batch per frequency axis; (row, result) in row order."""
            picked = [r for r, st in zip(rows, states)
                      if st == state and isinstance(r.get("psd"), np.ndarray)]
            groups: dict = {}
            for k, r in enumerate(picked):
                groups.setdefault((len(r["psd"]), float(r["fs"])),
                                  []).append(k)
            out = [None] * len(picked)
            for members in groups.values():
                results = fit([picked[k]["psd"] for k in members],
                              freqs_of(picked[members[0]]))
                for k, res in zip(members, results):
                    out[k] = res
            return list(zip(picked, out))

        # normal points → SQUID noise (averaged over points)
        squid_list, normal_fit = [], None
        for row, normal_fit in batched("normal", lambda psds, f: (
                nm.fit_normal_noise_batch(channel, psds, f, ibis.rn, rl,
                                          tc))):
            squid_list.append(nm.calc_squid_noise(
                channel, row["psd"], freqs_of(row), ibis.rn, rl,
                normal_fit["L"], tc, tload_guess=tload_guess))
        squid = np.mean(squid_list, axis=0) if squid_list else None

        # SC points → Tload (of the last one)
        tload = tload_guess
        for _, tload in batched("sc", lambda psds, f: nm.fit_sc_noise_batch(
                channel, psds, f, rl,
                normal_fit["L"] if normal_fit else 4e-7,
                squiddc=(float(np.median(squid[f != 0]))
                         if squid is not None else None))):
            pass

        # transition points → full budget
        budgets, col = {}, []
        for row in rows:
            fits = row.get("didv_fits")
            if (row.get("state") != "transition"
                    or not isinstance(fits, dict)
                    or f"ssp_{poles}poles" not in fits
                    or not isinstance(row.get("psd"), np.ndarray)):
                col.append(None)
                continue
            ssp = fits[f"ssp_{poles}poles"]
            freqs = freqs_of(row)
            pos = freqs > 0
            budget = nm.analyze_noise(
                channel, freqs[pos],
                {"beta": ssp["beta"], "l": ssp["l"], "L": ssp["L"],
                 "tau0": ssp["tau0"]},
                {"r0": row["r0"], "i0": row["i0"],
                 "rshunt": self._rsh[channel], "rp": ibis.rp,
                 "p0": row["p0"]},
                tc, tbath, tload=tload,
                gta=self._gta.get(channel),
                squiddc=(float(np.median(squid[freqs != 0]))
                         if squid is not None else None),
                psd_measured=row["psd"][pos])
            budgets[float(row["tes_bias"])] = budget
            col.append(budget)
        df = Table(df)
        df["noise_budget"] = col
        self._sweep_df[channel] = df
        return {"squid_noise": squid, "tload": tload,
                "normal_fit": normal_fit, "budgets": budgets}

    def calc_energy_resolution(self, channel: str, template: np.ndarray,
                               fs: float, poles: int = 2) -> Table:
        """σ_E of each transition point from its dIdV fit and PSD, added
        as the ``energy_resolution`` column."""
        df = self._sweep_df[channel]
        sigmas = []
        freqs = np.fft.fftfreq(len(template), d=1.0 / fs)
        rl = self._rsh[channel] + (self._ibis[channel].rp
                                   if channel in self._ibis else 0.0)
        for i in range(table_len(df)):
            row = row_of(df, i)
            fits = row.get("didv_fits")
            if (not isinstance(fits, dict) or f"fit_{poles}poles" not in fits
                    or not isinstance(row.get("psd"), np.ndarray)
                    or row.get("state") != "transition"):
                sigmas.append(np.nan)
                continue
            dpdi, _ = didv_models.dpdi_with_uncertainties(
                fits[f"fit_{poles}poles"], freqs, row["i0"], row["r0"], rl)
            sigmas.append(didv_models.energy_resolution(
                template, row["psd"], dpdi, fs))
        df = Table(df)
        df["energy_resolution"] = np.asarray(sigmas, dtype=float)
        self._sweep_df[channel] = df
        return df
