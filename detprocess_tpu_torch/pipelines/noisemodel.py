"""TES noise modelling: the SQUID noise, the load temperature, and the
transition-state noise budget.

Port of ``detprocess_tpu/pipelines/noisemodel.py::NoiseModel`` (:66-527,
with ``make_decreasing`` :26 and ``flatten_psd`` :40), the replacement of
the reference NoiseModel (detprocess/core/noisemodel.py):

- ``calc_squid_noise``: the SQUID and electronics noise of the
  normal-state PSD less its predicted Johnson noise (:354-492);
- ``fit_sc_noise``: the load temperature from the superconducting-state
  PSD (:748-913), and ``fit_normal_noise`` the inductance, load
  temperature and SQUID level from the normal-state PSD (:493-747): LM
  fits (``ops/lm.levenberg_marquardt``) in log space;
- ``analyze_noise``: the Irwin–Hilton budget of a transition point
  (:979-1290) from its dIdV small-signal parameters and IV bias point
  (``models/tesnoise``).

Everything here runs on the CPU in float64, as the JAX package runs it:
host numpy for the closed forms, CPU torch for the two small fits. The
PSDs come in from the GPU path already reduced (``pipelines/ivsweep``).
``flatten_psd``'s Savitzky–Golay smoothing of order 1 is the numpy
:func:`savgol_order1` (a centred moving mean, the edges from a line
fitted to the first and last window), scipy's ``savgol_filter(..., 1,
mode="interp")``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from detprocess_tpu_torch.io.filterdata import FilterData
from detprocess_tpu_torch.models import tesnoise
from detprocess_tpu_torch.ops import lm


def savgol_order1(y: np.ndarray, window: int) -> np.ndarray:
    """scipy ``savgol_filter(y, window, 1, mode="interp")`` for an odd
    ``window`` ≤ len(y): the centred moving mean, and on the first and
    last ``window // 2`` samples the least-squares line of the first and
    last ``window`` samples."""
    y = np.asarray(y, float)
    n = len(y)
    if window % 2 != 1 or window > n:
        raise ValueError("window must be odd and no longer than the data")
    half = window // 2
    out = np.empty(n)
    out[half:n - half] = np.convolve(y, np.full(window, 1.0 / window),
                                     mode="valid")
    pos = np.arange(window)
    for edge, interp in ((slice(0, window), slice(0, half)),
                         (slice(n - window, n), slice(window - half,
                                                      window))):
        coef = np.polyfit(pos, y[edge], 1)
        out[edge][interp] = np.polyval(coef, pos[interp])
    return out


def make_decreasing(y: np.ndarray, x: Optional[np.ndarray] = None
                    ) -> np.ndarray:
    """Monotone-decreasing envelope: running minimum over increasing x
    (qetpy.utils.make_decreasing equivalent, used by the reference's PSD
    flattening, noisemodel.py:1319)."""
    y = np.asarray(y, float)
    if x is not None:
        order = np.argsort(np.asarray(x))
        out = np.empty_like(y)
        out[order] = np.minimum.accumulate(y[order])
        return out
    return np.minimum.accumulate(y)


def flatten_psd(f: np.ndarray, psd: np.ndarray) -> np.ndarray:
    """Smooth spikes out of a folded PSD before noise-model fits
    (noisemodel.py:1293-1321): short savgol window at the lowest 0.25%
    of bins, wide window above, then a monotone-decreasing envelope.
    Vibrational/EMI lines only ever push the PSD *up*, so the decreasing
    envelope tracks the continuum floor."""
    psd = np.asarray(psd, float)
    n = len(psd)
    if n < 50:
        return psd.copy()
    # smooth in log space: PSDs span decades, and narrow lines only
    # perturb log(PSD) locally instead of dominating a linear average
    logp = np.log(np.clip(psd[1:], 1e-300, None))
    sav = np.zeros(n)
    div = max(int(0.0025 * n), 1)
    sav[1:div + 1] = np.exp(savgol_order1(logp, 3)[:div])
    sav[1 + div:] = np.exp(savgol_order1(logp, 45)[div:])
    sav[0] = psd[0]
    out = psd.copy()
    # envelope vs |f| so two-sided (fftfreq-ordered) PSDs work too
    out[1:] = make_decreasing(sav[1:], x=np.abs(np.asarray(f)[1:]))
    return out


class NoiseModel(FilterData):
    """Noise decomposition driver (core/noisemodel.py:40-1411).

    PSD-sidedness convention (matching the reference, which folds
    two-sided inputs before fitting — noisemodel.py:837-843): all
    ``psd_*`` inputs here are TWO-SIDED Welch estimates (the framework's
    measurement convention), while the physical 4kTR Johnson /
    Irwin–Hilton formulas in models.tesnoise are ONE-SIDED densities.
    Every fit/subtraction below therefore folds the measured PSD (×2 on
    the non-DC bins) before comparing with the models; fitted
    temperatures and SQUID amplitudes come out physical. Fitting the
    two-sided PSD directly would bias every temperature low by 2×.
    """

    def __init__(self, verbose: bool = True):
        super().__init__(verbose=verbose)
        self._squid: Dict[str, np.ndarray] = {}
        self._tload: Dict[str, float] = {}
        # reference-style nested store: {channel: {state: {...},
        # 'sim': {state: budget arrays}, 'smallsignalparams', 'biasparams'}}
        self._noise_data: Dict[str, dict] = {}
        self._tbath: Optional[float] = None
        self._tload_guess: Optional[float] = None
        self._tc: Dict[str, float] = {}
        self._gta: Dict[str, float] = {}
        self._inductance: Dict[str, dict] = {}
        self._poles: Optional[int] = None

    # -- reference-parity setters (noisemodel.py:50-360) ----------------
    def set_tbath(self, tbath: float):
        """Bath temperature default (noisemodel.py:210)."""
        self._tbath = float(tbath)

    def set_tload_guess(self, tload: float):
        """Load-temperature seed (noisemodel.py:217)."""
        self._tload_guess = float(tload)

    def set_tc(self, channel: str, tc: float):
        """Per-channel Tc default (noisemodel.py:225)."""
        self._tc[channel] = float(tc)

    def set_gta(self, channel: str, gta: float):
        """Per-channel TES-bath conductance override (noisemodel.py:233)."""
        self._gta[channel] = float(gta)

    def set_inductance(self, channel: str, L: float, state: str):
        """Record the loop inductance measured in the normal/SC state
        (noisemodel.py:196-208)."""
        if state not in ("normal", "sc"):
            raise ValueError(
                'ERROR: "state" argument should be "normal" or "sc"!')
        self._inductance.setdefault(channel, {})[state] = float(L)

    def set_psd(self, channel, psd, psd_freqs=None, state=None, **kwargs):
        """Two signatures: the FilterData store form
        ``set_psd(channels, psd, sample_rate, tag=...)`` (state=None),
        and the reference NoiseModel form
        ``set_psd(channel, psd, psd_freqs, state)`` (noisemodel.py:262-283)
        which files the two-sided PSD under the channel's normal/sc/
        transition slot for the noise fits."""
        if state is None:
            # store form: the 3rd positional is the parent's sample_rate;
            # when the caller passed sample_rate as a KEYWORD instead,
            # psd_freqs stays None and must not be forwarded positionally
            if psd_freqs is None:
                return super().set_psd(channel, psd, **kwargs)
            return super().set_psd(channel, psd, psd_freqs, **kwargs)
        if state not in ("normal", "sc", "transition"):
            raise ValueError('ERROR: "state" argument should be "normal", '
                             '"sc", or "transition"')
        psd_freqs = np.asarray(psd_freqs)
        if not np.any(psd_freqs < 0):
            raise ValueError("ERROR: Two-sided PSD needs to be provided, "
                             "not folded PSD!")
        slot = self._noise_data.setdefault(channel, {}).setdefault(
            state, {})
        slot["psd"] = np.asarray(psd)
        slot["psd_freqs"] = psd_freqs

    def set_psd_from_file(self, file_name: str):
        """Load PSDs from a filter file (.npz or HDF5) whose tags name the TES
        state (``psd_normal`` / ``psd_sc`` / ``psd_transition``) and file
        them into the noise-data slots (reference stub at
        noisemodel.py:241-249; here implemented against this package's
        tagged PSD store)."""
        self.load(file_name)
        found = 0
        for chan in list(self._filter_data):
            for state in ("normal", "sc", "transition"):
                try:
                    psd, _, md = self._get(chan, f"psd_{state}")
                except (KeyError, ValueError):
                    continue
                fs = float((md or {}).get("sample_rate", 0.0))
                if not fs:
                    continue
                freqs = np.fft.fftfreq(len(np.asarray(psd)), d=1.0 / fs)
                self.set_psd(chan, np.asarray(psd), freqs, state)
                found += 1
        if not found:
            raise ValueError(
                f"no state-tagged PSDs (psd_normal/psd_sc/psd_transition) "
                f"found in {file_name} — store them with "
                "set_psd(channel, psd, sample_rate, tag=state) first")
        return self

    def set_normal_fit_results(self, channel: str, squiddc=None,
                               squidpole=None, squidn=None):
        """Record externally obtained normal-fit SQUID parameters
        (noisemodel.py:285-311)."""
        if squiddc is None or squidpole is None or squidn is None:
            raise ValueError('ERROR: "squiddc", "squidpole", and '
                             '"squidn" are required!')
        self._noise_data.setdefault(channel, {}).setdefault(
            "normal", {})["fit"] = {
                "squiddc": float(squiddc), "squidpole": float(squidpole),
                "squidn": float(squidn)}

    def set_sc_fit_results(self, channel: str, tload=None):
        """Record an externally obtained SC-fit Tload
        (noisemodel.py:313-330)."""
        if tload is None:
            raise ValueError('ERROR: "tload" is required!')
        self._noise_data.setdefault(channel, {}).setdefault(
            "sc", {})["fit"] = {"tload": float(tload)}
        self._tload[channel] = float(tload)

    def set_squid_noise(self, channel: str, squid_noise, squid_noise_freqs):
        """Record an externally measured SQUID noise PSD [A²/Hz]
        (noisemodel.py:332-357); also used as the squiddc default in
        analyze_noise (which keeps amplitudes [A/√Hz] internally, hence
        the sqrt at this boundary)."""
        sim = self._noise_data.setdefault(channel, {}).setdefault(
            "sim", {"normal": {}, "sc": {}, "transition": {}})
        sim["normal"]["s_isquid"] = np.asarray(squid_noise)
        sim["normal"]["freqs"] = np.asarray(squid_noise_freqs)
        self._squid[channel] = np.sqrt(np.asarray(squid_noise))

    def set_iv_didv_results_from_dict(self, channel: str,
                                      didv_results: Optional[dict] = None,
                                      poles: int = 2,
                                      ivsweep_results: Optional[dict] = None):
        """File dIdV small-signal params and IV-sweep bias params for a
        channel (noisemodel.py:96-194)."""
        data = self._noise_data.setdefault(channel, {})
        self._poles = poles
        if didv_results is not None:
            if poles is None:
                raise ValueError("ERROR: dIdV poles (2 or 3) required!")
            self.set_didv_results(channel, didv_results, poles=poles,
                                  metadata=didv_results.get("metadata"))
            if "smallsignalparams" not in didv_results:
                raise ValueError(
                    f'ERROR: dIdV fit results do not contain '
                    f'"smallsignalparams" for channel {channel}!')
            data["smallsignalparams"] = dict(
                didv_results["smallsignalparams"])
            if didv_results.get("biasparams") is not None:
                data["biasparams"] = dict(didv_results["biasparams"])
        if ivsweep_results is not None:
            self.set_ivsweep_results(channel, ivsweep_results, "noise")
            bias = data.setdefault("biasparams", {})
            bias.update({k: v for k, v in ivsweep_results.items()
                         if k not in bias})
            for state, key in (("normal", "normal_didv_fit_L"),
                               ("sc", "sc_didv_fit_L")):
                if key in ivsweep_results:
                    self.set_inductance(channel, ivsweep_results[key],
                                        state)
        if "rn" not in data.get("biasparams", {}):
            raise ValueError(
                f'ERROR: No Rn found for channel {channel}! Add "rn" '
                'key/value in "ivsweep_results" argument.')

    def set_iv_didv_results_from_file(self, file_name: str, poles: int = 2,
                                      channels=None):
        """Load dIdV/IV-sweep results from a filter file (.npz or HDF5)
        (noisemodel.py:50-94)."""
        self.load(file_name)
        if channels is None:
            channels = list(self._filter_data.keys())
            if not channels:
                raise ValueError(f"ERROR: No data loaded... "
                                 f"Check file {file_name}")
        elif isinstance(channels, str):
            channels = [channels]
        for chan in channels:
            if chan not in self._filter_data:
                raise ValueError(f"ERROR: No data loaded for channel "
                                 f"{chan}. Check file {file_name}!")
            didv_results = None
            try:
                didv_results = self.get_didv_results(chan, poles=poles)
            except (KeyError, ValueError):
                print(f"WARNING: No {poles}-poles dIdV results found "
                      f"for channel {chan}!")
            ivsweep_results = None
            try:
                ivsweep_results = self.get_ivsweep_results(chan, "noise")
            except (KeyError, ValueError):
                pass
            self.set_iv_didv_results_from_dict(
                chan, didv_results=didv_results, poles=poles,
                ivsweep_results=ivsweep_results)
        return self

    # -- reference-parity getters ---------------------------------------
    @staticmethod
    def get_squid_noise_from_fit(freqs, squiddc, squidpole, squidn):
        """SQUID current-noise PSD from the three-parameter normal-fit
        model, (squiddc·(1+(squidpole/f)^squidn))² (noisemodel.py:695-702)."""
        return (squiddc * (1.0 + (squidpole / np.asarray(freqs))
                           ** squidn)) ** 2.0

    def get_noise_data(self, channel: Optional[str] = None,
                       mode: str = "transition") -> dict:
        """Simulated budget arrays for a channel/state
        (noisemodel.py:704-746): keys s_ites/s_iload/s_itfn/s_isquid/
        s_itot (+ power-referred) and freqs."""
        if channel is None:
            raise ValueError("You must specify a channel.")
        if mode not in ("transition", "normal", "sc"):
            raise ValueError(f"'{mode}' is not a valid mode. Valid "
                             "options are: transition, normal, sc.")
        if channel not in self._noise_data:
            raise ValueError(
                f"Channel '{channel}' not found in noise data.")
        sim = self._noise_data[channel].get("sim", {})
        if mode not in sim or not sim[mode]:
            raise ValueError(
                f"Noise data for mode '{mode}' not available for channel "
                f"'{channel}'. Have you run analyze_noise()?")
        return sim[mode]

    # ------------------------------------------------------------------
    def calc_squid_noise(self, channel: str,
                         psd_normal: np.ndarray, freqs: np.ndarray,
                         rn: float, rl: float, L: float,
                         tc: float, tload_guess: float = 0.03,
                         tag: str = "default") -> np.ndarray:
        """SQUID noise amplitude [A/√Hz] per frequency from the
        normal-state PSD (noisemodel.py:354-492)."""
        mask = np.asarray(freqs) != 0
        squid = np.zeros_like(np.asarray(psd_normal))
        # fold two-sided → one-sided before subtracting the one-sided
        # Johnson prediction (see class docstring)
        squid[mask] = tesnoise.squid_noise_from_normal(
            2.0 * np.asarray(psd_normal)[mask], rn, rl, L, tc,
            tload_guess, np.asarray(freqs)[mask])
        self._squid[channel] = squid
        self._set(channel, f"squid_noise_{tag}", squid,
                  {"rn": rn, "rl": rl, "L": L, "tc": tc})
        sim = self._noise_data.setdefault(channel, {}).setdefault(
            "sim", {"normal": {}, "sc": {}, "transition": {}})
        # sim slot carries the PSD [A²/Hz] (reference get_noise_data
        # units); self._squid keeps the amplitude [A/√Hz]
        sim["normal"]["s_isquid"] = squid ** 2
        sim["normal"]["freqs"] = np.asarray(freqs)
        return squid

    def get_squid_noise(self, channel: str) -> np.ndarray:
        return self._squid[channel]

    # ------------------------------------------------------------------
    def fit_sc_noise(self, channel: str, psd_sc: np.ndarray,
                     freqs: np.ndarray, rl: float, L: float,
                     squiddc: Optional[float] = None,
                     lgc_flatten: bool = True,
                     tag: str = "default") -> float:
        """Fit Tload to the SC-state PSD with a flat SQUID level (the
        reference's noisemodel.py:748-913); ``lgc_flatten`` smooths spikes
        and takes the decreasing envelope first (noisemodel.py:876)."""
        return self.fit_sc_noise_batch(channel, [psd_sc], freqs, rl, L,
                                       squiddc, lgc_flatten, tag)[0]

    def fit_sc_noise_batch(self, channel: str, psds, freqs: np.ndarray,
                           rl: float, L: float,
                           squiddc: Optional[float] = None,
                           lgc_flatten: bool = True,
                           tag: str = "default") -> list:
        """:meth:`fit_sc_noise` of each PSD of ``psds`` (one ``freqs``
        axis), the fits one batched LM call with the closed-form
        Jacobian; each Tload is that of its own call, and the store keeps
        the last, as a loop of calls leaves it."""
        mask = np.asarray(freqs) != 0
        f = torch.as_tensor(np.asarray(freqs, float)[mask])
        # fold: two-sided measurement → one-sided model domain
        data = torch.stack([torch.as_tensor(2.0 * (
            flatten_psd(freqs, ps) if lgc_flatten
            else np.asarray(ps, float))[mask]) for ps in psds])

        if squiddc is None and channel in self._squid:
            sq = self._squid[channel]
            if len(sq) == len(mask):
                squiddc = float(np.median(sq[mask]))
            else:
                # normal and SC PSDs from different trace lengths — the
                # flat SQUID level is frequency-independent, so the
                # median over the stored array's nonzero bins suffices
                squiddc = float(np.median(sq[sq > 0])) if np.any(sq > 0) \
                    else 0.0
        squiddc = squiddc or 0.0

        def residual(params, f, data):
            tload = torch.abs(params[0])
            model = (4 * tesnoise.KB * tload * rl
                     / (rl**2 + (2 * np.pi * f * L) ** 2) + squiddc**2)
            # fit in log space (PSD spans decades)
            return torch.log(model) - torch.log(data)

        def jacobian(params, f, data):
            tload = torch.abs(params[:, :1])
            hot = 4 * tesnoise.KB * rl / (rl**2 + (2 * np.pi * f * L) ** 2)
            model = hot * tload + squiddc**2
            return (hot / model * torch.sign(params[:, :1]))[..., None]

        k = len(psds)
        res = lm.batched_lm(
            residual, torch.full((k, 1), 0.03, dtype=torch.float64),
            (f.expand(k, -1), data), max_iter=100, jacobian=jacobian)
        tloads = [abs(v) for v in res.params[:, 0].tolist()]
        self._tload[channel] = tloads[-1]
        self._set(channel, f"sc_noise_fit_{tag}",
                  {"tload": tloads[-1], "squiddc": squiddc, "rl": rl,
                   "L": L}, None)
        return tloads

    def get_tload(self, channel: str) -> float:
        return self._tload[channel]

    # ------------------------------------------------------------------
    def fit_normal_noise(self, channel: str, psd_normal: np.ndarray,
                         freqs: np.ndarray, rn: float, rl: float,
                         tc: float,
                         fit_inductance: bool = True,
                         squiddc_guess: Optional[float] = None,
                         lgc_flatten: bool = True,
                         tag: str = "default") -> dict:
        """Fit the normal-state PSD for (L, Tload, squid level) (the
        reference's noisemodel.py:493-747): passive Johnson noise through
        the R+iωL loop plus a flat SQUID term, Rn held at the IV sweep's;
        ``fit_inductance=False`` holds L at 4e-7 H. ``lgc_flatten`` smooths
        spikes and takes the decreasing envelope first
        (noisemodel.py:614)."""
        return self.fit_normal_noise_batch(
            channel, [psd_normal], freqs, rn, rl, tc, fit_inductance,
            squiddc_guess, lgc_flatten, tag)[0]

    def fit_normal_noise_batch(self, channel: str, psds,
                               freqs: np.ndarray, rn: float, rl: float,
                               tc: float, fit_inductance: bool = True,
                               squiddc_guess: Optional[float] = None,
                               lgc_flatten: bool = True,
                               tag: str = "default") -> list:
        """:meth:`fit_normal_noise` of each PSD of ``psds`` (one ``freqs``
        axis), the fits one batched LM call with the closed-form
        Jacobian; each result is that of its own call, and the store
        keeps the last, as a loop of calls leaves it."""
        mask = np.asarray(freqs) != 0
        f = torch.as_tensor(np.asarray(freqs, float)[mask])
        flat = [flatten_psd(freqs, ps) if lgc_flatten
                else np.asarray(ps, float) for ps in psds]
        # fold: two-sided measurement → one-sided model domain
        data = torch.stack([torch.as_tensor(2.0 * ps[mask]) for ps in flat])
        guesses = [squiddc_guess if squiddc_guess is not None
                   else float(np.sqrt(max(np.median(2.0 * ps[mask]) * 0.1,
                                          1e-30))) for ps in flat]
        l_fixed = 0.0 if fit_inductance else 4e-7
        johnson = 4 * tesnoise.KB * tc * rn
        w2 = (2 * np.pi * f) ** 2

        def unpack(params):
            # fit_inductance=False HOLDS L (it is no parameter at all)
            if fit_inductance:
                return params[..., 0], params[..., 1], params[..., 2]
            return None, params[..., 0], params[..., 1]

        def residual(params, f, data):
            ind, tload, squid = unpack(params)
            ind = l_fixed if ind is None else torch.abs(ind)
            ztot2 = (rn + rl) ** 2 + (2 * np.pi * f * ind) ** 2
            model = ((4 * tesnoise.KB * tc * rn
                      + 4 * tesnoise.KB * torch.abs(tload) * rl) / ztot2
                     + torch.abs(squid)**2)
            return torch.log(model) - torch.log(data)

        def jacobian(params, f, data):
            ind, tload, squid = (None if v is None else v[:, None]
                                 for v in unpack(params))
            ind_a = l_fixed if ind is None else torch.abs(ind)
            ztot2 = (rn + rl) ** 2 + w2 * ind_a ** 2
            num = johnson + 4 * tesnoise.KB * torch.abs(tload) * rl
            inv = 1.0 / (num / ztot2 + squid ** 2)
            cols = [inv * 4 * tesnoise.KB * rl / ztot2 * torch.sign(tload),
                    inv * 2 * squid * torch.ones_like(ztot2)]
            if ind is not None:
                cols.insert(0, -inv * num / ztot2 ** 2 * 2 * w2 * ind)
            return torch.stack(cols, dim=-1)

        x0 = torch.tensor([[4e-7, 0.03, g] if fit_inductance else [0.03, g]
                           for g in guesses], dtype=torch.float64)
        k = len(psds)
        res = lm.batched_lm(residual, x0, (f.expand(k, -1), data),
                            max_iter=150, jacobian=jacobian)
        outs = []
        for params, cost in zip(np.abs(res.params.numpy()),
                                res.cost.tolist()):
            if fit_inductance:
                out = {"L": float(params[0]), "tload": float(params[1]),
                       "squiddc": float(params[2])}
            else:
                out = {"L": float(l_fixed), "tload": float(params[0]),
                       "squiddc": float(params[1])}
            out.update({"cost": cost, "rn": rn, "rl": rl, "tc": tc})
            outs.append(out)
        self._set(channel, f"normal_noise_fit_{tag}", outs[-1], None)
        return outs

    # ------------------------------------------------------------------
    def analyze_noise(self, channel: str,
                      freqs: np.ndarray,
                      ssp: Optional[dict] = None,
                      bias: Optional[dict] = None,
                      tc: Optional[float] = None,
                      tbath: Optional[float] = None,
                      gta: Optional[float] = None,
                      squiddc: Optional[float] = None,
                      tload: Optional[float] = None,
                      psd_measured: Optional[np.ndarray] = None,
                      tag: str = "default") -> dict:
        """Transition-state noise budget (noisemodel.py:979-1290).

        ssp: small-signal params (beta, l, L, tau0) from DIDVAnalysis;
        bias: IV bias point (r0, i0, rp, rshunt, p0);
        gta: thermal conductance (default from P0 and temperatures,
        G = n·P0/(Tc·(1−(Tb/Tc)^n)) with n=5).
        """
        # stored defaults (set_tc/set_tbath/set_gta and
        # set_iv_didv_results_from_dict, noisemodel.py:96-240)
        data = self._noise_data.get(channel, {})
        if ssp is None:
            ssp = data.get("smallsignalparams")
        if bias is None:
            bias = data.get("biasparams")
        if ssp is None or bias is None:
            raise ValueError(
                f"ssp/bias required for channel {channel} — pass them or "
                "call set_iv_didv_results_from_dict first")
        tc = self._tc.get(channel) if tc is None else tc
        tbath = self._tbath if tbath is None else tbath
        if tc is None or tbath is None:
            raise ValueError(
                f"tc/tbath required for channel {channel} — pass them or "
                "call set_tc/set_tbath first")
        if gta is None:
            gta = self._gta.get(channel)
        freqs = np.asarray(freqs)
        r0 = bias["r0"]
        rl = bias.get("rshunt", bias.get("rsh", 0.0)) + bias.get("rp", 0.0)
        i0 = bias["i0"]
        p0 = bias.get("p0", i0**2 * r0)
        n_exp = 5.0
        if gta is None:
            ratio = (tbath / tc) ** n_exp
            gta = n_exp * p0 / (tc * max(1.0 - ratio, 1e-12))
        if squiddc is None and channel in self._squid:
            squiddc = float(np.median(
                self._squid[channel][np.asarray(freqs) != 0]))
        if tload is None:
            tload = self._tload.get(channel, tbath)

        params = tesnoise.TESParams(
            r0=r0, rl=rl, beta=ssp["beta"], l=ssp["l"], L=ssp["L"],
            tau0=ssp["tau0"], G=gta, tc=tc, tload=tload, tb=tbath,
            i0=i0, squiddc=squiddc or 0.0, n=n_exp)

        budget = {
            "freqs": freqs,
            "s_ites": tesnoise.s_ites(params, freqs),
            "s_iload": tesnoise.s_iload(params, freqs),
            "s_itfn": tesnoise.s_itfn(params, freqs),
            "s_isquid": tesnoise.s_isquid(params, freqs),
        }
        budget["s_itot"] = (budget["s_ites"] + budget["s_iload"]
                            + budget["s_itfn"] + budget["s_isquid"])
        # power-referred versions
        for key in ("s_ites", "s_iload", "s_itfn", "s_isquid", "s_itot"):
            budget[key.replace("s_i", "s_p")] = tesnoise.current_to_power(
                budget[key], params, freqs)
        if psd_measured is not None:
            # measured two-sided PSD folded onto the one-sided budget
            budget["s_imeas"] = 2.0 * np.asarray(psd_measured)
            budget["s_pmeas"] = tesnoise.current_to_power(
                budget["s_imeas"], params, freqs)
        budget["params"] = params._asdict()
        # file under the reference's sim slot for get_noise_data
        sim = self._noise_data.setdefault(channel, {}).setdefault(
            "sim", {"normal": {}, "sc": {}, "transition": {}})
        sim["transition"] = {k: v for k, v in budget.items()
                             if isinstance(v, np.ndarray)}
        self._set(channel, f"noise_budget_{tag}",
                  {k: v for k, v in budget.items()
                   if isinstance(v, np.ndarray)},
                  {"tc": tc, "tbath": tbath, "gta": gta, "tload": tload,
                   "squiddc": squiddc or 0.0})
        return budget
