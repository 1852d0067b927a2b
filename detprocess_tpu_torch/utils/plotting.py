"""Plots of filter data, noise budgets and IV-sweep curves.

Copies of the eight functions of ``detprocess_tpu/utils/plotting.py``
(:16-182; the reference's FilterData plotters, filterdata.py:1403-1604,
and its noise-model and IV-sweep plots) on the port's stores: a
:class:`~detprocess_tpu_torch.io.filterdata.FilterData` and the sweep
:class:`~detprocess_tpu_torch.io.filterdata.Table` (a dict of columns)
where the JAX functions take DataFrames. matplotlib is imported inside
each function, so the package imports without it. Every function takes
an ``ax`` (made on demand) and returns it; nothing is shown.
"""

from __future__ import annotations

import numpy as np


def _get_ax(ax=None, **subplot_kw):
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(**subplot_kw)
    return ax


def plot_template(filter_data, channel: str, tag: str = "default", ax=None):
    """The time-domain template(s) of ``channel`` [``tag``]."""
    ax = _get_ax(ax)
    template, time, _ = filter_data.get_template(channel, tag=tag,
                                                 return_metadata=True)
    t = (np.asarray(time) if time is not None
         else np.arange(np.shape(template)[-1]))
    arr = np.atleast_2d(np.asarray(template).reshape(
        -1, np.shape(template)[-1]))
    for i, row in enumerate(arr):
        ax.plot(t * 1e3, row, label=f"{channel} [{tag}]"
                + (f" #{i}" if len(arr) > 1 else ""))
    ax.set_xlabel("time [ms]")
    ax.set_ylabel("template [norm.]")
    ax.legend()
    return ax


def plot_psd(filter_data, channels, tag: str = "default", fold: bool = True,
             ax=None):
    """The (folded) amplitude spectral density √PSD of ``channels``."""
    ax = _get_ax(ax)
    if isinstance(channels, str):
        channels = [channels]
    for chan in channels:
        psd, freqs = filter_data.get_psd(chan, tag=tag, fold=fold)
        sl = slice(1, None)
        ax.loglog(freqs[sl], np.sqrt(psd[sl]), label=f"{chan} [{tag}]")
    ax.set_xlabel("frequency [Hz]")
    ax.set_ylabel("ASD [A/√Hz]")
    ax.legend()
    ax.grid(True, which="both", alpha=0.3)
    return ax


def plot_csd(filter_data, channel: str, tag: str = "default", ax=None):
    """|CSD| of every channel pair of the compound ``channel``."""
    ax = _get_ax(ax)
    csd, freqs = filter_data.get_csd(channel, tag=tag)
    c = csd.shape[0]
    sl = slice(1, csd.shape[-1] // 2)
    for i in range(c):
        for j in range(i, c):
            ax.loglog(np.abs(freqs[sl]), np.abs(csd[i, j, sl]),
                      label=f"({i},{j})", alpha=0.8)
    ax.set_xlabel("frequency [Hz]")
    ax.set_ylabel("|CSD| [A²/Hz]")
    ax.legend(ncol=2, fontsize=8)
    ax.grid(True, which="both", alpha=0.3)
    return ax


def plot_noise_budget(budget: dict, ax=None, power_referred: bool = False):
    """The Irwin–Hilton noise budget of ``NoiseModel.analyze_noise``: each
    component's √PSD, the total, and the measured noise when given."""
    ax = _get_ax(ax)
    freqs = budget["freqs"]
    prefix = "s_p" if power_referred else "s_i"
    labels = {"tes": "TES Johnson", "load": "load Johnson",
              "tfn": "phonon TFN", "squid": "SQUID+electronics",
              "tot": "total"}
    for key, label in labels.items():
        name = prefix + key
        if name in budget:
            style = "-k" if key == "tot" else "-"
            ax.loglog(freqs, np.sqrt(budget[name]), style, label=label,
                      lw=2 if key == "tot" else 1.2)
    meas = prefix + "meas"
    if meas in budget:
        ax.loglog(freqs, np.sqrt(budget[meas]), ".", ms=2, alpha=0.5,
                  label="measured")
    unit = "W/√Hz" if power_referred else "A/√Hz"
    ax.set_xlabel("frequency [Hz]")
    ax.set_ylabel(f"noise [{unit}]")
    ax.legend(fontsize=8)
    ax.grid(True, which="both", alpha=0.3)
    return ax


def plot_iv_sweep(sweep_table, x: str = "tes_bias", ax=None):
    """R0 (in % of Rn when the table has it) against |bias|, a line a
    state, states in sorted order as pandas' ``groupby`` takes them."""
    ax = _get_ax(ax)
    colors = {"normal": "tab:red", "transition": "tab:green",
              "sc": "tab:blue"}
    state = np.asarray(sweep_table["state"]).astype(str)
    yname = "percent_rn" if "percent_rn" in sweep_table else "r0"
    for st in sorted(set(state)):
        rows = state == st
        ax.plot(np.abs(np.asarray(sweep_table[x], float)[rows]) * 1e6,
                np.asarray(sweep_table[yname], float)[rows], "o-",
                color=colors.get(st, "gray"), label=st)
    ax.set_xlabel("|TES bias| [µA]")
    ax.set_ylabel("R0 [% Rn]" if "percent_rn" in sweep_table else "R0 [Ω]")
    ax.legend()
    ax.grid(alpha=0.3)
    return ax


def plot_didv_fit(didv_data, fit=None, ax=None, nharmonics: int = 100):
    """Measured dIdV(f), real and imaginary parts, with the fitted model
    of ``fit`` (``models/didv.DIDVFit``) over them."""
    from detprocess_tpu_torch.models import didv as didv_models

    ax = _get_ax(ax)
    f = didv_data.freqs[:nharmonics]
    d = didv_data.didv[:nharmonics]
    ax.semilogx(f, d.real, "o", ms=3, label="Re measured")
    ax.semilogx(f, d.imag, "s", ms=3, label="Im measured")
    if fit is not None:
        ff = np.geomspace(f[0], f[-1], 400)
        model = didv_models.didv_model(fit.params, ff, fit.poles).numpy()
        ax.semilogx(ff, model.real, "-", label=f"Re fit ({fit.poles}-pole)")
        ax.semilogx(ff, model.imag, "--", label="Im fit")
    ax.set_xlabel("frequency [Hz]")
    ax.set_ylabel("dIdV [1/Ω]")
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    return ax


def plot_corrcoeff(filter_data, channel: str, tag: str = "default",
                   lgcsmooth: bool = True, nwindow: int = 7, ax=None):
    """|CSD_ij| / √(CSD_ii·CSD_jj) of every channel pair, smoothed over
    ``nwindow`` bins with ``lgcsmooth``."""
    ax = _get_ax(ax)
    csd, freqs = filter_data.get_csd(channel, tag=tag)
    c = csd.shape[0]
    sl = slice(1, csd.shape[-1] // 2)
    for i in range(c):
        for j in range(i + 1, c):
            corr = (np.abs(csd[i, j, sl])
                    / np.sqrt(np.abs(csd[i, i, sl] * csd[j, j, sl])))
            if lgcsmooth and nwindow > 1:
                kern = np.ones(nwindow) / nwindow
                corr = np.convolve(corr, kern, mode="same")
            ax.semilogx(np.abs(freqs[sl]), corr, label=f"({i},{j})",
                        alpha=0.85)
    ax.set_xlabel("frequency [Hz]")
    ax.set_ylabel("correlation coefficient")
    ax.set_ylim(0, 1.05)
    ax.legend(ncol=2, fontsize=8)
    ax.grid(True, which="both", alpha=0.3)
    return ax


def plot_ivsweep_offset(filter_data, channel: str, tag: str = "default",
                        ax=None):
    """The noise and dIdV current offsets of the stored IV-sweep table
    against TES bias, with their errors."""
    ax = _get_ax(ax)
    table = filter_data.get_ivsweep_data(channel, tag=tag)
    bias = np.asarray(table["tes_bias"], float)
    for key, label in (("offset_noise", "noise"), ("offset_didv", "didv")):
        if key in table:
            off = np.asarray(table[key], float)
            err = np.asarray(table.get(key + "_err", np.zeros_like(off)),
                             float)
            ax.errorbar(bias * 1e6, off * 1e6, yerr=err * 1e6, fmt="o-",
                        ms=4, label=label)
    ax.set_xlabel("TES bias [µA]")
    ax.set_ylabel("current offset [µA]")
    ax.legend()
    ax.grid(alpha=0.3)
    return ax
