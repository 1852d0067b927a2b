"""The port's plots draw what the JAX package's draw.

Each function of ``detprocess_tpu_torch/utils/plotting.py``, the
``FilterData.plot_*`` delegates, ``DIDVAnalysis.plot_fit_result`` and
``IVSweepAnalysis.plot_didv_summary`` against their JAX counterparts on
the same data (matplotlib's Agg backend): the same lines, each with the
same x and y data (exactly, but for the dIdV model, which JAX evaluates
in its own arithmetic: 1e-12) and labels, the same axis labels.
"""

from types import SimpleNamespace

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

from detprocess_tpu.io.filterfile import FilterData as JaxFD  # noqa: E402
from detprocess_tpu.pipelines.didv import DIDVAnalysis as JaxDIDV  # noqa: E402
from detprocess_tpu.pipelines.ivsweep import (  # noqa: E402
    IVSweepAnalysis as JaxIVA)
from detprocess_tpu.utils import plotting as jplot  # noqa: E402
from detprocess_tpu_torch.io.filterdata import FilterData  # noqa: E402
from detprocess_tpu_torch.pipelines.didv import DIDVAnalysis  # noqa: E402
from detprocess_tpu_torch.pipelines.ivsweep import (  # noqa: E402
    IVSweepAnalysis)
from detprocess_tpu_torch.utils import plotting  # noqa: E402

FS = 1.25e6
N = 512


def lines_of(ax):
    return [(np.asarray(line.get_xdata(), float),
             np.asarray(line.get_ydata(), float), line.get_label())
            for line in ax.get_lines()]


def assert_same_axes(got, ref, rtol=0.0):
    assert got.get_xlabel() == ref.get_xlabel()
    assert got.get_ylabel() == ref.get_ylabel()
    lg, lr = lines_of(got), lines_of(ref)
    assert len(lg) == len(lr) > 0
    for (xg, yg, ng), (xr, yr, nr) in zip(lg, lr):
        assert ng == nr
        np.testing.assert_allclose(xg, xr, rtol=rtol, atol=0)
        np.testing.assert_allclose(yg, yr, rtol=rtol, atol=0)


@pytest.fixture(scope="module")
def stores():
    rng = np.random.default_rng(8)
    t = np.arange(N) / FS
    tmpl = np.where(t > 1e-4, np.exp(-(t - 1e-4) / 2e-4)
                    - np.exp(-(t - 1e-4) / 2e-5), 0.0)
    psd = rng.uniform(1, 2, N) * 1e-22
    csd = rng.standard_normal((2, 2, N)) + 1j * rng.standard_normal((2, 2, N))
    csd[0, 0] = np.abs(csd[0, 0]) + 3
    csd[1, 1] = np.abs(csd[1, 1]) + 3
    bias = np.linspace(4e-4, -1e-5, 7)
    sweep = {"tes_bias": bias,
             "offset_noise": rng.standard_normal(7) * 1e-6,
             "offset_noise_err": rng.uniform(1, 2, 7) * 1e-8,
             "offset_didv": rng.standard_normal(7) * 1e-6}
    out = []
    for fd in (JaxFD(verbose=False), FilterData(verbose=False)):
        fd.set_template("chan1", tmpl, FS, pretrigger_length_samples=80)
        fd.set_template("chan2", np.stack([tmpl, 0.5 * tmpl]), FS,
                        pretrigger_length_samples=80, tag="two")
        fd.set_psd("chan1", psd, FS)
        fd.set_psd("chan2", 2 * psd, FS)
        fd.set_csd(["chan1", "chan2"], csd, FS)
        fd.set_ivsweep_data("chan1", pd.DataFrame(sweep))
        out.append(fd)
    return out


@pytest.mark.parametrize("which", [
    ("plot_template", ("chan1",), {}),
    ("plot_template", ("chan2",), {"tag": "two"}),
    ("plot_psd", (["chan1", "chan2"],), {}),
    ("plot_psd", ("chan1",), {"fold": False}),
    ("plot_csd", ("chan1|chan2",), {}),
    ("plot_corrcoeff", ("chan1|chan2",), {}),
    ("plot_corrcoeff", ("chan1|chan2",), {"lgcsmooth": False}),
    ("plot_ivsweep_offset", ("chan1",), {}),
])
def test_filter_data_plots(stores, which):
    name, args, kw = which
    jfd, fd = stores
    for via_store in (False, True):
        if via_store:
            ref, got = (getattr(jfd, name)(*args, **kw),
                        getattr(fd, name)(*args, **kw))
        else:
            ref = getattr(jplot, name)(jfd, *args, **kw)
            got = getattr(plotting, name)(fd, *args, **kw)
        assert_same_axes(got, ref)
        plt.close("all")


def test_noise_budget_and_iv_sweep():
    rng = np.random.default_rng(2)
    f = np.geomspace(1, 1e5, 50)
    budget = {"freqs": f, **{f"s_i{k}": rng.uniform(1, 2, 50) * 1e-22
                             for k in ("tes", "load", "tfn", "squid", "tot",
                                       "meas")},
              **{f"s_p{k}": rng.uniform(1, 2, 50) * 1e-34
                 for k in ("tes", "tot")}}
    for power in (False, True):
        assert_same_axes(plotting.plot_noise_budget(budget,
                                                    power_referred=power),
                         jplot.plot_noise_budget(budget,
                                                 power_referred=power))
    sweep = {"tes_bias": np.array([4e-4, 3e-4, 1e-4, 5e-5, 2e-6, 1e-6]),
             "state": np.array(["normal", "normal", "transition",
                                "transition", "sc", "sc"], dtype=object),
             "percent_rn": np.array([100.0, 100.0, 40.0, 20.0, 0.0, 0.0])}
    assert_same_axes(plotting.plot_iv_sweep(sweep),
                     jplot.plot_iv_sweep(pd.DataFrame(sweep)))
    no_rn = {k: v for k, v in sweep.items() if k != "percent_rn"}
    no_rn["r0"] = np.array([0.3, 0.3, 0.1, 0.05, 0.0, 0.0])
    assert_same_axes(plotting.plot_iv_sweep(no_rn),
                     jplot.plot_iv_sweep(pd.DataFrame(no_rn)))
    plt.close("all")


def didv_case():
    f = np.geomspace(100, 1e5, 60)
    params = np.array([0.02, -0.01, 1e-4, 3e-6])
    w = 2j * np.pi * f
    didv = 1.0 / (params[0] * (1 + w * params[3])
                  + params[1] / (1 + w * params[2]))
    data = SimpleNamespace(freqs=f, didv=didv * (1 + 0.01j))
    fit = SimpleNamespace(params=params, poles=2)
    return data, fit


def test_didv_plots():
    data, fit = didv_case()
    for kw in ({}, {"nharmonics": 20}):
        assert_same_axes(plotting.plot_didv_fit(data, fit, **kw),
                         jplot.plot_didv_fit(data, fit, **kw), rtol=1e-12)
    assert_same_axes(plotting.plot_didv_fit(data), jplot.plot_didv_fit(data))
    ana, jana = DIDVAnalysis(verbose=False, device="cpu"), JaxDIDV(
        verbose=False)
    for a in (ana, jana):
        a._didv_data["chan1"] = data
        a._fits["chan1"] = {2: fit}
    got, ref = ana.plot_fit_result("chan1"), jana.plot_fit_result("chan1")
    assert len(got) == len(ref) == 1
    for g, r in zip(got[0].axes, ref[0].axes):
        assert_same_axes(g, r, rtol=1e-12)
        assert g.get_title() == r.get_title()
    plt.close("all")


def test_didv_summary(capsys):
    rng = np.random.default_rng(5)
    table = {"tes_bias": np.linspace(3e-4, 5e-5, 6),
             "percent_rn": np.linspace(90, 10, 6)}
    for k in ("l", "beta", "tau0"):
        table[f"didv_3poles_{k}"] = rng.uniform(1, 2, 6)
        table[f"didv_3poles_{k}_err"] = rng.uniform(0, 0.1, 6)
    ana, jana = IVSweepAnalysis(verbose=False), JaxIVA(verbose=False)
    ana._sweep_df["chan1"] = dict(table)
    jana._sweep_df["chan1"] = pd.DataFrame(table)
    got, ref = ana.plot_didv_summary("chan1"), jana.plot_didv_summary("chan1")
    assert len(got.axes) == len(ref.axes) == 3
    for g, r in zip(got.axes, ref.axes):
        assert_same_axes(g, r)
    assert got._suptitle.get_text() == ref._suptitle.get_text()
    plt.close("all")
    ana._sweep_df["chan2"] = {"tes_bias": table["tes_bias"]}
    assert ana.plot_didv_summary("chan2") is None
    assert "No dIdV analysis done for chan2" in capsys.readouterr().out
