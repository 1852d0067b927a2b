"""The port's IV/dIdV sweep (``pipelines/ivsweep``) against the JAX
package's ``pipelines/ivsweep.py``, in float64 on the CPU.

One sweep of ``entry.ivsweep_points``'s configuration cut to 8 bias
points (3 normal, 2 in the transition, 3 superconducting), each with 12
noise traces of 4096 samples and 6 dIdV traces of 3 periods of 12500
samples, written as int16 codes into pytesdaq files by the JAX
``RawWriter``; both packages process the same files, and the JAX chain
runs once (module fixtures: its fits dominate the file's time).

- ``IVSweepProcessing.process`` (``device="cpu"``): the table column by
  column, the state tags exactly;
- ``analyze_sweep``: the IBIS result and the table;
- ``analyze_didv`` with 1/2/3 poles: the SC, normal and transition fits,
  the flattened columns and the "didv" results; the Rp/Rn disagreement
  warning;
- ``analyze_noise`` and ``calc_energy_resolution``;
- the "autocuts rejected all" ValueError, ``discover_bias_points``, the
  stable order of ±bias ties, and the ``Table`` accessors.

Tolerances: 1e-9 relative (of a column's largest |value|) for what is
computed the same way (PSDs, offsets, dIdV data, IBIS); 1e-6 for the LM
fits and what derives from their parameters; state tags exactly. Looser,
with their reasons:

- the errors of the 2-pole small-signal parameters, 1e-5: they come
  from the inverse of JᵀJ, whose condition number reaches 3e9 at these
  points, so the rounding-level difference between the port's
  closed-form Jacobian and JAX's forward-mode one moves them by about
  cond·eps ≈ 1e-6;
- the normal-state noise fit's Tload, held in absolute terms (beside
  the check);
- the 3-pole fits: the sweep's working points are one-block TES, for
  which the 3-pole model is degenerate (as C → 0, τ₃ leaves the model;
  the covariance's condition number reaches 1e29), so only the cost, A
  and τ₂ are held at 1e-6; τ₁ (and τ0 = τ₁(1−l)) wanders by up to 1e-5
  along the flat valley (held at 1e-4), and the errors from the
  covariance by up to 3e-4 (held at 1e-3).
"""

import jax  # noqa: F401
import numpy as np
import pytest
import torch

from detprocess_tpu.io.rawdata import RawWriter
from detprocess_tpu.pipelines import ivsweep as jivsweep
from detprocess_tpu_torch import entry
from detprocess_tpu_torch.io.filterdata import Table
from detprocess_tpu_torch.pipelines import ivsweep

torch.set_num_threads(2)

RTOL = 1e-9
FIT_RTOL = 1e-6
CHAN = entry.CHANNEL
FS, RSH = entry.FS, entry.IV_RSH
SG = dict(sgfreq=entry.IV_SGFREQ, sgamp=entry.IV_SGAMP, rsh=RSH)
POINTS = entry.ivsweep_points(normal=(400e-6, 350e-6, 300e-6),
                              transition_r0=(0.15, 0.08),
                              sc=(4e-6, 2e-6, 1e-6))
NOISE_N, NOISE_TRACES, DIDV_TRACES, PERIODS = 4096, 12, 6, 3
TEMPLATE = entry.ivsweep_template(NOISE_N)


def _write(root, kind, k, traces, cal, bias):
    series = f"I1_D20260819_T{(1 if kind == 'iv' else 2) * 10000 + k:06d}"
    w = RawWriter(str(root), series, FS, [CHAN], prefix=kind,
                  data_type="noise" if kind == "iv" else "didv",
                  adc_conversion_factor=cal,
                  detector_config={CHAN: {"tes_bias": bias}})
    return w.write_dump(traces[:, None, :], dump_num=1)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    root = tmp_path_factory.mktemp("ivsweep")
    gen = torch.Generator().manual_seed(7)
    cal = entry.ivsweep_adc_cal(POINTS)
    bias_points = []
    for k, pt in enumerate(POINTS):
        noise = entry.ivsweep_noise(gen, pt["params"], NOISE_TRACES,
                                    NOISE_N, "cpu").numpy()
        didv = entry.ivsweep_didv(gen, pt["params"], DIDV_TRACES, PERIODS,
                                  "cpu").numpy()
        if k == 4:
            noise[3, 1000:1010] += 2e-7          # a glitch for the cuts
        bias_points.append({
            "tes_bias": pt["tes_bias"],
            "noise_files": [_write(root, "iv", k, noise, cal,
                                   pt["tes_bias"])],
            "didv_files": [_write(root, "didv", k, didv, cal,
                                  pt["tes_bias"])]})
    return root, bias_points


@pytest.fixture(scope="module")
def processed(sweep):
    _, bps = sweep
    want = jivsweep.IVSweepProcessing(verbose=False).process(CHAN, bps,
                                                             **SG)
    proc = ivsweep.IVSweepProcessing(verbose=False, device="cpu")
    got = proc.process(CHAN, bps, **SG)
    return got, want, proc


def _analysis(cls, table):
    ana = cls(verbose=False)
    ana.set_data_from_dataframe(CHAN, table, rsh=RSH)
    out = {"sweep": ana.analyze_sweep(CHAN)}
    out["didv"] = ana.analyze_didv(CHAN, poles=(2, 3))
    out["didv_results"] = ana.get_ivsweep_results(CHAN, "didv")
    out["noise"] = ana.analyze_noise(CHAN, tc=entry.IV_TC,
                                     tbath=entry.IV_TBATH,
                                     tload_guess=entry.IV_TLOAD, poles=2)
    out["sigma"] = ana.calc_energy_resolution(CHAN, TEMPLATE, FS, poles=2)
    out["ibis"] = ana.get_ibis(CHAN)
    out["ana"] = ana
    return out


@pytest.fixture(scope="module")
def analysed(processed):
    got, want, _ = processed
    return _analysis(ivsweep.IVSweepAnalysis, got), _analysis(
        jivsweep.IVSweepAnalysis, want)


def _column(df, col):
    if isinstance(df, Table) or isinstance(df, dict):
        return df[col]
    return df[col].to_numpy()


def _assert_column(got, want, col, rtol):
    g, w = _column(got, col), _column(want, col)
    assert len(g) == len(w), col
    cells = [(a, b) for a, b in zip(g, w)]
    if any(isinstance(b, np.ndarray) for _, b in cells):
        for a, b in cells:
            if not isinstance(b, np.ndarray):
                assert a is None or not isinstance(a, np.ndarray), col
                continue
            scale = max(float(np.abs(b).max()), 1e-300)
            np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                                       atol=rtol * scale, err_msg=col)
        return
    w = np.asarray(list(w))
    if w.dtype.kind in "OUS":
        assert [str(v) for v in g] == [str(v) for v in w], col
        return
    w = w.astype(float)
    g = np.asarray(list(g), dtype=float)
    scale = max(float(np.nanmax(np.abs(w))), 1e-300)
    np.testing.assert_allclose(g, w, rtol=0, atol=rtol * scale,
                               equal_nan=True, err_msg=col)


PROCESS_COLUMNS = ("tes_bias", "psd", "offset_noise", "offset_noise_err",
                   "fs", "avgtrace_noise", "didv_freqs", "didv",
                   "didv_weights", "offset_didv", "offset_didv_err",
                   "sgfreq", "sgamp", "state")


def test_process_columns_and_states(processed):
    got, want, proc = processed
    assert list(got) == list(want.columns) == list(PROCESS_COLUMNS)
    assert list(got["state"]) == ["normal"] * 3 + ["transition"] * 2 + [
        "sc"] * 3
    stored, _, md = proc._get(CHAN, "ivsweep_data_default")
    assert stored is got and md["rsh"] == RSH


@pytest.mark.parametrize("col", PROCESS_COLUMNS)
def test_process_matches_jax(processed, col):
    got, want, _ = processed
    _assert_column(got, want, col, RTOL)


def test_analyze_sweep_matches_jax(analysed):
    got, want = analysed
    for field in want["ibis"]._fields:
        np.testing.assert_allclose(getattr(got["ibis"], field),
                                   getattr(want["ibis"], field), rtol=RTOL,
                                   err_msg=field)
    assert list(got["sweep"]) == list(want["sweep"].columns)
    for col in want["sweep"].columns:
        _assert_column(got["sweep"], want["sweep"], col, RTOL)
    np.testing.assert_allclose(got["ibis"].rn, entry.IV_RN, rtol=0.05)
    np.testing.assert_allclose(got["ibis"].rp, entry.IV_RP, rtol=0.05)


DIDV_COLUMNS = ("didv_1poles_rtot", "didv_1poles_chi2") + tuple(
    f"didv_{p}poles_{k}" for p in (2, 3)
    for k in ("chi2", "l", "l_err", "beta", "beta_err", "tau0", "tau0_err",
              "L", "L_err", "r0_infinite_lgain", "i0_infinite_lgain",
              "p0_infinite_lgain")) + ("didv_3poles_gratio",)


def column_rtol(col):
    """The tolerance of a column of analyze_didv (module docstring)."""
    if col.startswith("didv_3poles") and col.endswith("_err"):
        return 1e-3
    if col == "didv_3poles_tau0":
        return 1e-4
    if col.endswith("_err"):
        return 1e-5
    return FIT_RTOL


def test_analyze_didv_column_order(analysed):
    got, want = analysed
    assert list(got["didv"]) == list(want["didv"].columns)


@pytest.mark.parametrize("col", DIDV_COLUMNS)
def test_analyze_didv_matches_jax(analysed, col):
    got, want = analysed
    _assert_column(got["didv"], want["didv"], col, column_rtol(col))


@pytest.mark.parametrize("state,poles", [("sc", 1), ("normal", 1),
                                         ("transition", 2),
                                         ("transition", 3)])
def test_analyze_didv_fits_match_jax(analysed, state, poles):
    got, want = analysed
    states = list(got["didv"]["state"])
    n = 0
    for i, st in enumerate(states):
        gf = got["didv"]["didv_fits"][i].get(f"fit_{poles}poles")
        wf = want["didv"]["didv_fits"].iloc[i].get(f"fit_{poles}poles")
        assert (gf is None) == (wf is None)
        if st != state or gf is None:
            continue
        n += 1
        # 3 poles: only A and τ₂ are identified (module docstring)
        held = [0, 4] if poles == 3 else slice(None)
        np.testing.assert_allclose(gf.params[held], wf.params[held],
                                   rtol=FIT_RTOL)
        np.testing.assert_allclose(gf.cost, wf.cost, rtol=FIT_RTOL)
    assert n == (3 if state != "transition" else 2)


def test_didv_results_and_physics(analysed):
    got, want = analysed
    assert list(got["didv_results"]) == list(want["didv_results"])
    for k, v in want["didv_results"].items():
        np.testing.assert_allclose(got["didv_results"][k], v,
                                   rtol=FIT_RTOL, err_msg=k)
    res = got["didv_results"]
    np.testing.assert_allclose(res["sc_didv_fit_rp"], entry.IV_RP,
                               rtol=0.05)
    np.testing.assert_allclose(res["normal_didv_fit_rn"], entry.IV_RN,
                               rtol=0.05)
    trans = np.asarray(got["didv"]["state"]) == "transition"
    assert (np.abs(got["didv"]["didv_2poles_beta"][trans] - 2.0)
            < 0.5).all()
    assert (np.abs(got["didv"]["didv_2poles_l"][trans] / 10.0 - 1)
            < 0.3).all()


def test_disagreement_warns(processed, capsys):
    got, want, _ = processed
    for cls, table in ((ivsweep.IVSweepAnalysis, got),
                       (jivsweep.IVSweepAnalysis, want)):
        ana = cls(verbose=False)
        ana.set_data_from_dataframe(CHAN, table, rsh=RSH)
        ana.analyze_sweep(CHAN)
        ana._ibis[CHAN] = ana.get_ibis(CHAN)._replace(rp=3 * entry.IV_RP,
                                                      rp_err=1e-6)
        ana.analyze_didv(CHAN, poles=2, enable_normal=False,
                         enable_transition=False)
        out = capsys.readouterr().out
        assert "WARNING" in out and "disagrees with IV sweep" in out


def test_analyze_noise_matches_jax(analysed):
    got, want = analysed
    g, w = got["noise"], want["noise"]
    np.testing.assert_allclose(g["tload"], w["tload"], rtol=FIT_RTOL)
    np.testing.assert_allclose(g["squid_noise"], w["squid_noise"],
                               rtol=FIT_RTOL,
                               atol=FIT_RTOL * np.abs(w["squid_noise"]).max())
    for k in w["normal_fit"]:
        # the normal fit does not identify its Tload: the load's Johnson
        # term, 4kB·Tload·Rl, is 30× below the TES's 4kB·Tc·Rn even at
        # Tload = Tc, and both fits drive it to ~1e-13 K; it is held in
        # absolute terms, at 1e-6 of Tc·Rn/Rl
        atol = (FIT_RTOL * entry.IV_TC * entry.IV_RN / (RSH + entry.IV_RP)
                if k == "tload" else 0.0)
        np.testing.assert_allclose(g["normal_fit"][k], w["normal_fit"][k],
                                   rtol=FIT_RTOL, atol=atol, err_msg=k)
    assert sorted(g["budgets"]) == pytest.approx(sorted(w["budgets"]),
                                                 rel=RTOL)
    for (bias, gb), wb in zip(sorted(g["budgets"].items()),
                              [w["budgets"][b] for b in sorted(w["budgets"])]):
        for key in ("s_ites", "s_iload", "s_itfn", "s_isquid", "s_itot",
                    "s_pitot" if "s_pitot" in wb else "s_ptot", "s_imeas"):
            np.testing.assert_allclose(gb[key], wb[key], rtol=FIT_RTOL,
                                       err_msg=key)
    assert [b is None for b in got["ana"]._sweep_df[CHAN]["noise_budget"]] \
        == [b is None for b in want["ana"]._sweep_df[CHAN]["noise_budget"]]


def test_energy_resolution_matches_jax(analysed):
    got, want = analysed
    _assert_column(got["sigma"], want["sigma"], "energy_resolution",
                   FIT_RTOL)
    sig = got["sigma"]["energy_resolution"]
    trans = np.asarray(got["sigma"]["state"]) == "transition"
    assert np.isfinite(sig[trans]).all() and (sig[trans] > 0).all()
    assert np.isnan(sig[~trans]).all()
    res = got["ana"].get_resolution_data(CHAN)
    assert len(res) == 2
    assert got["ana"].get_didv_summary(CHAN) is got["didv_results"]
    objs = got["ana"].get_didv_objects(CHAN)
    assert len(objs) == 8


def test_autocuts_rejected_all(tmp_path):
    nan = np.full((4, 1, 1024), np.nan)
    w = RawWriter(str(tmp_path), "I1_D20260819_T230000", FS, [CHAN],
                  prefix="iv", data_type="noise")
    bps = [{"tes_bias": 1e-4, "noise_files": [w.write_dump(nan)]}]
    for proc in (ivsweep.IVSweepProcessing(verbose=False, device="cpu"),
                 jivsweep.IVSweepProcessing(verbose=False)):
        with pytest.raises(ValueError, match="autocuts rejected all 4"):
            proc.process(CHAN, bps)


def test_discover_bias_points(sweep):
    root, bps = sweep
    got = ivsweep.discover_bias_points(str(root), CHAN)
    want = jivsweep.discover_bias_points(str(root), CHAN)
    assert got == want
    assert [p["tes_bias"] for p in got] == [p["tes_bias"] for p in bps]


def test_ties_in_bias_keep_their_order():
    """pandas promises no order for equal |tes_bias|; the port keeps the
    rows of a tie in their incoming order (a stable sort)."""
    rng = np.random.default_rng(0)
    bias = np.array([1e-4, 4e-4, -4e-4, 3e-4, -1e-4, 2e-4, 5e-6, -5e-6, 1e-6])
    table = Table({"tes_bias": bias,
                   "offset_noise": bias * 0.016 + rng.normal(0, 1e-9, 9),
                   "offset_noise_err": np.full(9, 1e-9),
                   "state": np.array(["transition"] * 9, dtype=object)})
    ana = ivsweep.IVSweepAnalysis(verbose=False)
    ana.set_data_from_dataframe(CHAN, table, rsh=RSH)
    ana.set_nb_sc_normal_points(CHAN, nnorm=3, nsc=3)
    out = ana.analyze_sweep(CHAN, rp=entry.IV_RP)
    np.testing.assert_array_equal(
        out["tes_bias"], [4e-4, -4e-4, 3e-4, 2e-4, 1e-4, -1e-4, 5e-6, -5e-6,
                          1e-6])
    # four copies of the sweep: ties of 8 equal |bias| still keep their
    # incoming order (pandas' quicksort scrambles these, ROADMAP §3)
    big = Table({k: np.tile(v, 4) for k, v in table.items()})
    big["row"] = np.arange(36)
    ana.set_data_from_dataframe(CHAN, big, rsh=RSH)
    out = ana.analyze_sweep(CHAN, rp=entry.IV_RP)
    np.testing.assert_array_equal(
        out["row"], np.argsort(-np.abs(big["tes_bias"]), kind="stable"))
    for b in (4e-4, -4e-4):
        rows = out["row"][out["tes_bias"] == b]
        assert (np.diff(rows) > 0).all()


def test_table_helpers_and_setters(processed):
    got, _, proc = processed
    sub = ivsweep.table_rows(got, [2, 0])
    assert ivsweep.table_len(sub) == 2
    assert sub["tes_bias"][0] == got["tes_bias"][2]
    assert sub["psd"][1] is got["psd"][0]
    ana = ivsweep.IVSweepAnalysis(verbose=False)
    ana.set_data_from_processing(CHAN, proc, rsh=RSH)
    ana.set_rshunt([CHAN], rshunt=RSH, rshunt_err=1e-4)
    with pytest.raises(ValueError, match="length = # channels"):
        ana.set_rshunt([CHAN], rshunt=[1e-3, 2e-3])
    ana.set_rp(CHAN, rp=entry.IV_RP)
    ana.set_nb_sc_normal_points(CHAN, nnorm=3, nsc=0)
    ana.analyze_sweep(CHAN)
    assert ana.get_ibis(CHAN).rp == entry.IV_RP
    assert ana.get_ibis_qetpy_object("nope") is None
    with pytest.raises(ValueError, match="tc/tbath"):
        ana.analyze_noise(CHAN)
    ana.clear(CHAN)
    assert CHAN not in ana._sweep_df and ana.get_didv_summary(CHAN) is None
