"""The direct windowed delay fits: the port against the JAX package.

- ``of1x1.prepare_delay_window`` equals JAX's exactly (one run, two runs,
  a window wrapping mod N, a single sample; with and without bin weights);
- ``of1x1.of1x1_windowed_direct_half`` (with and without
  ``interpolate_t0`` and ``low_mask_h``), ``ofnxm.ofnxm_withdelay_direct``,
  ``ofnxm.ofnxm_withdelay_direct_half`` and the NxMx2 fits' direct union
  hold to the JAX functions at 1e-9 in float64 on seeded inputs, and each
  direct form to the port's irfft route at 1e-9;
- the feature plan's route choice (``feature_plan.direct_windows``) picks
  the specs JAX's shell puts in ``group.direct_windows``, at JAX's 1024;
- a shell run with the constants set so that every narrow window takes
  the direct route equals one where none does, at 1e-9 in float64.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import trigger_cases as tc
from detprocess_tpu.io.rawdata import RawWriter
from detprocess_tpu.models import pulse as jpulse
from detprocess_tpu.ops import filterbank as jfb
from detprocess_tpu.ops import of1x1 as jof
from detprocess_tpu.ops import ofnxm as jnxm
from detprocess_tpu.pipelines.features import FeatureProcessing as JaxFP
from detprocess_tpu_torch import entry
from detprocess_tpu_torch.ops import fft as tfft
from detprocess_tpu_torch.ops import filterbank as tfb
from detprocess_tpu_torch.ops import of1x1 as tof
from detprocess_tpu_torch.ops import ofnxm as tnxm
from detprocess_tpu_torch.pipelines import feature_plan as fplan
from detprocess_tpu_torch.pipelines.features import FeatureProcessing

torch.set_num_threads(1)

FS = 1.25e6
N = 2048
PRETRIG = 512
NB = 8
RTOL = 1e-9
JAX_WINDOW_MAX = 1024       # JAX features.DIRECT_WINDOW_MAX


def _mask(*runs, n=N):
    m = np.zeros(n, bool)
    for lo, hi in runs:
        m[np.arange(lo, hi + 1) % n] = True
    return m


WINDOWS = {
    "one run": _mask((PRETRIG - 62, PRETRIG + 62)),
    "two runs": _mask((PRETRIG - 40, PRETRIG - 10), (PRETRIG + 20, PRETRIG
                                                     + 90)),
    "wraps": _mask((N - 30, N + 25)),
    "one sample": _mask((PRETRIG + 3, PRETRIG + 3)),
}


@pytest.mark.parametrize("name", sorted(WINDOWS))
@pytest.mark.parametrize("weighted", [True, False])
def test_prepare_delay_window_matches_jax(name, weighted):
    bin_w = jfb.half_bin_weights(N) if weighted else None
    pre = PRETRIG - 7
    got = tof.prepare_delay_window(WINDOWS[name], pre, N, bin_w)
    want = jof.prepare_delay_window(WINDOWS[name], pre, N, bin_w)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _psd(n, white=1e-20, knee=100.0):
    f = np.abs(np.fft.fftfreq(n, 1 / FS))
    f[0] = f[1]
    return white * (1.0 + knee / f)


@pytest.fixture(scope="module")
def setup():
    """Two-slot bank, traces with pulses near the pretrigger, both sides'
    half spectra."""
    rng = np.random.default_rng(13)
    t1 = jpulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=20e-6,
                              tau_f1=200e-6)
    t2 = jpulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=12e-6,
                              tau_f1=90e-6)
    bank = jfb.make_of1x1_bank(np.stack([t1, t2]),
                               np.stack([_psd(N), _psd(N, 3e-20, 20.0)]),
                               FS, PRETRIG)
    traces = rng.standard_normal((NB, N)) * 1e-8
    traces += rng.uniform(1e-6, 3e-6, NB)[:, None] * np.stack(
        [np.roll(t1, s) for s in rng.integers(-50, 50, NB)])
    bh = jfb.device_bank_1x1_half(
        {k: jnp.asarray(v) for k, v in bank.to_device(np.float64).items()})
    tb = tfb.bank_from_jax(bank.to_device(np.float64), "cpu", torch.float64)
    vr_j = jof.signal_rfft(jnp.asarray(traces)[:, None, :])
    vr_t = tfft.rfft(torch.as_tensor(traces))[:, None, :]
    return bh, tb, vr_j, vr_t


def _close(got, want, what, t0=False):
    got, want = got.numpy(), np.asarray(want)
    if t0:
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-15,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("name", sorted(WINDOWS))
@pytest.mark.parametrize("interp", [False, True])
@pytest.mark.parametrize("fcut", [None, 20000.0])
def test_windowed_direct_half_matches_jax(setup, name, interp, fcut):
    bh, tb, vr_j, vr_t = setup
    pre = PRETRIG - 5
    wmask = WINDOWS[name]
    low = None if fcut is None else tof.lowfreq_mask_half(N, FS, fcut)
    tabs = jof.prepare_delay_window(wmask, pre, N, jfb.half_bin_weights(N))
    want = jof.of1x1_windowed_direct_half(
        vr_j, bh.phi, bh.norm, bh.denom_inv, bh.s_fft, bh.bin_w, pre, FS,
        *tabs, low_mask_h=None if low is None else jnp.asarray(low),
        interpolate_t0=interp, n=N)
    eidx, valid, cos_m, sin_m = tof.prepare_delay_window(
        wmask, pre, N, tb["bin_w"].numpy())
    args = (vr_t, tb["phi_h"], tb["norm"], tb["denom_inv_h"], tb["s_fft_h"],
            tb["bin_w"], pre, FS)
    kw = dict(low_mask_h=low, interpolate_t0=interp, n=N)
    got = tof.of1x1_windowed_direct_half(*args, eidx, valid, cos_m, sin_m,
                                         **kw)
    # the one-GEMM table form gives the same fit
    one = tof.of1x1_windowed_direct_half(
        *args, torch.as_tensor(eidx), torch.as_tensor(valid),
        tof.direct_table(cos_m, sin_m, "cpu", torch.float64), **kw)
    irfft = tof.of1x1_withdelay_half(*args, window_mask=wmask, **kw)
    for ref in (want, one, irfft):
        for field in ("amp", "chi2", "lowchi2", "chi2_nopulse"):
            _close(getattr(got, field), getattr(ref, field), field)
        if interp:
            _close(got.t0, ref.t0, "t0", t0=True)
        else:
            np.testing.assert_array_equal(got.t0.numpy(), np.asarray(ref.t0))


def _nxm_case(kind, n=4096, pretrig=1024, nb=4):
    rng = np.random.default_rng(41 if kind == "1x1" else 42)
    tm = tc.templates(n, pretrig, kind)
    bank = tc.bank(n, pretrig, kind)
    c, m = tm.shape[:2]
    x = tc.noise(rng, nb, c, n, kind)
    for e in range(nb):
        amps = rng.uniform(20, 60, m) * np.sqrt(np.diag(bank.iw_matrix))
        x[e] += np.roll(np.einsum("cmn,m->cn", tm, amps),
                        int(rng.integers(-40, 40)), axis=-1)
    dev = {k: jnp.asarray(v) for k, v in bank.to_device(np.float64).items()}
    jb = jfb.device_bank_nxm(dev)
    tb = tfb.bank_nxm_to_torch(tfb.bank_nxm_from_jax(bank), "cpu",
                               torch.float64)
    return dict(bank=bank, jb=jb, tb=tb, vfft=jof.signal_fft(jnp.asarray(x)),
                vr=tfft.rfft(torch.as_tensor(x)), n=n, pretrig=pretrig)


@pytest.fixture(scope="module", params=["1x1", "2x2"])
def nxm(request):
    return _nxm_case(request.param)


@pytest.mark.parametrize("runs", [[(-62, 62)], [(-30, -5), (10, 70)],
                                  [(0, 0)]])
@pytest.mark.parametrize("interp", [False, True])
def test_ofnxm_direct_matches_jax(nxm, runs, interp):
    jb, tb, n = nxm["jb"], nxm["tb"], nxm["n"]
    pre = nxm["pretrig"] - 24
    wmask = _mask(*[(pre + lo, pre + hi) for lo, hi in runs], n=n)
    want = jnxm.ofnxm_withdelay_direct(
        nxm["vfft"], jb.phi, jb.w_matrix, jb.iw_matrix, jb.icsd, pre, FS,
        *jof.prepare_delay_window(wmask, pre, n), interpolate_t0=interp)
    vfft = torch.as_tensor(np.asarray(nxm["vfft"]))
    full = tnxm.ofnxm_withdelay_direct(
        vfft, torch.as_tensor(np.asarray(jb.phi)), None,
        torch.as_tensor(np.asarray(jb.iw_matrix)),
        torch.as_tensor(np.asarray(jb.icsd)), pre, FS,
        *tof.prepare_delay_window(wmask, pre, n), interpolate_t0=interp)
    eidx, valid, cos_m, sin_m = tof.prepare_delay_window(
        wmask, pre, n, tb["bin_w"].numpy())
    half_args = (nxm["vr"], tb["phi_h"], tb["iw_matrix"], tb["icsd_h"],
                 tb["bin_w"], pre, FS, n)
    half = tnxm.ofnxm_withdelay_direct_half(
        *half_args, eidx, valid,
        tof.direct_table(cos_m, sin_m, "cpu", torch.float64),
        interpolate_t0=interp)
    irfft = tnxm.ofnxm_withdelay_half(*half_args, window_mask=wmask,
                                      interpolate_t0=interp)
    for got in (full, half):
        for ref in (want, irfft):
            _close(got.amps, ref.amps, "amps")
            _close(got.chi2, ref.chi2, "chi2")
            if interp:
                _close(got.t0, ref.t0, "t0", t0=True)
            else:
                np.testing.assert_array_equal(got.t0.numpy(),
                                              np.asarray(ref.t0))


UNION_WINDOWS = [((-30, 30), (-10, 60)), ((-3, 4), (-80, 200)),
                 ((40, 41), (-5, 5)), ((-250, -200), (100, 300))]


@pytest.mark.parametrize("w1,w2", UNION_WINDOWS)
def test_ofnxmx2_direct_union_matches_jax(w1, w2):
    case = _nxm_case("2x2")             # NxMx2 needs two templates
    jb, tb, n = case["jb"], case["tb"], case["n"]
    pre = case["pretrig"] + 7
    gids = np.array([0, 1])
    m1 = _mask((pre + w1[0], pre + w1[1]), n=n)
    m2 = _mask((pre + w2[0], pre + w2[1]), n=n)
    assert len(np.union1d(np.flatnonzero(m1), np.flatnonzero(m2))) \
        <= jnxm.DIRECT_UNION_MAX    # JAX's direct union
    (want, _) = jnxm.ofnxmx2(case["vfft"], jb.s_fft, jb.icsd, gids, m1, m2,
                             pre, FS)
    plan = tnxm.nxmx2_plan(tfb.bank_nxm_from_jax(case["bank"]), gids, m1, m2)
    bin_w = tb["bin_w"].numpy()
    direct = tnxm.nxmx2_tensors(plan, "cpu", torch.float64, pre, n, bin_w,
                                direct=True)
    assert "union" in direct
    irfft = tnxm.nxmx2_tensors(plan, "cpu", torch.float64, pre, n, bin_w,
                               direct=False)
    assert "union" not in irfft
    args = (case["vr"], tb["phi_h"], tb["icsd_h"], tb["bin_w"])
    got = tnxm.ofnxmx2_half(*args, direct, pre, FS, n)
    refs = [want, tnxm.ofnxmx2_half(*args, irfft, pre, FS, n)]
    (full, _) = tnxm.ofnxmx2(
        torch.as_tensor(np.asarray(case["vfft"])),
        torch.as_tensor(np.asarray(jb.s_fft)),
        torch.as_tensor(np.asarray(jb.icsd)), gids, m1, m2, pre, FS)
    for g in (got, full):
        for ref in refs:
            _close(g.amps, ref.amps, "amps")
            _close(g.chi2, ref.chi2, "chi2")
            np.testing.assert_array_equal(g.deltat.numpy(),
                                          np.asarray(ref.deltat))


# -- the route choice and the shell ------------------------------------------

PLAN_N, PLAN_PRE = 4096, 2048
NARROW = {"run": True, "window_min_from_trig_usec": -40.0,
          "window_max_from_trig_usec": 40.0}
WIDE = {"run": True, "base_algorithm": "of1x1_constrained",
        "window_min_from_trig_usec": -1200.0,
        "window_max_from_trig_usec": 1200.0}


def _plan_configs():
    cov = entry.coverage_config(PLAN_N, PLAN_PRE)
    shell = entry.shell_config(PLAN_N, PLAN_PRE)

    def chan1(specs):
        return {"feature": {"trace_length_samples": PLAN_N,
                            "pretrigger_length_samples": PLAN_PRE,
                            "chan1": specs}}

    return {
        "coverage (i)": cov,
        "shell (g)": shell,
        "constrained only": chan1({"of1x1_constrained": dict(NARROW)}),
        "shared slot": chan1({"of1x1_unconstrained": {"run": True},
                              "of1x1_constrained": dict(NARROW)}),
        "wide on the slot": chan1({"of1x1_wide": dict(WIDE),
                                   "of1x1_constrained": dict(NARROW)}),
        "another slot": chan1({"of1x1_unconstrained": {
            "run": True, "template_tag": "Scintillation"},
            "of1x1_constrained": dict(NARROW)}),
        "outside the window": chan1({"of1x1_constrained": {
            **NARROW, "lgc_outside_window": True}}),
    }


@pytest.fixture(scope="module")
def plan_inputs(tmp_path_factory):
    """A one-event JAX raw file of the four shell channels and the
    coverage filter file, for both shells."""
    root = tmp_path_factory.mktemp("direct_plan")
    w = RawWriter(str(root / "raw"), "I1_D20260901_T120000", FS,
                  list(entry.SHELL_CHANNELS), nb_pretrigger_samples=PLAN_PRE)
    w.write_dump(np.zeros((1, len(entry.SHELL_CHANNELS), PLAN_N)),
                 dump_num=1)
    raw = sorted(str(p) for p in (root / "raw").glob("*.hdf5"))
    fd = entry.coverage_filter_data(PLAN_N, PLAN_PRE)
    fpath = str(root / "filter.h5")
    fd.save_hdf5(fpath)
    return root, raw, fd, fpath


def _direct_specs(groups, picks):
    return sorted((s.algorithm, s.channel)
                  for g, keys in zip(groups, picks)
                  for i, s in enumerate(g.specs) if i in keys)


@pytest.mark.parametrize("name", sorted(_plan_configs()))
def test_route_choice_matches_jax(plan_inputs, name):
    root, raw, fd, fpath = plan_inputs
    cfg = _plan_configs()[name]
    cpath = str(root / f"{name.replace(' ', '_')}.yaml")
    with open(cpath, "w") as f:
        yaml.safe_dump(cfg, f)
    jax_shell = JaxFP(raw, cpath, filter_data=fpath, verbose=False)
    want = _direct_specs(jax_shell._groups,
                         [g.direct_windows for g in jax_shell._groups])
    port = FeatureProcessing(raw, cfg, fd, verbose=False, device="cpu")
    groups = port._plan.groups
    got = _direct_specs(groups, [fplan.direct_windows(g, FS,
                                                      JAX_WINDOW_MAX)
                                 for g in groups])
    assert got == want
    # the windows of the two constrained-only configs are direct in JAX
    if name in ("constrained only", "another slot", "coverage (i)"):
        assert want


@pytest.fixture(scope="module")
def coverage_events(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("direct_shell"))
    paths, _ = entry.write_coverage_dumps(
        root, torch.Generator().manual_seed(3), 6, 1, "cpu", n=PLAN_N,
        pretrig=PLAN_PRE)
    return entry.coverage_index(paths, PLAN_N, PLAN_PRE)


def _coverage_table(index, constrained_only=False):
    cfg = entry.coverage_config(PLAN_N, PLAN_PRE)
    if constrained_only:
        cfg["feature"]["chan3"] = {
            "of1x1_constrained": dict(NARROW),
            "of1x1_interp": {**NARROW, "base_algorithm":
                             "of1x1_constrained", "interpolate": True}}
    shell = FeatureProcessing(index, cfg,
                              entry.coverage_filter_data(PLAN_N, PLAN_PRE),
                              verbose=False, device="cpu")
    steps = shell.group_steps(torch.float64)
    table = shell.process(batch_size=4, dtype=np.float64)
    return table, steps


@pytest.mark.parametrize("extra", [False, True])
def test_shell_direct_route_equals_irfft_route(monkeypatch, coverage_events,
                                               extra):
    """With the port's constants above every window the shell takes the
    direct route for ofnxm, the NxMx2 union and (with ``extra``) chan3's
    constrained-only fits; at 0 it takes none. The tables agree at 1e-9
    (t0 the same sample)."""
    monkeypatch.setattr(fplan, "DIRECT_WINDOW_MAX", 4096)
    monkeypatch.setattr(tnxm, "DIRECT_UNION_MAX", 4096)
    direct, steps = _coverage_table(coverage_events, extra)
    assert all(st.direct for st in steps)
    assert all("union" in c for st in steps for c in st.nxmx2.values())
    monkeypatch.setattr(fplan, "DIRECT_WINDOW_MAX", 0)
    monkeypatch.setattr(tnxm, "DIRECT_UNION_MAX", 0)
    irfft, steps = _coverage_table(coverage_events, extra)
    assert not any(st.direct for st in steps)
    assert not any("union" in c for st in steps for c in st.nxmx2.values())
    assert list(direct) == list(irfft)
    for key, v in irfft.items():
        if np.asarray(v).dtype.kind != "f":
            np.testing.assert_array_equal(direct[key], v, err_msg=key)
        elif key.startswith("t0_") or key.startswith("delta_t_"):
            np.testing.assert_allclose(direct[key], v, rtol=1e-9,
                                       atol=1e-15, err_msg=key)
        else:
            np.testing.assert_allclose(direct[key], v, rtol=RTOL, atol=0,
                                       err_msg=key)
