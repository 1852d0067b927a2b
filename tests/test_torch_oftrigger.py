"""The port's OptimumFilterTrigger object against the JAX package's.

Follows tests/test_oftrigger_object.py: a 1x1 trigger (Nt 1024,
pretrigger 256, flat PSD) on a 50,000-sample trace with pulses, and a
two-channel NxM one. The JAX object filters in float32 (it casts the trace
and builds its kernel in float32); here it runs in float64 instead (its
kernel rebuilt with ``real_dtype=np.float64`` and its float32 cast made a
float64 one), so that the port's float64 CPU object is held to it at
1e-9:

- ``update_trace(trace)``: filtered traces, Δχ² and the 50 kHz low-pass
  at 1e-9 of each series' largest |value|;
- triggers from ``update_trace(trace)``: the same indices, values at
  1e-9;
- triggers from identical host inputs (``update_trace(trace,
  filtered_trace)`` with the JAX object's filtered trace): the trigger
  dicts exactly equal, with the residual pass, the saturation veto, the
  edge exclusion and livetime, and ``return_trigger_data``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detprocess_tpu.models import pulse
from detprocess_tpu.ops import trigger as jtrig
from detprocess_tpu.pipelines import oftrigger as joft
from detprocess_tpu.pipelines.triggers import EventBuilder as JaxBuilder
from detprocess_tpu_torch.io import tables
from detprocess_tpu_torch.pipelines import oftrigger as toft
from detprocess_tpu_torch.pipelines.triggers import EventBuilder

torch.set_num_threads(1)

FS = 1.25e6
NT = 1024
PRETRIG = 256
L = 50000
TOL = 1e-9


class _Float64Jnp:
    """``jax.numpy`` with ``float32`` standing for ``float64``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@pytest.fixture
def jax64(monkeypatch):
    """Make JAX OptimumFilterTrigger objects filter in float64."""
    assert jax.config.jax_enable_x64
    monkeypatch.setattr(joft, "jnp", _Float64Jnp())

    def make(*args, **kw):
        obj = joft.OptimumFilterTrigger(*args, **kw)
        obj._kernel = jtrig.make_trigger_kernel(obj._bank,
                                                real_dtype=np.float64)
        step = obj._device_step
        # writable host copies: a float64 result would come back as a
        # read-only view, where the float32 one is copied by its cast
        obj._device_step = lambda n: (
            lambda t: tuple(np.array(a) for a in step(n)(t)))
        return obj
    return make


def _template():
    return pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)


PSD = np.full(NT, 4e-18)


def _trace(seed, pulses):
    rng = np.random.default_rng(seed)
    trace = rng.standard_normal(L) * np.sqrt(PSD[0] * FS)
    tmpl = _template()
    for pos, amp in pulses:
        trace[pos - PRETRIG:pos - PRETRIG + NT] += amp * tmpl
    return trace


def _nxm():
    t1 = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                             tau_f1=200e-6)
    t2 = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=30e-6,
                             tau_f1=300e-6)
    tmpl = np.stack([t1[None, :], 0.8 * t2[None, :]], axis=0)   # [2, 1, N]
    csd = np.zeros((2, 2, NT), complex)
    csd[0, 0] = 4e-18
    csd[1, 1] = 6e-18
    rng = np.random.default_rng(5)
    n = 60000
    trace = np.stack([rng.standard_normal(n) * np.sqrt(4e-18 * FS),
                      rng.standard_normal(n) * np.sqrt(6e-18 * FS)])
    for p, a in [(20000, 8e-6), (45000, 6e-6)]:
        trace[0, p - PRETRIG:p - PRETRIG + NT] += a * t1
        trace[1, p - PRETRIG:p - PRETRIG + NT] += 0.8 * a * t2
    return tmpl, csd, trace


def _pair(jax64, case):
    """(JAX object, port object, trace) of ``case``."""
    if case == "nxm":
        tmpl, csd, trace = _nxm()
        args = (["chA", "chB"], FS, tmpl, csd, PRETRIG)
    else:
        tmpl, csd = _template(), PSD.astype(complex)
        trace = _trace(3, [(12000, 4e-6), (30000, 2e-6), (40000, 60e-6),
                           (40150, 5e-6)])
        args = ("chan1", FS, tmpl, csd, PRETRIG)
    return (jax64(*args),
            toft.OptimumFilterTrigger(*args, device="cpu",
                                      dtype=torch.float64), trace)


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("case", ["1x1", "nxm"])
def test_filtered_traces_match_jax(jax64, case):
    jobj, tobj, trace = _pair(jax64, case)
    for padding in (True, False):
        jobj.update_trace(trace=trace, padding=padding)
        tobj.update_trace(trace=trace, padding=padding)
        _close(tobj.get_filtered_trace(), jobj.get_filtered_trace(),
               f"filtered trace {case}")
        _close(tobj.get_filtered_delta_chi2(),
               jobj.get_filtered_delta_chi2(), f"Δχ² {case}")
        _close(tobj._raw_trace_lpf_50khz, jobj._raw_trace_lpf_50khz,
               f"low-pass {case}")
    assert tobj.get_filtered_trace().shape == jobj.get_filtered_trace().shape
    np.testing.assert_allclose(tobj.get_phi(), jobj.get_phi(), rtol=0,
                               atol=1e-12 * np.abs(jobj.get_phi()).max())
    assert tobj.get_norm() == pytest.approx(jobj.get_norm(), rel=1e-12)
    np.testing.assert_allclose(tobj.get_resolution(),
                               jobj.get_resolution(), rtol=1e-12)


@pytest.mark.parametrize("case,kw", [
    ("1x1", dict(pileup_window_msec=0.5)),
    ("1x1", dict(pileup_window_samples=400, residual=True)),
    ("nxm", dict(pileup_window_msec=0.5, residual=True,
                 saturation_amplitudes_LPF_50kHz=[1e-3, 1e-3])),
])
def test_triggers_from_traces_match_jax(jax64, case, kw):
    jobj, tobj, trace = _pair(jax64, case)
    for obj in (jobj, tobj):
        obj.update_trace(trace=trace)
        obj.find_triggers(5.0, **kw)
    want = jobj.get_trigger_data()
    got = tobj.get_trigger_data()
    assert list(got) == list(want)
    for name in want:
        assert list(got[name]) == list(want[name])
        for key, w in want[name].items():
            g = got[name][key]
            if "delta_chi2" in key or "amplitude" in key:
                _close(np.asarray(g, float), np.asarray(w, float), key)
            else:
                assert g == w, key
    assert len(want[tobj._trigger_name]["trigger_index"]) >= 2


@pytest.mark.parametrize("case,kw", [
    ("1x1", dict(pileup_window_msec=0.5)),
    ("1x1", dict(pileup_window_samples=400, residual=True)),
    ("1x1", dict(pileup_window_samples=400, residual=True,
                 saturation_amplitudes_LPF_50kHz=[10e-6])),
    ("1x1", dict(pileup_window_msec=0.5, residual=True,
                 edge_exclusion_msec=12.0, livetime=3.5)),
    ("1x1", dict(pileup_window_msec=0.5, positive_pulses=False,
                 residual=True, saturation_amplitudes_LPF_50kHz=[1e-9])),
    ("nxm", dict(pileup_window_msec=0.5, residual=True,
                 saturation_amplitudes_LPF_50kHz=[1e-3, 1e-3],
                 edge_exclusion_msec=1.0)),
])
def test_trigger_dicts_exact(jax64, case, kw):
    jobj, tobj, trace = _pair(jax64, case)
    jobj.update_trace(trace=trace)
    filt = jobj.get_filtered_trace()
    outs = []
    for obj in (jobj, tobj):
        obj.update_trace(trace=trace, filtered_trace=filt)
        ret = obj.find_triggers(5.0, return_trigger_data=True, **kw)
        outs.append((obj.get_trigger_data(), obj.get_chi2_threshold(), ret))
    (want, wthr, wret), (got, gthr, gret) = outs
    assert got == want
    # the port solves the χ² quantile by bisection, JAX with scipy
    assert gthr == pytest.approx(wthr, rel=1e-14)
    if kw.get("residual"):
        assert gret[0] == wret[0] and gret[2] == wret[2]
        np.testing.assert_array_equal(gret[1], wret[1])
        np.testing.assert_array_equal(gret[3], wret[3])
        np.testing.assert_array_equal(tobj.get_filtered_delta_chi2(),
                                      jobj.get_filtered_delta_chi2())
    table = tobj.get_trigger_data_df()
    assert list(table) == list(jobj.get_trigger_data_df().columns)


@pytest.mark.parametrize("window_fn,kw,ntrig", [
    (lambda d: 1e9, {}, 1),
    (lambda d: 2000.0, {}, 3),
    (lambda d: 20000.0 if d > 1e4 else 400.0, {}, 3),
    (lambda d: 20000.0 if d > 1e4 else 400.0,
     dict(residual=True, saturation_amplitudes_LPF_50kHz=[10e-6]), 3),
])
def test_dynamic_triggers_match_jax(jax64, window_fn, kw, ntrig):
    """``dynamic=True`` with Python window functions, as
    tests/test_oftrigger_object.py:162 drives it: the trigger dicts from
    identical filtered traces exactly equal, and from the trace itself
    the same indices with values at 1e-9."""
    jobj, tobj, trace = _pair(jax64, "1x1")
    jobj.update_trace(trace=trace)
    filt = jobj.get_filtered_trace()
    for filtered in (filt, None):
        out = []
        for obj in (jobj, tobj):
            obj.update_trace(trace=trace, filtered_trace=filtered)
            obj.find_triggers(5.0, pileup_window_msec=0.5, dynamic=True,
                              dynamic_threshold_function=window_fn, **kw)
            out.append(obj.get_trigger_data()["chan1"])
        want, got = out
        if filtered is not None:
            assert got == want
            continue
        assert got["trigger_index"] == want["trigger_index"]
        for key in ("trigger_delta_chi2", "trigger_amplitude"):
            _close(np.asarray(got[key]), want[key], key)
    assert len(want["trigger_index"]) == ntrig


def test_residual_pass_finds_the_hidden_pulse(jax64):
    """A 5 µA pulse 150 samples after a 60 µA one: one first-pass
    trigger, and the residual pass reveals the second."""
    _, tobj, trace = _pair(jax64, "1x1")
    tobj.update_trace(trace=trace)
    first, first_dchi2, _, _ = tobj.find_triggers(
        5.0, pileup_window_samples=400, residual=True,
        return_trigger_data=True)
    idx = np.asarray(tobj.get_trigger_data()["chan1"]["trigger_index"])
    assert len(idx) > len(first["chan1"]["trigger_index"])
    assert np.any(np.abs(idx - 40150) <= 64)
    assert len(set(idx.tolist())) == len(idx)
    np.testing.assert_array_equal(tobj.get_filtered_delta_chi2(),
                                  first_dchi2)


def test_eventbuilder_drives_the_object(jax64):
    """EventBuilder.acquire_triggers with the object protocol, then
    build_event: the same event table as JAX's pair."""
    jobj, tobj, trace = _pair(jax64, "1x1")
    jb, tb = JaxBuilder(), EventBuilder()
    jb.add_trigger_object("chan1", jobj)
    tb.add_trigger_object("chan1", tobj)
    want = jb.acquire_triggers("chan1", trace, 5.0, pileup_window_msec=0.5)
    got = tb.acquire_triggers("chan1", trace, 5.0, pileup_window_msec=0.5)
    np.testing.assert_array_equal(got["trigger_index"],
                                  want["trigger_index"])
    meta = {"event_time": 0.0, "series_number": 1}
    want = jb.build_event(dict(meta), fs=FS)
    got = tables.to_dataframe(tb.build_event(dict(meta), fs=FS))
    assert list(got.columns) == list(want.columns)
    for col in want.columns:
        if "delta_chi2" in col or "amplitude" in col:
            _close(got[col].to_numpy(float), want[col].to_numpy(float), col)
        else:
            np.testing.assert_array_equal(got[col], want[col])
    with pytest.raises(ValueError, match="already stored"):
        tb.add_trigger_object("chan1", tobj)


def test_combine_trigger_data_matches_jax():
    a = {"c": {"trigger_index": [5], "only_first": ["x"],
               "trigger_index_c": [5]}}
    b = {"c": {"trigger_index": [5, 14], "only_second": ["p", "q"],
               "trigger_index_c": [5, 14]}}
    got = toft.combine_trigger_data(a, b, [5], [5, 14])
    assert got == joft.combine_trigger_data(a, b, [5], [5, 14])
    assert got["c"]["only_first"] == ["x", None]
    assert got["c"]["trigger_index_c"] == [5, 14]


def test_empty_result_refusals_and_shapes(jax64):
    _, tobj, _ = _pair(jax64, "1x1")
    quiet = np.random.default_rng(21).standard_normal(8192) * np.sqrt(
        PSD[0] * FS)
    tobj.update_trace(trace=quiet)
    tobj.find_triggers(5.0, pileup_window_msec=0.1)
    table = tobj.get_trigger_data_df()
    assert len(table["trigger_index"]) == 0 and "trigger_channel" in table
    with pytest.raises(ValueError, match="dynamic_threshold_function"):
        tobj.find_triggers(5.0, dynamic=True)
    with pytest.raises(ValueError, match="required"):
        tobj.update_trace()
    with pytest.raises(ValueError, match="channel"):
        tobj.update_trace(trace=np.zeros((2, 100)))
    with pytest.raises(ValueError, match="ambiguous"):
        toft.OptimumFilterTrigger("c", FS, np.ones((4, 7)),
                                  PSD.astype(complex), PRETRIG, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        toft.OptimumFilterTrigger("c", FS, _template(), PSD.astype(complex),
                                  PRETRIG)
    # a filtered trace without its raw trace leaves no stale low-pass
    tobj.update_trace(filtered_trace=tobj.get_filtered_trace())
    assert tobj._raw_trace_lpf_50khz is None
    assert not tobj._is_saturated(1000, [1e-12], True)
