"""The port's continuous-data trigger step equals the JAX package's ops
composed as ``TriggerProcessing._make_channel_fn.run_one`` composes them
(pipelines/triggers.py:624-655, the tiled branch), in float64 on the CPU.

E = 2 events of L = 65536 samples, Nt = 512, pileup window 100 samples,
base and residual mode, on tests/trigger_cases.py's banks: one channel,
and two channels × two templates with a phase-correlated (off-diagonal,
frequency-dependent phase) CSD. Each event holds pulses at 8–40
resolution σ, a pileup pair (a 12σ pulse 150 samples after a 200σ one,
inside its Δχ² group), and one pulse that saturates the low-passed trace
(the veto keeps it from being subtracted, so the residual pass finds it
again). Indices and counts exactly, Δχ² and amplitudes at 1e-9.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import trigger_cases as cases
from detprocess_tpu.ops import spectral as jspec
from detprocess_tpu.ops import trigger as jtrig
from detprocess_tpu_torch.ops import filterbank as tfb
from detprocess_tpu_torch.ops import trigger as ttrig
from detprocess_tpu_torch.pipelines.trigger_step import LAYERS, TriggerStep

torch.set_num_threads(1)

FS = cases.FS
E, L, NT, PRETRIG = 2, 65536, 512, 128
WINDOW, SIGMA, CAP = 100, 5.0, 64
RTOL = 1e-9


def jax_run_one(kernel, basis, thr, window, cap, sat_amps, positive,
                run_residual):
    """run_one of pipelines/triggers.py:632-655 with its saturation()
    (:624-630), as one jitted function of a trace [C, L]."""
    iw = jnp.asarray(kernel.iw_matrix)

    def run(trace):
        q_blocks, _ = jtrig.of_fir_blocks(trace, kernel)
        dchi2_b = jtrig.delta_chi2_from_q(q_blocks, iw)
        ts = jtrig.find_triggers_tiled(dchi2_b, q_blocks, thr, window, cap,
                                       amps_transform=iw)
        if not run_residual:
            return ts, None
        sat = None
        if sat_amps is not None:
            lpf = jspec.lowpass_filter(trace, 50e3, kernel.fs)
            sat = jtrig.saturation_mask(lpf, sat_amps, kernel.nt // 4,
                                        positive_pulses=positive)
        resid_b = jtrig.residual_subtract_conv(dchi2_b, ts, kernel, basis,
                                               sat)
        ts2 = jtrig.find_triggers_tiled(resid_b, q_blocks, thr, window, cap,
                                        amps_transform=iw)
        return ts, ts2

    return jax.jit(run)


def _events(case, bank, sign):
    rng = np.random.default_rng(5)
    tm = cases.templates(NT, PRETRIG, case)
    nchan, m = tm.shape[:2]
    res = bank.resolution
    x = cases.noise(rng, E, nchan, L, case)
    for e in range(E):
        for i, pos in enumerate(range(3000, 50000, 5000)):
            a = sign * res * rng.uniform(8, 40, m)
            cases.add_pulse(x[e], tm, PRETRIG, pos + 37 * e, a)
        # pileup: a 12σ pulse 150 samples after a 200σ one
        cases.add_pulse(x[e], tm, PRETRIG, 52000, sign * 200 * res)
        cases.add_pulse(x[e], tm, PRETRIG, 52150, sign * 12 * res)
        # saturates the low-passed trace
        cases.add_pulse(x[e], tm, PRETRIG, 58000, sign * 3000 * res)
    return x


def _cmp(got, ref, e, elementwise=True):
    """Event ``e`` of the port's set against JAX's: indices and counts
    exactly, Δχ² and amplitudes within 1e-9 of their largest value and,
    with ``elementwise``, each within 1e-9 of itself."""
    got = ttrig.event_set(got, e)
    assert int(got.count) == int(ref.count)
    assert int(got.count_total) == int(ref.count_total)
    np.testing.assert_array_equal(got.indices, np.asarray(ref.indices))
    for name in ("dchi2", "amplitudes"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name), r, rtol=0,
                                   atol=RTOL * np.max(np.abs(r)),
                                   err_msg=name)
        if not elementwise:
            continue
        n = int(ref.count)
        np.testing.assert_allclose(getattr(got, name)[..., :n],
                                   r[..., :n], rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("case", ["1x1", "2x2"])
@pytest.mark.parametrize("run_residual", [False, True])
@pytest.mark.parametrize("positive", [True, False])
def test_trigger_step_matches_jax_run_one(case, run_residual, positive):
    jbank = cases.bank(NT, PRETRIG, case)
    jk = jtrig.make_trigger_kernel(jbank, real_dtype=np.float64)
    jb = jtrig.make_residual_basis(jk)
    tk = ttrig.make_trigger_kernel(tfb.bank_nxm_from_jax(jbank),
                                   real_dtype=np.float64)
    tb = ttrig.make_residual_basis(tk)
    sign = 1.0 if positive else -1.0
    x = _events(case, jbank, sign)
    # the saturation level: 300 σ of amplitude 0's template peak
    sat = list(300 * jbank.resolution[0] * np.max(
        np.abs(cases.templates(NT, PRETRIG, case)[:, 0]), axis=-1))
    thr = jtrig.chi2_threshold(SIGMA, jk.iw_matrix.shape[0])
    run = jax_run_one(jk, jb, thr, WINDOW, CAP, sat, positive, run_residual)

    step = TriggerStep(tk, tb, SIGMA, WINDOW, capacity=CAP,
                       run_residual=run_residual, sat_amps=sat,
                       positive_pulses=positive, device="cpu",
                       dtype=torch.float64)
    assert step.threshold == pytest.approx(thr, rel=1e-12)
    ts, ts2 = step(torch.as_tensor(x))
    assert (ts2 is None) == (not run_residual)
    found = 0
    for e in range(E):
        ref, ref2 = run(jnp.asarray(x[e]))
        _cmp(ts, ref, e)
        found += int(ref.count)
        if run_residual:
            _cmp(ts2, ref2, e)
            idx2 = np.asarray(ref2.indices)[:int(ref2.count)]
            # the saturated pulse, never subtracted, triggers again
            assert np.any(np.abs(idx2 - 58000) <= 16), idx2
    assert found >= E * 11


@pytest.mark.parametrize("run_residual", [False, True])
def test_trigger_step_run_layer_hook_sees_every_layer(run_residual):
    """The ``run_layer`` hook runs each layer of forward in order, and the
    step's output is the same with it as without."""
    jbank = cases.bank(NT, PRETRIG, "1x1")
    tk = ttrig.make_trigger_kernel(tfb.bank_nxm_from_jax(jbank),
                                   real_dtype=np.float64)
    step = TriggerStep(tk, ttrig.make_residual_basis(tk), SIGMA, WINDOW,
                       capacity=CAP, run_residual=run_residual,
                       sat_amps=[300 * float(jbank.resolution[0])],
                       device="cpu", dtype=torch.float64)
    x = torch.as_tensor(_events("1x1", jbank, 1.0))
    seen = []

    def run(name, fn, *args):
        seen.append(name)
        return fn(*args)

    got, plain = step(x, run_layer=run), step(x)
    assert tuple(seen) == LAYERS[:8 if run_residual else 5]
    for a, b in zip(got, plain):
        if b is None:
            assert a is None
            continue
        for fa, fb in zip(a, b):
            torch.testing.assert_close(fa, fb, rtol=0, atol=0)


def test_trigger_step_refuses_what_it_does_not_run():
    """A 6-sample window builds (the tiled merge at tiles of 4 samples);
    residual mode without its basis is refused."""
    tk = ttrig.make_trigger_kernel(tfb.make_ofnxm_bank(
        cases.templates(NT, PRETRIG, "1x1"), cases.csd(NT, "1x1"), FS,
        PRETRIG), real_dtype=np.float64)
    step = TriggerStep(tk, None, SIGMA, 6, device="cpu", dtype=torch.float64)
    assert step.pileup_window == 6 and ttrig._tile_size(6) == 4
    with pytest.raises(ValueError, match="residual basis"):
        TriggerStep(tk, None, SIGMA, WINDOW, run_residual=True,
                    device="cpu", dtype=torch.float64)


# ---------------------------------------------------------------------------
# the sub-tile windows and the dynamic window
# ---------------------------------------------------------------------------

SUBTILE_CAP = 8192      # every above-threshold sample triggers at window 0


def jax_run_one_subtile(kernel, basis, thr, window, cap, sat_amps,
                        run_residual):
    """The sub-tile branch of run_one (pipelines/triggers.py:656-672) as
    one jitted function of a trace [C, L]."""
    iw = jnp.asarray(kernel.iw_matrix)

    def run(trace):
        l = trace.shape[-1]
        q_blocks, _ = jtrig.of_fir_blocks(trace, kernel)
        dchi2_b, amps_b = jtrig.delta_chi2_blocks(q_blocks, iw)
        dchi2 = dchi2_b.reshape(-1)[:l]
        amps = amps_b.reshape(amps_b.shape[0], -1)[:, :l]
        ts = jtrig.find_triggers_blocks(dchi2_b, amps_b, thr, window, cap)
        if not run_residual:
            return ts, None
        lpf = jspec.lowpass_filter(trace, 50e3, kernel.fs)
        sat = jtrig.saturation_mask(lpf, sat_amps, kernel.nt // 4)
        resid = jtrig.residual_subtract_conv(dchi2, ts, kernel, basis, sat)
        return ts, jtrig.find_triggers_kernel(resid, amps, thr, window, cap)

    return jax.jit(run)


def jax_run_batch_dynamic(kernel, basis, thr, window_fn, cap, sat_amps,
                          run_residual, premerge):
    """run_batch_dynamic (pipelines/triggers.py:674-714) as one jitted
    function of a batch [E, C, L]."""
    iw = jnp.asarray(kernel.iw_matrix)
    kw = dict(candidate_capacity=4096, amps_transform=iw,
              premerge_window=premerge)

    def pre(trace):
        l = trace.shape[-1]
        q_blocks, _ = jtrig.of_fir_blocks(trace, kernel)
        dchi2 = jtrig.delta_chi2_from_q(q_blocks, iw).reshape(-1)[:l]
        q_flat = q_blocks.reshape(q_blocks.shape[0], -1)[:, :l]
        lpf = jspec.lowpass_filter(trace, 50e3, kernel.fs)
        return dchi2, q_flat, jtrig.saturation_mask(lpf, sat_amps,
                                                    kernel.nt // 4)

    def run(traces):
        dchi2, q_flat, sat = jax.vmap(pre)(traces)
        ts = jtrig.find_triggers_dynamic_batched(dchi2, q_flat, thr,
                                                 window_fn, cap, **kw)
        if not run_residual:
            return ts, None
        resid = jax.vmap(lambda d, t_, s: jtrig.residual_subtract_conv(
            d, t_, kernel, basis, s))(dchi2, ts, sat)
        return ts, jtrig.find_triggers_dynamic_batched(
            resid, q_flat, thr, window_fn, cap, **kw)

    return jax.jit(run)


def _kernels_1x1():
    jbank = cases.bank(NT, PRETRIG, "1x1")
    jk = jtrig.make_trigger_kernel(jbank, real_dtype=np.float64)
    tk = ttrig.make_trigger_kernel(tfb.bank_nxm_from_jax(jbank),
                                   real_dtype=np.float64)
    sat = [300 * float(jbank.resolution[0]) * float(np.max(
        cases.templates(NT, PRETRIG, "1x1")))]
    return (jbank, jk, jtrig.make_residual_basis(jk), tk,
            ttrig.make_residual_basis(tk), sat)


@pytest.mark.parametrize("window", [0, 3, 6])
@pytest.mark.parametrize("run_residual", [False, True])
def test_trigger_step_subtile_matches_jax(window, run_residual):
    """Pileup windows below 7 samples: the tiled merge at tiles of 1 and 4
    samples against JAX's sub-tile branch. At window 0 every
    above-threshold sample is a trigger and the residual pass subtracts
    thousands of responses, so its Δχ² is a difference of sums up to 1e6
    times its smaller values: there it is held within 1e-9 of its largest
    value only."""
    jbank, jk, jb, tk, tb, sat = _kernels_1x1()
    x = _events("1x1", jbank, 1.0)
    thr = jtrig.chi2_threshold(SIGMA, 1)
    run = jax_run_one_subtile(jk, jb, thr, window, SUBTILE_CAP, sat,
                              run_residual)
    step = TriggerStep(tk, tb, SIGMA, window, capacity=SUBTILE_CAP,
                       run_residual=run_residual, sat_amps=sat,
                       device="cpu", dtype=torch.float64)
    ts, ts2 = step(torch.as_tensor(x))
    for e in range(E):
        ref, ref2 = run(jnp.asarray(x[e]))
        assert int(ref.count) == int(ref.count_total) > 11
        _cmp(ts, ref, e)
        if run_residual:
            _cmp(ts2, ref2, e, elementwise=window > 0)


@pytest.mark.parametrize("premerge", [None, 0])
@pytest.mark.parametrize("run_residual", [False, True])
def test_trigger_step_dynamic_matches_jax(premerge, run_residual):
    """A window of 100 samples up to Δχ² 1000 and of 2000 above: the
    dynamic merge of both passes against JAX's run_batch_dynamic."""
    jbank, jk, jb, tk, tb, sat = _kernels_1x1()
    x = _events("1x1", jbank, 1.0)
    thr = jtrig.chi2_threshold(SIGMA, 1)
    run = jax_run_batch_dynamic(
        jk, jb, thr, lambda m: jnp.where(m > 1000.0, 2000.0, 100.0), CAP,
        sat, run_residual, premerge)
    step = TriggerStep(tk, tb, SIGMA, WINDOW, capacity=CAP,
                       run_residual=run_residual, sat_amps=sat,
                       device="cpu", dtype=torch.float64,
                       window_fn=lambda m: torch.where(m > 1000.0, 2000.0,
                                                       100.0),
                       premerge_window=premerge)
    ts, ts2 = step(torch.as_tensor(x))
    ref, ref2 = run(jnp.asarray(x))
    for e in range(E):
        r = jax.tree.map(lambda a: a[e], ref)
        _cmp(ts, r, e)
        assert int(ts.n_above[e]) == int(r.n_above) > 0
        if run_residual:
            r2 = jax.tree.map(lambda a: a[e], ref2)
            _cmp(ts2, r2, e)
            assert int(ts2.n_above[e]) == int(r2.n_above)
