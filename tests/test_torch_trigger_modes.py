"""The port's remaining trigger modes against the JAX package, in float64 on
the CPU: the sub-tile merge (pileup windows below 7 samples), the
dynamic-window merge and ``shift_templates_to_match_chi2``.

- The sub-tile merge: the port's ``find_triggers_blocks`` and
  ``find_triggers_kernel`` (the tiled merge at tiles of 1, 2 and 4
  samples) against JAX's flat segmented-scan functions, on clustered
  random Δχ² at windows 0–6, with a capacity above and one below the
  group count: counts, totals and every index exact, Δχ² and amplitudes
  within 1e-12 of the largest.
- The dynamic merge: ``find_triggers_dynamic_batched`` against JAX's
  batched function, ``find_triggers_dynamic_kernel`` against
  ``jax.vmap`` of JAX's kernel, every field equal (``n_above`` too;
  amplitudes through ``amps_transform`` within 1e-12), over the cases of
  tests/test_trigger.py:581-850 (pre-merge default, 0 and explicit;
  monotonic step, clipped-linear and square-root windows, a constant one,
  a non-monotonic one at pre-merge 0; an empty trace, capacity
  truncation, candidate overflow). Each window function is written once
  in jnp for JAX and once in torch for the port. A fuzz holds both the
  device path and the port's host loop to JAX's host loop.
- ``shift_templates_to_match_chi2`` at 1x1 (the case of
  tests/test_completeness_utils.py:70-80) and on two channels: shifts
  exact, templates within 1e-12.
- A window function that ``torch.func.vmap`` cannot run is refused by
  name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detprocess_tpu.models import pulse as jpulse
from detprocess_tpu.ops import trigger as jtrig
from detprocess_tpu_torch.ops import trigger as ttrig
from detprocess_tpu_torch.pipelines.trigger_step import TriggerStep

torch.set_num_threads(1)

TOL = 1e-12
FS = 1.25e6


def _same_set(got, ref, what=""):
    """A port trigger set against a JAX one: counts and the first
    ``count`` indices exact, the rest empty on both sides, Δχ² and
    amplitudes within TOL of their largest value. The tiled merge keeps
    min(capacity, L/G) slots where JAX's sub-tile compaction keeps
    ``capacity``; where both keep the same number, every slot is held."""
    n = int(ref.count)
    assert int(got.count) == n, what
    assert int(got.count_total) == int(ref.count_total), what
    gi, ri = np.asarray(got.indices), np.asarray(ref.indices)
    if gi.shape != ri.shape:
        assert min(gi.shape[-1], ri.shape[-1]) >= n, what
        assert (gi[n:] == -1).all() and (ri[n:] == -1).all(), what
        gi, ri = gi[:n], ri[:n]
    np.testing.assert_array_equal(gi, ri, err_msg=what)
    k = gi.shape[-1]
    for name in ("dchi2", "amplitudes"):
        r = np.asarray(getattr(ref, name))[..., :k]
        np.testing.assert_allclose(np.asarray(getattr(got, name))[..., :k],
                                   r, rtol=0,
                                   atol=TOL * max(np.abs(r).max(initial=0),
                                                  1.0),
                                   err_msg=f"{what} {name}")
    if ref.n_above is not None:
        assert int(got.n_above) == int(ref.n_above), what


def _host_set(ts, e=None):
    return ttrig.event_set(ts, e) if e is not None else ttrig.TriggerSet(
        *(None if f is None else f.numpy() for f in ts))


# ---------------------------------------------------------------------------
# the sub-tile merge
# ---------------------------------------------------------------------------

def _clustered(seed, l, m):
    """|N(0, 3²)| noise below a threshold of 9, with 60 clusters of 12
    above-threshold samples 1–8 samples apart."""
    rng = np.random.default_rng(seed)
    d = np.abs(rng.standard_normal(l)) * 3.0
    d = np.minimum(d, 8.5)
    for c in rng.integers(100, l - 200, 60):
        pos = c + np.cumsum(rng.integers(1, 9, 12))
        d[pos] = 10.0 + 80.0 * rng.random(12)
    return d, rng.standard_normal((m, l))


@pytest.mark.parametrize("window", [0, 1, 2, 3, 5, 6])
@pytest.mark.parametrize("capacity", [2048, 40])
def test_subtile_blocks_match_jax(window, capacity):
    r, b, m = 4, 4096, 2
    events = [_clustered(seed, r * b, m) for seed in (3, 4)]
    got = ttrig.find_triggers_blocks(
        torch.as_tensor(np.stack([d.reshape(r, b) for d, _ in events])),
        torch.as_tensor(np.stack([a.reshape(m, r, b) for _, a in events])),
        9.0, window, capacity)
    for e, (d, a) in enumerate(events):
        ref = jtrig.find_triggers_blocks(
            jnp.asarray(d.reshape(r, b)), jnp.asarray(a.reshape(m, r, b)),
            9.0, window, capacity)
        _same_set(_host_set(got, e), ref, f"event {e}")
        if capacity == 40:          # below the group count: truncated
            assert int(ref.count_total) > int(ref.count) == capacity


@pytest.mark.parametrize("window", [0, 1, 2, 3, 5, 6])
@pytest.mark.parametrize("capacity", [4096, 25])
def test_subtile_kernel_matches_jax(window, capacity):
    """Flat inputs of a length that is no block or tile multiple."""
    d, a = _clustered(7, 12345, 1)
    ref = jtrig.find_triggers_kernel(jnp.asarray(d), jnp.asarray(a), 9.0,
                                     window, capacity)
    got = ttrig.find_triggers_kernel(torch.as_tensor(d), torch.as_tensor(a),
                                     9.0, window, capacity)
    _same_set(_host_set(got), ref)
    assert int(ref.count) > 0


# ---------------------------------------------------------------------------
# the dynamic merge
# ---------------------------------------------------------------------------

# each window function in jnp for JAX and in torch for the port
WINDOWS = {
    "sqrt": (lambda m: 30.0 + 1.5 * jnp.sqrt(m),
             lambda m: 30.0 + 1.5 * torch.sqrt(m)),
    "step": (lambda m: jnp.where(m > 50.0, 400.0, 40.0),
             lambda m: torch.where(m > 50.0, 400.0, 40.0)),
    "clip": (lambda m: (0.1 * m).clip(100.0, 5000.0),
             lambda m: (0.1 * m).clamp(100.0, 5000.0)),
    "const": (lambda m: 60.0, lambda m: 60.0),
}
NONMONOTONIC = (lambda m: jnp.where(m > 100.0, 5.0, 50.0),
                lambda m: torch.where(m > 100.0, 5.0, 50.0))
IW = np.array([[2.0, 0.5], [-1.0, 3.0]])


def _uneven_batch():
    """The batch of tests/test_trigger.py::test_dynamic_batched_vs_vmapped:
    a lane below threshold, a dense 600-sample block, lanes of 12, 60 and
    200 excursions."""
    l, e = 20_000, 5
    rng = np.random.default_rng(7)
    dchi2 = np.abs(rng.standard_normal((e, l))) * 3.0
    for ev, nhot in [(1, 12), (2, 60), (4, 200)]:
        hot = rng.integers(0, l, size=nhot)
        dchi2[ev, hot] = 10.0 + 80.0 * rng.random(nhot)
    dchi2[3, 2000:2600] = 10.0 + 80.0 * rng.random(600)
    return dchi2, rng.standard_normal((e, 2, l))


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("premerge,ccap", [(None, 512), (0, 512), (0, 128),
                                           (0, 100), (16, 512)])
def test_dynamic_batched_matches_jax(window, premerge, ccap):
    """Candidate capacity 128 overflows the dense lane; 100 is no multiple
    of JAX's walk blocks; pre-merge 16 is explicit."""
    jfn, tfn = WINDOWS[window]
    dchi2, amps = _uneven_batch()
    ref = jtrig.find_triggers_dynamic_batched(
        jnp.asarray(dchi2), jnp.asarray(amps), 9.0, jfn, capacity=64,
        candidate_capacity=ccap, amps_transform=jnp.asarray(IW),
        premerge_window=premerge)
    got = ttrig.find_triggers_dynamic_batched(
        torch.as_tensor(dchi2), torch.as_tensor(amps), 9.0, tfn, 64, ccap,
        amps_transform=IW, premerge_window=premerge)
    for e in range(dchi2.shape[0]):
        _same_set(_host_set(got, e), jax.tree.map(lambda x: x[e], ref),
                  f"{window} {premerge} {ccap} event {e}")
    if premerge == 0 and ccap == 128:
        assert int(got.n_above[3]) > ccap          # the overflow shows


@pytest.mark.parametrize("premerge", [None, 0])
@pytest.mark.parametrize("transform", [False, True])
def test_dynamic_kernel_matches_vmapped_jax_kernel(premerge, transform):
    jfn, tfn = WINDOWS["sqrt"]
    dchi2, amps = _uneven_batch()
    iw = IW if transform else None
    ref = jax.vmap(lambda d, a: jtrig.find_triggers_dynamic_kernel(
        d, a, 9.0, jfn, capacity=64, candidate_capacity=256,
        amps_transform=None if iw is None else jnp.asarray(iw),
        premerge_window=premerge))(jnp.asarray(dchi2), jnp.asarray(amps))
    for e in range(dchi2.shape[0]):
        got = ttrig.find_triggers_dynamic_kernel(
            torch.as_tensor(dchi2[e]), torch.as_tensor(amps[e]), 9.0, tfn,
            64, 256, amps_transform=iw, premerge_window=premerge)
        _same_set(_host_set(got), jax.tree.map(lambda x: x[e], ref),
                  f"event {e}")


def test_dynamic_non_monotonic_window_at_sample_level():
    """A window that narrows for large pulses: sample-level units stay
    exact (tests/test_trigger.py::test_dynamic_kernel_non_monotonic_window)."""
    dchi2 = np.zeros(2048)
    dchi2[500] = dchi2[540] = 200.0       # gap 40: merged at 50, split at 5
    amps = np.ones((1, 2048))
    ref = jtrig.find_triggers_dynamic_kernel(
        jnp.asarray(dchi2), jnp.asarray(amps), 10.0, NONMONOTONIC[0],
        capacity=8, premerge_window=0)
    got = ttrig.find_triggers_dynamic_kernel(
        torch.as_tensor(dchi2), torch.as_tensor(amps), 10.0, NONMONOTONIC[1],
        8, premerge_window=0)
    _same_set(_host_set(got), ref)
    assert int(got.count) == 2
    h_idx, _, _ = ttrig.find_triggers_dynamic(
        dchi2, amps, 10.0, lambda m: 5.0 if m > 100.0 else 50.0)
    np.testing.assert_array_equal(got.indices[:2].numpy(), h_idx)


@pytest.mark.parametrize("window", ["sqrt", "const"])
def test_dynamic_empty_trace_and_capacity(window):
    """No sample above threshold; then isolated spikes past a capacity of
    3, with every group still counted
    (tests/test_trigger.py::test_dynamic_kernel_empty_and_capacity)."""
    jfn, tfn = WINDOWS[window]
    dchi2 = np.zeros(1024)
    amps = np.zeros((1, 1024))
    for cap in (8, 3):
        ref = jtrig.find_triggers_dynamic_kernel(
            jnp.asarray(dchi2), jnp.asarray(amps), 10.0, jfn, capacity=cap)
        got = ttrig.find_triggers_dynamic_kernel(
            torch.as_tensor(dchi2), torch.as_tensor(amps), 10.0, tfn, cap)
        _same_set(_host_set(got), ref, f"capacity {cap}")
        dchi2[::100] = 50.0
    assert int(got.count) == 3 and int(got.count_total) == 11


@pytest.mark.parametrize("premerge,ccap", [(0, 1024), (0, 8192),
                                           (None, 1024)])
def test_dynamic_candidate_overflow(premerge, ccap):
    """A 5000-sample cluster: sample-level units overflow a capacity of
    1024 (n_above shows it) and fit 8192; pre-merged it is one unit
    (tests/test_trigger.py::test_dynamic_kernel_candidate_overflow_reported)."""
    dchi2 = np.zeros(10_000)
    dchi2[200:5200] = 30.0
    dchi2[4700] = 100.0
    amps = np.zeros((1, 10_000))
    ref = jtrig.find_triggers_dynamic_kernel(
        jnp.asarray(dchi2), jnp.asarray(amps), 10.0, lambda m: 50.0,
        capacity=8, candidate_capacity=ccap, premerge_window=premerge)
    got = ttrig.find_triggers_dynamic_kernel(
        torch.as_tensor(dchi2), torch.as_tensor(amps), 10.0, lambda m: 50.0,
        8, ccap, premerge_window=premerge)
    _same_set(_host_set(got), ref)
    assert int(got.n_above) == (5000 if premerge == 0 else 1)


@pytest.mark.parametrize("seed,length", [(0, 4096), (1, 4097), (2, 12_345),
                                         (3, 50_000), (5, 700)])
def test_dynamic_fuzz_against_the_host_loop(seed, length):
    """The device path (pre-merged and sample-level) and the port's host
    loop against JAX's host loop on random traces with excursions
    everywhere, the last partial tile included."""
    rng = np.random.default_rng(seed)
    dchi2 = np.abs(rng.standard_normal(length)) * 3.0
    hot = rng.integers(0, length, size=40)
    dchi2[hot] = 10.0 + 80.0 * rng.random(40)
    amps = rng.standard_normal((2, length))

    def host_fn(m):
        return 30.0 + 1.5 * np.sqrt(m)

    h_idx, h_val, h_amp = jtrig.find_triggers_dynamic(dchi2, amps, 9.0,
                                                      host_fn)
    for cap in (None, 5):
        ref = jtrig.find_triggers_dynamic(dchi2, amps, 9.0, host_fn, cap)
        mine = ttrig.find_triggers_dynamic(dchi2, amps, 9.0, host_fn, cap)
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a, b)
    for premerge in (None, 0):
        got = ttrig.find_triggers_dynamic_kernel(
            torch.as_tensor(dchi2), torch.as_tensor(amps), 9.0,
            WINDOWS["sqrt"][1], 256, amps_transform=IW,
            premerge_window=premerge)
        n = int(got.count)
        assert n == int(got.count_total) == len(h_idx)
        np.testing.assert_array_equal(got.indices[:n].numpy(), h_idx)
        np.testing.assert_array_equal(got.dchi2[:n].numpy(), h_val)
        np.testing.assert_allclose(got.amplitudes[:, :n].numpy(),
                                   IW @ h_amp, rtol=TOL)


def test_window_fn_that_vmap_cannot_run_is_refused():
    def branchy(m):                  # JAX would need lax.cond for this
        return 400.0 if m > 50.0 else 40.0

    with pytest.raises(ValueError, match="window_fn must map a tensor"):
        ttrig.check_window_fn(branchy)
    with pytest.raises(ValueError, match="returned shape"):
        ttrig.check_window_fn(lambda m: torch.ones(3))
    ttrig.check_window_fn(WINDOWS["step"][1])
    ttrig.check_window_fn(WINDOWS["const"][1])
    kernel = ttrig.make_trigger_kernel(
        ttrig.filterbank.make_ofnxm_bank(
            jpulse.make_template(FS, 512, 128, A=1.0, tau_r=20e-6,
                                 tau_f1=200e-6),
            np.full(512, 4e-18, complex), FS, 128), real_dtype=np.float64)
    with pytest.raises(ValueError, match="torch.func.vmap"):
        TriggerStep(kernel, None, 5.0, 100, device="cpu",
                    dtype=torch.float64, window_fn=branchy)


# ---------------------------------------------------------------------------
# template alignment
# ---------------------------------------------------------------------------

def _two_channel_case():
    t1 = jpulse.make_template(FS, 1024, 256, A=1.0, tau_r=20e-6,
                              tau_f1=200e-6)
    t2 = jpulse.make_template(FS, 1024, 256, A=1.0, tau_r=8e-6,
                              tau_f1=80e-6)
    primary = np.stack([t1, 0.6 * t2])[:, None, :]          # [2, 1, N]
    f = np.fft.fftfreq(1024)
    csd = np.zeros((2, 2, 1024), complex)
    csd[0, 0], csd[1, 1] = 1e-20, 1.5e-20
    csd[1, 0] = 0.4e-20 * np.exp(-2j * np.pi * f * 3)
    csd[0, 1] = np.conj(csd[1, 0])
    secondaries = [np.roll(primary, 29, axis=-1),
                   np.roll(primary[:, :, ::-1] * 0.1 + primary, -64, axis=-1)]
    return primary, secondaries, csd


@pytest.mark.parametrize("case", ["1x1", "2 channels"])
def test_shift_templates_to_match_chi2_matches_jax(case):
    if case == "1x1":
        primary = jpulse.make_template(FS, 1024, 256, A=1.0, tau_r=20e-6,
                                       tau_f1=200e-6)
        secondaries = [np.roll(primary, 37), np.roll(primary, -90)]
        csd = np.full(1024, 1e-20, dtype=complex)
    else:
        primary, secondaries, csd = _two_channel_case()
    ref_t, ref_s = jtrig.shift_templates_to_match_chi2(
        FS, primary, secondaries, csd, block=4096)
    got_t, got_s = ttrig.shift_templates_to_match_chi2(
        FS, primary, secondaries, csd, block=4096, device="cpu")
    assert isinstance(got_s, np.ndarray) and got_s.dtype.kind == "i"
    np.testing.assert_array_equal(got_s, ref_s)
    for g, r in zip(got_t, ref_t):
        assert isinstance(g, np.ndarray)
        np.testing.assert_allclose(g, r, rtol=0, atol=TOL * np.abs(r).max())
    if case == "1x1":               # tests/test_completeness_utils.py:70-80
        assert abs(got_s[0] + 37) <= 1
