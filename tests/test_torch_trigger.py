"""The port's trigger functions equal the JAX package's.

``detprocess_tpu_torch.ops.trigger`` (and ``ops.spectral.lowpass_filter``,
the NxM bank copy in ``ops.filterbank``) against
``detprocess_tpu.ops.trigger`` in float64 on the CPU, JAX with x64 as
tests/conftest.py sets it. The JAX FIR runs its default chain (the packed
layout where its four-step transform engages, natural order below); the
port runs the natural one. Banks: tests/trigger_cases.py, one channel with
a flat PSD and two channels × two templates with a phase-correlated CSD.
Indices and counts are compared exactly; values at 1e-9 of their scale
unless stated.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import trigger_cases as cases
from detprocess_tpu.ops import filterbank as jfb
from detprocess_tpu.ops import spectral as jspec
from detprocess_tpu.ops import trigger as jtrig
from detprocess_tpu_torch.ops import filterbank as tfb
from detprocess_tpu_torch.ops import spectral as tspec
from detprocess_tpu_torch.ops import trigger as ttrig

torch.set_num_threads(1)

FS = cases.FS
NT, PRETRIG = 512, 128
RTOL = 1e-9


def _join(a):
    a = np.asarray(a)
    return a[..., 0] + 1j * a[..., 1]


def _port_bank(case):
    return tfb.make_ofnxm_bank(cases.templates(NT, PRETRIG, case),
                               cases.csd(NT, case), FS, PRETRIG)


def _kernels(case, block=16384):
    jk = jtrig.make_trigger_kernel(cases.bank(NT, PRETRIG, case),
                                   block=block, real_dtype=np.float64)
    tk = ttrig.make_trigger_kernel(_port_bank(case), block=block,
                                   real_dtype=np.float64)
    return jk, tk


def _close(got, ref, rtol=RTOL, err_msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, err_msg
    scale = max(float(np.max(np.abs(ref))) if ref.size else 0.0, 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale,
                               err_msg=err_msg)


@pytest.mark.parametrize("thresh,m", [(5.0, 1), (5.0, 2), (3.0, 3),
                                      (4.5, 4), (0.5, 2), (24.9, 1),
                                      (30.0, 2)])
def test_chi2_threshold_matches_jax(thresh, m):
    got = ttrig.chi2_threshold(thresh, m)
    ref = jtrig.chi2_threshold(thresh, m)
    assert abs(got - ref) <= 1e-12 * ref


@pytest.mark.parametrize("case", ["1x1", "2x2"])
@pytest.mark.parametrize("notch", [None, [60e3]])
def test_make_ofnxm_bank_matches_jax(case, notch):
    tm, cs = cases.templates(NT, PRETRIG, case), cases.csd(NT, case)
    ref = jfb.make_ofnxm_bank(tm, cs, FS, PRETRIG,
                              ignored_frequency_peaks=notch)
    got = tfb.make_ofnxm_bank(tm, cs, FS, PRETRIG,
                              ignored_frequency_peaks=notch)
    carried = tfb.bank_nxm_from_jax(ref)
    assert type(carried) is tfb.OFNxMBank
    for name in ("s_fft", "icsd", "phi", "w_matrix", "iw_matrix",
                 "templates", "csd"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-12, atol=0, err_msg=name)
        np.testing.assert_array_equal(getattr(carried, name),
                                      getattr(ref, name), err_msg=name)
    assert (got.fs, got.pretrigger) == (ref.fs, ref.pretrigger)
    assert (got.nchans, got.ntmps, got.nbins) == (ref.nchans, ref.ntmps,
                                                  ref.nbins)
    np.testing.assert_allclose(got.resolution, ref.resolution, rtol=1e-12)


@pytest.mark.parametrize("shape", [(NT,), (1, NT), (NT, 1)])
def test_reshape_rules_match_jax(shape):
    t = np.arange(NT, dtype=float).reshape(shape)
    np.testing.assert_array_equal(tfb._reshape_template_3d(t),
                                  jfb._reshape_template_3d(t))
    np.testing.assert_array_equal(tfb._reshape_csd_3d(t),
                                  jfb._reshape_csd_3d(t))
    with pytest.raises(ValueError, match="ambiguous"):
        tfb._reshape_template_3d(np.zeros((2, NT)))


@pytest.mark.parametrize("case", ["1x1", "2x2"])
@pytest.mark.parametrize("block", [16384, 2048])
def test_make_trigger_kernel_matches_jax(case, block):
    jk, tk = _kernels(case, block)
    assert (tk.nt, tk.pretrigger, tk.fs, tk.block, tk.fft_size) == (
        jk.nt, jk.pretrigger, jk.fs, jk.block, jk.fft_size)
    for name in ("iw_matrix", "response", "resolution"):
        np.testing.assert_allclose(getattr(tk, name), getattr(jk, name),
                                   rtol=1e-12, atol=1e-12 * np.max(
                                       np.abs(getattr(jk, name))),
                                   err_msg=name)
    # the JAX kernel keeps g_fft in natural order when it packs (F=16384)
    # and when its transform is natural (F=2048)
    assert (jk.g_pk_p is not None) == (block == 16384)
    np.testing.assert_allclose(tk.g_fft, _join(jk.g_fft), rtol=0,
                               atol=1e-12 * np.max(np.abs(tk.g_fft)))
    # g_fft is the rfft of the rolled circular matched filter, padded
    bank = _port_bank(case)
    g = np.roll(np.real(np.fft.ifft(bank.phi, axis=-1)) * NT, NT - 1,
                axis=-1)
    ref = np.fft.rfft(g, n=tk.fft_size, axis=-1)
    np.testing.assert_allclose(tk.g_fft, ref, rtol=0,
                               atol=1e-13 * np.max(np.abs(ref)))
    assert tk.g_fft.dtype == np.complex128
    f32 = ttrig.make_trigger_kernel(bank, block=block)
    assert f32.g_fft.dtype == np.complex64
    assert f32.iw_matrix.dtype == np.float32


@pytest.mark.parametrize("case", ["1x1", "2x2"])
def test_make_residual_basis_matches_jax(case):
    jk, tk = _kernels(case)
    jb, tb = jtrig.make_residual_basis(jk), ttrig.make_residual_basis(tk)
    np.testing.assert_array_equal(tb.j1, jb.j1)
    np.testing.assert_array_equal(tb.j2, jb.j2)
    for name in ("nt", "pretrigger", "fs", "block", "fft_size"):
        assert getattr(tb.fir, name) == getattr(jb.fir, name), name
    np.testing.assert_array_equal(tb.fir.iw_matrix, jb.fir.iw_matrix)
    jg = _join(jb.fir.g_fft)
    assert jb.fir.g_pk_p is not None          # natural g_fft beside it
    np.testing.assert_allclose(tb.fir.g_fft, jg, rtol=0,
                               atol=1e-12 * np.max(np.abs(jg)))
    # g_fft is the rfft of the folded basis, padded to F
    resp, iw = tk.response, tk.iw_matrix
    gfull = np.einsum("abl,ac,cdl->bdl", resp, iw, resp)
    j1, j2 = np.triu_indices(iw.shape[0])
    basis = gfull[j1, j2] * np.where(j1 == j2, 1.0, 2.0)[:, None]
    ref = np.fft.rfft(basis[:, None, :], n=tb.fir.fft_size, axis=-1)
    np.testing.assert_allclose(tb.fir.g_fft, ref, rtol=0,
                               atol=1e-12 * np.max(np.abs(ref)))


def _continuous(case, events, length, seed, npulse=6):
    rng = np.random.default_rng(seed)
    tm = cases.templates(NT, PRETRIG, case)
    nchan, m = tm.shape[:2]
    x = cases.noise(rng, events, nchan, length, case)
    for e in range(events):
        idx = rng.choice(np.arange(2 * NT, length - 2 * NT, 4 * NT),
                         npulse, replace=False)
        for i in idx:
            cases.add_pulse(x[e], tm, PRETRIG, int(i),
                            rng.uniform(1, 5, m) * 2e-7)
    return x


@pytest.mark.parametrize("case", ["1x1", "2x2"])
@pytest.mark.parametrize("block", [16384, 2048])
@pytest.mark.parametrize("valid_range", [None, (0, 30000)])
def test_of_fir_blocks_matches_jax(case, block, valid_range):
    jk, tk = _kernels(case, block)
    x = _continuous(case, 2, 30000, 3)
    qb, valid = ttrig.of_fir_blocks(torch.as_tensor(x), tk, valid_range)
    for e in range(2):
        jq, jvalid = jtrig.of_fir_blocks(jnp.asarray(x[e]), jk, valid_range)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        _close(qb[e], jq, err_msg=f"event {e}")
        _close(ttrig.of_fir(torch.as_tensor(x[e]), tk, valid_range),
               jtrig.of_fir(jnp.asarray(x[e]), jk, valid_range))


@pytest.mark.parametrize("case", ["1x1", "2x2"])
def test_delta_chi2_matches_jax(case):
    jk, tk = _kernels(case)
    x = _continuous(case, 2, 30000, 4)
    q = ttrig.of_fir(torch.as_tensor(x), tk)                  # [E, M, L]
    qb, _ = ttrig.of_fir_blocks(torch.as_tensor(x), tk)       # [E, M, R, B]
    for e in range(2):
        jd, ja = jtrig.delta_chi2(jnp.asarray(q[e].numpy()),
                                  jnp.asarray(jk.iw_matrix))
        d, a = ttrig.delta_chi2(q, tk.iw_matrix)
        _close(d[e], jd)
        _close(a[e], ja)
        jq = jnp.asarray(qb[e].numpy())
        jdb, jab = jtrig.delta_chi2_blocks(jq, jnp.asarray(jk.iw_matrix))
        db, ab = ttrig.delta_chi2_blocks(qb, tk.iw_matrix)
        _close(db[e], jdb)
        _close(ab[e], jab)
        _close(ttrig.delta_chi2_from_q(qb, tk.iw_matrix)[e],
               jtrig.delta_chi2_from_q(jq, jnp.asarray(jk.iw_matrix)))


def _cmp_sets(got, ref, rtol=RTOL):
    """A port TriggerSet event against a JAX TriggerSet."""
    assert int(got.count) == int(ref.count)
    assert int(got.count_total) == int(ref.count_total)
    np.testing.assert_array_equal(np.asarray(got.indices),
                                  np.asarray(ref.indices))
    _close(got.dchi2, ref.dchi2, rtol)
    _close(got.amplitudes, ref.amplitudes, rtol)


def _spiky(rng, length, rate=0.01):
    d = rng.exponential(1.0, length)
    spikes = rng.random(length) < rate
    d[spikes] += rng.exponential(40, spikes.sum())
    return d


@pytest.mark.parametrize("window", [7, 16, 100, 255, 511, 1000, 2047])
@pytest.mark.parametrize("transform", [False, True])
def test_find_triggers_tiled_matches_jax(window, transform):
    """Random Δχ² with ties inside a window (first achiever wins) and
    groups across tile edges, two events in one batch."""
    rng = np.random.default_rng(window)
    length = 65536
    d = np.stack([_spiky(rng, length) for _ in range(2)])
    d[:, 1000] = d[:, 1003] = 77.0
    amps = np.stack([d * 0.5, d * -0.25], axis=1)             # [E, 2, L]
    iw = np.array([[2.0, 0.3], [0.3, 1.5]]) if transform else None
    got = ttrig.find_triggers_tiled(
        torch.as_tensor(d).reshape(2, 4, -1),
        torch.as_tensor(amps).reshape(2, 2, 4, -1), 8.0, window, 1024,
        amps_transform=iw)
    k = min(1024, length // ttrig._tile_size(window))
    assert got.indices.shape == (2, k)
    assert got.amplitudes.shape == (2, 2, k)
    for e in range(2):
        ref = jtrig.find_triggers_tiled(
            jnp.asarray(d[e]).reshape(4, -1),
            jnp.asarray(amps[e]).reshape(2, 4, -1), 8.0, window, 1024,
            amps_transform=None if iw is None else jnp.asarray(iw))
        _cmp_sets(ttrig.event_set(got, e), ref)
        # and the numpy merge of the reference (oftrigger.py:29-74)
        above = np.where(d[e] > 8.0)[0]
        groups = np.split(above, np.where(np.diff(above) > window)[0] + 1)
        exp = [g[np.argmax(d[e][g])] for g in groups]
        n = int(got.count[e])
        np.testing.assert_array_equal(got.indices[e, :n].numpy(), exp)


@pytest.mark.parametrize("window,shape", [(511, (4, 750)), (100, (3, 1001)),
                                          (2047, (1, 3000))])
def test_find_triggers_tiled_nondivisible_length(window, shape):
    rng = np.random.default_rng(7)
    length = shape[0] * shape[1]
    d = _spiky(rng, length)
    amps = d[None, :] * 0.5
    assert length % ttrig._tile_size(window) != 0   # the case under test
    got = ttrig.find_triggers_tiled(torch.as_tensor(d).reshape(shape),
                                    torch.as_tensor(amps).reshape(
                                        (1,) + shape), 8.0, window, 256)
    ref = jtrig.find_triggers_tiled(jnp.asarray(d).reshape(shape),
                                    jnp.asarray(amps).reshape((1,) + shape),
                                    8.0, window, capacity=256)
    _cmp_sets(got, ref)
    assert got.indices.ndim == 1 and got.count.shape == ()


def test_find_triggers_tiled_capacity_overflow():
    """More merged groups than capacity: the earliest K in time order are
    kept, count is K and count_total the number of groups."""
    length = 20000
    d = np.zeros(length)
    pos = np.arange(40) * 500 + 100
    d[pos] = 100.0
    amps = d[None] * 1e-6
    got = ttrig.find_triggers_tiled(torch.as_tensor(d).reshape(1, -1),
                                    torch.as_tensor(amps).reshape(1, 1, -1),
                                    10.0, 50, 16)
    ref = jtrig.find_triggers_tiled(jnp.asarray(d).reshape(1, -1),
                                    jnp.asarray(amps).reshape(1, 1, -1),
                                    10.0, 50, 16)
    assert int(got.count) == 16 and int(got.count_total) == 40
    np.testing.assert_array_equal(got.indices.numpy(), pos[:16])
    _cmp_sets(got, ref)


@pytest.mark.parametrize("window", [0, 3, 6, 7, 8, 4095, 10 ** 6])
def test_tile_size_matches_jax(window):
    assert ttrig._tile_size(window) == jtrig._tile_size(window)


@pytest.mark.parametrize("length,cut", [(65536, 50e3), (30001, 20e3)])
def test_lowpass_filter_matches_jax(length, cut):
    x = np.random.default_rng(length).standard_normal((2, 2, length))
    got = tspec.lowpass_filter(torch.as_tensor(x), cut, FS)
    ref = np.asarray(jspec.lowpass_filter(jnp.asarray(x), cut, FS))
    _close(got, ref, 1e-12)


@pytest.mark.parametrize("positive", [True, False])
@pytest.mark.parametrize("window", [1, 10, 128, 2000])
def test_saturation_mask_matches_jax(positive, window):
    rng = np.random.default_rng(window)
    lpf = rng.standard_normal((2, 2, 5000))
    sat = [2.8, 3.1]
    got = ttrig.saturation_mask(torch.as_tensor(lpf), sat, window, positive)
    assert got.dtype == torch.bool and got.shape == (2, 5000)
    for e in range(2):
        ref = jtrig.saturation_mask(jnp.asarray(lpf[e]), sat, window,
                                    positive)
        np.testing.assert_array_equal(got[e].numpy(), np.asarray(ref))
    # ±window exactly, as tests/test_trigger.py::test_saturation_mask
    one = torch.zeros(1, 1000, dtype=torch.float64)
    one[0, 500] = 1.0
    m = ttrig.saturation_mask(one, [0.5], window=10)
    assert m[490] and m[510] and not m[489] and not m[511]


def _trigger_sets(rng, events, cap, m, length, nvalid):
    idx = np.full((events, cap), -1, np.int64)
    amps = np.zeros((events, m, cap))
    for e in range(events):
        n = nvalid[e]
        idx[e, :n] = np.sort(rng.choice(length, n, replace=False))
        amps[e, :, :n] = rng.standard_normal((m, n)) * 3.0
    count = np.asarray(nvalid)
    return idx, amps, count


@pytest.mark.parametrize("case", ["1x1", "2x2"])
@pytest.mark.parametrize("layout", ["flat", "blocks"])
def test_residual_subtract_conv_matches_jax(case, layout):
    """Interior, overlapping and edge-straddling triggers, empty slots,
    one event without triggers beside one with, a saturation veto."""
    jk, tk = _kernels(case)
    jb, tb = jtrig.make_residual_basis(jk), ttrig.make_residual_basis(tk)
    rng = np.random.default_rng(11)
    length, cap, m = 40000, 16, tk.iw_matrix.shape[0]
    d = np.abs(rng.standard_normal((3, length))) * 2.0
    idx, amps, count = _trigger_sets(rng, 3, cap, m, length, [6, 0, 3])
    idx[0, :6] = [120, 5000, 5600, 20000, 39000, 39900]
    sat = np.zeros((3, length), bool)
    sat[0, 20000] = True
    ts = ttrig.TriggerSet(torch.as_tensor(idx),
                          torch.zeros(3, cap, dtype=torch.float64),
                          torch.as_tensor(amps), torch.as_tensor(count),
                          torch.as_tensor(count))
    shape = (3, 40, 1000) if layout == "blocks" else (3, length)
    got = ttrig.residual_subtract_conv(torch.as_tensor(d).reshape(shape), ts,
                                       tk, tb, torch.as_tensor(sat))
    assert got.shape == shape
    got = got.reshape(3, length).numpy()
    for e in range(3):
        jts = jtrig.TriggerSet(jnp.asarray(idx[e]), jnp.zeros(cap),
                               jnp.asarray(amps[e]), jnp.int32(count[e]),
                               jnp.int32(count[e]))
        ref = np.asarray(jtrig.residual_subtract_conv(
            jnp.asarray(d[e]).reshape(shape[1:]), jts, jk, jb,
            jnp.asarray(sat[e]))).reshape(-1)
        # both convolve by FFT: roundoff ~eps × the largest subtraction
        # spreads over the trace, so compare at that scale
        _close(got[e], ref, 1e-11 * np.max(np.abs(ref - d[e]) + 1.0)
               / max(np.max(np.abs(ref)), 1.0))
    np.testing.assert_array_equal(got[1], d[1])   # no triggers: unchanged


def test_combine_trigger_sets_matches_jax():
    def make(mod, indices, cap, total):
        k = len(indices)
        idx = np.full(cap, -1, np.int64)
        idx[:k] = indices
        d = np.zeros(cap)
        d[:k] = np.arange(k) + 10.0
        a = np.zeros((2, cap))
        a[:, :k] = np.arange(2 * k).reshape(2, k)
        if mod is jtrig:
            return jtrig.TriggerSet(idx.astype(np.int32), d, a,
                                    np.int32(k), np.int32(total))
        return ttrig.TriggerSet(torch.as_tensor(idx), torch.as_tensor(d),
                                torch.as_tensor(a), torch.tensor(k),
                                torch.tensor(total))

    for first, second in [(([100, 500, 900], 4, 3), ([500, 700], 2, 6)),
                          (([100], 1, 7), ([5, 100, 200], 4, 3)),
                          (([], 2, 0), ([42], 2, 1))]:
        got = ttrig.combine_trigger_sets(make(ttrig, *first),
                                         make(ttrig, *second))
        ref = jtrig.combine_trigger_sets(make(jtrig, *first),
                                         make(jtrig, *second))
        for name in ("indices", "dchi2", "amplitudes", "count",
                     "count_total"):
            np.testing.assert_array_equal(getattr(got, name),
                                          np.asarray(getattr(ref, name)),
                                          err_msg=name)
