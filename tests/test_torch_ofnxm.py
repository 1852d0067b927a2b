"""The port's NxM fits on the half spectrum equal the JAX package's
full-spectrum ones.

``detprocess_tpu_torch.ops.ofnxm`` (no-delay, delay scan with and without
a window and the parabolic refit, NxMx2) against
``detprocess_tpu.ops.ofnxm`` fed the full complex FFT, in float64 at
1e-9, on the two banks of tests/trigger_cases.py: one channel and one
template, and two channels and two templates with a CSD whose cross terms
carry a frequency-dependent phase. Also the device bank
(``filterbank.bank_nxm_to_torch``) against the JAX ``device_bank_nxm``,
and the NxMx2 plan's inverted weight matrices against JAX's in-scan ones.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detprocess_tpu.ops import filterbank as jfb
from detprocess_tpu.ops import of1x1 as jof
from detprocess_tpu.ops import ofnxm as jnxm
from detprocess_tpu_torch.ops import fft as tfft
from detprocess_tpu_torch.ops import filterbank as tfb
from detprocess_tpu_torch.ops import ofnxm as tnxm

import trigger_cases as tc

torch.set_num_threads(1)

FS = tc.FS
N = 4096
PRETRIG = 1024
NB = 4
RTOL = 1e-9


@functools.lru_cache(maxsize=None)
def _case(kind):
    rng = np.random.default_rng(31 if kind == "1x1" else 32)
    tm = tc.templates(N, PRETRIG, kind)
    bank = tc.bank(N, PRETRIG, kind)
    c, m = tm.shape[:2]
    x = tc.noise(rng, NB, c, N, kind)
    for e in range(NB):
        amps = rng.uniform(20, 60, m) * np.sqrt(np.diag(bank.iw_matrix))
        x[e] += np.roll(np.einsum("cmn,m->cn", tm, amps),
                        int(rng.integers(-60, 60)), axis=-1)
    dev = {k: jnp.asarray(v) for k, v in bank.to_device(np.float64).items()}
    jb = jfb.device_bank_nxm(dev)
    tb = tfb.bank_nxm_to_torch(tfb.bank_nxm_from_jax(bank), "cpu",
                               torch.float64)
    vfft = jof.signal_fft(jnp.asarray(x))
    vr = tfft.rfft(torch.as_tensor(x))
    return dict(kind=kind, bank=bank, jb=jb, tb=tb, vfft=vfft, vr=vr, x=x)


@pytest.fixture(scope="module", params=["1x1", "2x2"])
def case(request):
    return _case(request.param)


def test_device_bank_matches_jax(case):
    jb, tb = case["jb"], case["tb"]
    nh = N // 2 + 1
    np.testing.assert_array_equal(tb["phi_h"].numpy(),
                                  np.asarray(jb.phi)[..., :nh])
    np.testing.assert_array_equal(tb["icsd_h"].numpy(),
                                  np.asarray(jb.icsd)[:nh])
    np.testing.assert_array_equal(tb["iw_matrix"].numpy(),
                                  np.asarray(jb.iw_matrix))
    np.testing.assert_array_equal(tb["w_matrix"].numpy(),
                                  np.asarray(jb.w_matrix))
    np.testing.assert_array_equal(tb["bin_w"].numpy(),
                                  jfb.half_bin_weights(N))


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               err_msg=what)


def test_nodelay_matches_jax(case):
    jb, tb = case["jb"], case["tb"]
    rj = jnxm.ofnxm_nodelay(case["vfft"], jb.phi, jb.iw_matrix, jb.icsd, FS)
    rt = tnxm.ofnxm_nodelay_half(case["vr"], tb["phi_h"], tb["iw_matrix"],
                                 tb["icsd_h"], tb["bin_w"], FS, N)
    assert tnxm.OFNxMResult._fields == jnxm.OFNxMResult._fields
    _close(rt.amps, rj.amps, "amps")
    _close(rt.chi2, rj.chi2, "chi2")
    np.testing.assert_array_equal(rt.t0.numpy(), np.asarray(rj.t0))
    _close(tnxm.chi2_base_nxm_half(case["vr"], tb["icsd_h"], tb["bin_w"],
                                   FS, N),
           jnxm.chi2_base_nxm(case["vfft"], jb.icsd, FS), "chi2_0")


def _window(lo, hi, outside=False):
    mask = np.zeros(N, bool)
    mask[lo:hi + 1] = True
    return ~mask if outside else mask


@pytest.mark.parametrize("window,interp", [
    (None, False), (None, True), ((PRETRIG - 62, PRETRIG + 62), False),
    ((PRETRIG - 62, PRETRIG + 62), True), ((PRETRIG + 5, PRETRIG + 30), False),
    ((0, PRETRIG), True)])
def test_withdelay_matches_jax(case, window, interp):
    jb, tb = case["jb"], case["tb"]
    mask = None if window is None else _window(*window)
    pre = PRETRIG - 24              # delays aligned off the group's point
    rj = jnxm.ofnxm_withdelay(case["vfft"], jb.phi, jb.w_matrix,
                              jb.iw_matrix, jb.icsd, pre, FS,
                              window_mask=mask, interpolate_t0=interp)
    rt = tnxm.ofnxm_withdelay_half(case["vr"], tb["phi_h"], tb["iw_matrix"],
                                   tb["icsd_h"], tb["bin_w"], pre, FS, N,
                                   window_mask=mask, interpolate_t0=interp)
    _close(rt.amps, rj.amps, "amps")
    _close(rt.chi2, rj.chi2, "chi2")
    if interp:
        np.testing.assert_allclose(rt.t0.numpy(), np.asarray(rj.t0),
                                   rtol=1e-9, atol=1e-15)
    else:
        np.testing.assert_array_equal(rt.t0.numpy(), np.asarray(rj.t0))


def test_q_timeseries_matches_jax(case):
    jb, tb = case["jb"], case["tb"]
    qj = jnxm._q_timeseries(case["vfft"], jb.phi, PRETRIG)
    qt = tnxm.q_timeseries_half(case["vr"], tb["phi_h"], PRETRIG, N)
    scale = np.abs(np.asarray(qj)).max()
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0,
                               atol=RTOL * scale)


NXMX2_WINDOWS = [((PRETRIG - 30, PRETRIG + 30), (PRETRIG - 10, PRETRIG + 60)),
                 ((PRETRIG - 3, PRETRIG + 4), (PRETRIG - 80, PRETRIG + 200)),
                 ((PRETRIG + 40, PRETRIG + 41), (PRETRIG - 5, PRETRIG + 5))]


@pytest.mark.parametrize("w1,w2", NXMX2_WINDOWS)
@pytest.mark.parametrize("chunk_rows", [None, 1, 5])
def test_ofnxmx2_matches_jax(w1, w2, chunk_rows):
    case = _case("2x2")             # NxMx2 needs two templates
    jb, tb = case["jb"], case["tb"]
    gids = np.array([0, 1])
    m1, m2 = _window(*w1), _window(*w2)
    pre = PRETRIG + 7
    (rj, _) = jnxm.ofnxmx2(case["vfft"], jb.s_fft, jb.icsd, gids, m1, m2,
                           pre, FS)
    plan = tnxm.nxmx2_plan(tfb.bank_nxm_from_jax(case["bank"]), gids, m1, m2)
    consts = tnxm.nxmx2_tensors(plan, "cpu", torch.float64)
    kw = {}
    if chunk_rows is not None:
        kw["scan_bytes"] = chunk_rows * NB * int(m2.sum()) * 2 * 8
    rt = tnxm.ofnxmx2_half(case["vr"], tb["phi_h"], tb["icsd_h"],
                           tb["bin_w"], consts, pre, FS, N, **kw)
    assert tnxm.OFNxMx2Result._fields == jnxm.OFNxMx2Result._fields
    _close(rt.amps, rj.amps, "amps")
    _close(rt.chi2, rj.chi2, "chi2")
    np.testing.assert_array_equal(rt.deltat.numpy(), np.asarray(rj.deltat))


def test_nxmx2_plan_inverts_each_delta_once():
    case = _case("2x2")
    gids = np.array([1, 0])
    m1, m2 = _window(PRETRIG - 20, PRETRIG + 20), _window(PRETRIG, PRETRIG
                                                          + 100)
    plan = tnxm.nxmx2_plan(tfb.bank_nxm_from_jax(case["bank"]), gids, m1, m2)
    w1, w2 = int(m1.sum()), int(m2.sum())
    assert plan.ip_index.shape == (w1, w2)
    assert plan.ip.shape[0] == w1 + w2 - 1
    # the pair (i1, i2) reads P(Δ = d2 − d1): the plan's inverse times the
    # P that JAX forms in its scan is the identity
    bank = case["bank"]
    s_f = np.moveaxis(bank.s_fft, -1, 0)
    js = np.einsum("kab,kbm->kam", bank.icsd, s_f)
    r = np.fft.ifft(np.einsum("kci,kcj->ijk", np.conj(s_f), js),
                    axis=-1).real / FS
    for i1, i2 in [(0, 0), (w1 - 1, w2 - 1), (7, 33)]:
        d = (plan.idx2[i2] - plan.idx1[i1]) % N
        p = np.array([[r[0, 0, 0], r[0, 1, d]], [r[1, 0, (N - d) % N],
                                                 r[1, 1, 0]]])
        np.testing.assert_allclose(plan.ip[plan.ip_index[i1, i2]] @ p,
                                   np.eye(2), atol=1e-9)
