"""The port's Levenberg–Marquardt and rftau pulse fit equal the JAX
package's.

- The two-pole residual's forward-mode Jacobian (``torch.func.jacfwd``)
  against ``jax.jacfwd`` at 1e-12 in float64, at parameters where the
  pulse starts inside the window, where it starts past it, and where a
  negative amplitude meets the ``max(pulse, 0)`` clip (zero derivative).
- ``ops/lm.batched_lm`` and ``levenberg_marquardt`` against the JAX ones
  on a batch of exponential fits: parameters, cost and covariance, and
  the accepted-step count exactly while every step is still far above the
  rounding level (5 iterations).
- ``ops/pulsefit.rftau`` against ``detprocess_tpu.ops.pulsefit.rftau`` on
  float64 two-pole pulses in noise (made with numpy from a seed), with
  and without a given t0 and from a precomputed spectrum: every result
  within RFTAU_RTOL. The two fits take 40 accept-or-reject decisions each;
  near the optimum a step's cost change is at the rounding level, so the
  last accepted steps may differ in the last bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from detprocess_tpu.ops import lm as jlm
from detprocess_tpu.ops import pulsefit as jpf
from detprocess_tpu_torch.ops import fft as tfft
from detprocess_tpu_torch.ops import lm as tlm
from detprocess_tpu_torch.ops import pulsefit as tpf

torch.set_num_threads(1)

FS = 1.25e6
N = 4096
NB = 4
RFTAU_RTOL = 1e-7


def _residual_pair(t0_index=2000, lw=800, uw=1600):
    rng = np.random.default_rng(5)
    t = np.arange(t0_index - lw, t0_index + uw, dtype=np.float64)
    y = rng.standard_normal(len(t)) * 1e-3

    def res_t(p):
        return tpf._twopole(torch.as_tensor(t), p[0], p[1], p[2],
                            p[3]) - torch.as_tensor(y)

    def res_j(p):
        return jpf._twopole(jnp.asarray(t), p[0], p[1], p[2], p[3]) - y

    return res_t, res_j


@pytest.mark.parametrize("params", [
    [30.0, 100.0, 1.0, 2000.0],        # pulse in the window
    [12.5, 400.0, 2e-6, 1500.3],       # starts before the window
    [-20.0, -80.0, 0.5, 2700.0],       # negative taus (|τ| used)
    [25.0, 90.0, -1.0, 2000.0],        # clipped: max(pulse, 0) = 0
    [30.0, 30.0000001, 1.0, 1999.5],   # nearly equal taus
])
def test_twopole_jacobian_matches_jax(params):
    res_t, res_j = _residual_pair()
    jt = jacfwd(res_t)(torch.tensor(params, dtype=torch.float64))
    jj = jax.jacfwd(res_j)(jnp.asarray(params))
    np.testing.assert_allclose(jt.numpy(), np.asarray(jj), rtol=1e-12,
                               atol=1e-12 * float(np.abs(jj).max()))
    if params[2] < 0:
        assert not jt.any()


def _exp_residual_t(p, t, y):
    return p[0] * torch.exp(-t / p[1]) + p[2] - y


def _exp_residual_j(p, t, y):
    return p[0] * jnp.exp(-t / p[1]) + p[2] - y


@pytest.mark.parametrize("max_iter", [5, 30])
def test_batched_lm_matches_jax(max_iter):
    rng = np.random.default_rng(8)
    t = np.tile(np.linspace(0.0, 5.0, 60), (NB, 1))
    truth = np.stack([rng.uniform(1, 3, NB), rng.uniform(0.5, 2, NB),
                      rng.uniform(-1, 1, NB)], axis=-1)
    y = (truth[:, :1] * np.exp(-t / truth[:, 1:2]) + truth[:, 2:]
         + rng.standard_normal(t.shape) * 0.01)
    x0 = np.tile([1.0, 1.0, 0.0], (NB, 1))
    rt = tlm.batched_lm(_exp_residual_t, torch.as_tensor(x0),
                        (torch.as_tensor(t), torch.as_tensor(y)),
                        max_iter=max_iter)
    rj = jlm.batched_lm(_exp_residual_j, jnp.asarray(x0),
                        (jnp.asarray(t), jnp.asarray(y)), max_iter=max_iter)
    assert tlm.LMResult._fields == jlm.LMResult._fields
    np.testing.assert_allclose(rt.params.numpy(), np.asarray(rj.params),
                               rtol=1e-9)
    np.testing.assert_allclose(rt.cost.numpy(), np.asarray(rj.cost),
                               rtol=1e-9)
    np.testing.assert_allclose(rt.cov.numpy(), np.asarray(rj.cov), rtol=1e-6,
                               atol=1e-12)
    assert rt.success.all()
    if max_iter == 5:
        # every step still lowers the cost well above the rounding level
        np.testing.assert_array_equal(rt.niter.numpy(), np.asarray(rj.niter))
    else:
        # at the optimum a step's cost change is at the rounding level, so
        # the two may accept a last few steps differently
        np.testing.assert_allclose(rt.params.numpy(), truth, atol=0.1)
        assert np.abs(rt.niter.numpy() - np.asarray(rj.niter)).max() <= 3
    one = tlm.levenberg_marquardt(_exp_residual_t, torch.as_tensor(x0[0]),
                                  (torch.as_tensor(t[0]),
                                   torch.as_tensor(y[0])), max_iter=max_iter)
    np.testing.assert_allclose(one.params.numpy(), rt.params[0].numpy(),
                               rtol=1e-12)


def _pulses(seed=9, t0=N // 2 - 10):
    """Two-pole pulses of rise 10–40 and fall 80–300 samples starting
    within ±20 samples of ``t0``, in white noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(N, dtype=np.float64)
    x = rng.standard_normal((NB, N)) * 2e-8
    truth = []
    for e in range(NB):
        rt, ft = rng.uniform(10, 40), rng.uniform(80, 300)
        start = t0 + rng.uniform(-20, 20)
        tp = t - start
        pulse = np.where(tp > 0, np.exp(-tp / ft) - np.exp(-tp / rt), 0.0)
        x[e] += rng.uniform(1e-6, 3e-6) * pulse / pulse.max()
        truth.append((rt, ft))
    return x, np.asarray(truth)


def _compare_rftau(got, want):
    assert tpf.RFTauResult._fields == jpf.RFTauResult._fields
    for field in tpf.RFTauResult._fields:
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=RFTAU_RTOL, err_msg=field)


@pytest.mark.parametrize("t0", [None, N // 2 + 30, 500])
def test_rftau_matches_jax(t0):
    x, truth = _pulses(t0=N // 2 - 10 if t0 is None else t0)
    want = jpf.rftau(jnp.asarray(x), FS, rtau0=30.0, ftau0=100.0,
                     t0_index=t0)
    got = tpf.rftau(torch.as_tensor(x), FS, rtau0=30.0, ftau0=100.0,
                    t0_index=t0)
    _compare_rftau(got, want)
    if t0 is None:
        # the RC filter (50 kHz) leaves the slow fall and smooths the rise
        np.testing.assert_allclose(got.falltime.numpy(), truth[:, 1],
                                   rtol=0.05)


def test_rftau_from_the_shared_spectrum():
    x, _ = _pulses(seed=10)
    xt = torch.as_tensor(x)
    want = tpf.rftau(xt, FS, rtau0=20.0, ftau0=150.0)
    got = tpf.rftau(xt, FS, rtau0=20.0, ftau0=150.0, spectrum=tfft.rfft(xt))
    for field in tpf.RFTauResult._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      getattr(want, field).numpy())
