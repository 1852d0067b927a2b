"""The port's windowed trace statistics equal the JAX package's.

Both sides reduce ``trace[min:max]`` (max exclusive, default
``nb_samples - 1``); inputs are float64, compared at 1e-12.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from detprocess_tpu.ops import tracestats as jts
from detprocess_tpu_torch.ops import tracestats as tts

torch.set_num_threads(1)

FS = 1.25e6
TOL = 1e-12
WINDOWS = [(0, None), (100, 900), (0, 1024), (512, 513)]


@pytest.fixture(scope="module")
def traces():
    rng = np.random.default_rng(3)
    return rng.standard_normal((6, 2, 1024)) * 1e-7 + 3e-7


def _cmp(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL * 1e-7)


@pytest.mark.parametrize("name", ["baseline", "maximum", "minimum"])
@pytest.mark.parametrize("lo,hi", WINDOWS)
def test_window_stat_matches_jax(traces, name, lo, hi):
    got = getattr(tts, name)(torch.as_tensor(traces), lo, hi)
    ref = getattr(jts, name)(jnp.asarray(traces), lo, hi)
    assert got.shape == traces.shape[:-1]
    _cmp(got, ref)


@pytest.mark.parametrize("lo,hi", WINDOWS)
def test_integral_matches_jax(traces, lo, hi):
    got = tts.integral(torch.as_tensor(traces), FS, lo, hi)
    ref = jts.integral(jnp.asarray(traces), FS, lo, hi)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL * 1e-13)


@pytest.mark.parametrize("lo,hi", [(200, None), (200, 800), (1, 2)])
def test_energyabsorbed_matches_jax(traces, lo, hi):
    args = (FS, 2e-6, 1e-6, 5e-3)
    got = tts.energyabsorbed(torch.as_tensor(traces), *args, lo, hi)
    ref = jts.energyabsorbed(jnp.asarray(traces), *args, lo, hi)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-30)


def test_default_window_excludes_last_sample():
    x = torch.zeros(1, 8, dtype=torch.float64)
    x[0, -1] = 100.0
    assert float(tts.baseline(x)) == 0.0
    assert float(tts.maximum(x)) == 0.0
    assert float(tts.integral(x, 1.0)) == 0.0
