"""The port's dIdV lock-in (``ops/lockin``) against the JAX package's
``ops/lockin.py``, in float64 on the CPU.

Traces come from the sweep configuration of ``entry.ivsweep_points``
(``entry.ivsweep_didv``: the response of a working point to the
100 Hz square wave at 1.25 MHz, 12500 samples a period, with white
noise), made from a seeded generator:

- ``fold_periods``;
- ``process_didv_traces`` at a normal, a transition and an SC point,
  with the cuts (one trace carries a step the cuts reject) and without;
- a response whose detected edge is the opposite switching edge (both
  edges score alike; the noise of seed 1 picks the other one), where the
  sign test flips dIdV;
- a short period of 16 samples, which has too few odd harmonics for the
  mid band and tests them all;
- the ValueError for a period that is no whole number of samples.

Every field of ``DIDVData`` within 1e-9 of JAX's (relative to the
field's largest |value|); the kept-trace and period counts exactly.
"""

import jax  # noqa: F401
import numpy as np
import pytest
import torch

from detprocess_tpu.ops import lockin as jlockin
from detprocess_tpu_torch import entry
from detprocess_tpu_torch.ops import lockin

torch.set_num_threads(1)

RTOL = 1e-9
FS, SGFREQ, SGAMP, RSH = entry.FS, entry.IV_SGFREQ, entry.IV_SGAMP, 5e-3
POINTS = entry.ivsweep_points()
CASES = {"normal": 0, "transition": 12, "sc": 30}


def _traces(k, nev=8, nper=3, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = entry.ivsweep_didv(gen, POINTS[k]["params"], nev, nper + 1,
                           "cpu").numpy()
    x = x[:, : nper * 12500]
    x[2, 5000:] += 2e-8                       # a step for the cuts
    return np.ascontiguousarray(x)


def _compare(got, want):
    for field in want._fields:
        g, w = np.asarray(getattr(got, field)), np.asarray(getattr(want,
                                                                  field))
        scale = max(float(np.abs(w).max()), 1e-300)
        np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * scale,
                                   err_msg=field)


def test_fold_periods():
    x = np.arange(2 * 25, dtype=float).reshape(2, 25)
    got = lockin.fold_periods(torch.as_tensor(x), 12)
    np.testing.assert_array_equal(got.numpy(), jlockin.fold_periods(x, 12))
    assert got.shape == (4, 12)


@pytest.mark.parametrize("cuts", [True, False])
@pytest.mark.parametrize("point", sorted(CASES))
def test_process_didv_traces(point, cuts):
    x = _traces(CASES[point])
    want = jlockin.process_didv_traces(x, FS, SGFREQ, SGAMP, RSH,
                                       apply_cuts=cuts)
    got = lockin.process_didv_traces(torch.as_tensor(x), FS, SGFREQ, SGAMP,
                                     RSH, apply_cuts=cuts)
    _compare(got, want)
    assert got.nb_traces_kept == (7 if cuts else 8)
    assert got.nb_periods == 3 * got.nb_traces_kept


def test_opposite_edge_flips_the_sign(monkeypatch):
    """The two switching edges score alike, so noise picks the one the
    square wave is aligned to; at seed 1 it is the opposite edge, and the
    sign test flips dIdV back (seed 0 needs no flip)."""
    tests = []
    average = np.average

    def recorded(a, weights=None):
        v = average(a, weights=weights)
        tests.append(bool(v < 0))
        return v

    x = _traces(CASES["transition"], seed=1)
    want = jlockin.process_didv_traces(x, FS, SGFREQ, SGAMP, RSH)
    monkeypatch.setattr(lockin.np, "average", recorded)
    got = lockin.process_didv_traces(torch.as_tensor(x), FS, SGFREQ, SGAMP,
                                     RSH)
    ref = lockin.process_didv_traces(
        torch.as_tensor(_traces(CASES["transition"])), FS, SGFREQ, SGAMP,
        RSH)
    monkeypatch.undo()
    assert tests == [True, False]
    _compare(got, want)
    # the same physics either way: dIdV is nearer the other seed's than
    # its negative at the well-measured low harmonics
    low = slice(0, 20)
    assert (np.abs(got.didv[low] - ref.didv[low])
            < np.abs(got.didv[low] + ref.didv[low])).all()


def test_short_period_tests_every_harmonic():
    rng = np.random.default_rng(1)
    t = np.arange(16 * 40)
    x = (np.where(t % 16 < 8, 1e-9, -1e-9)[None, :]
         + 1e-11 * rng.standard_normal((5, len(t))) + 2e-6)
    want = jlockin.process_didv_traces(x, 1600.0, 100.0, SGAMP, RSH)
    got = lockin.process_didv_traces(torch.as_tensor(x), 1600.0, 100.0,
                                     SGAMP, RSH)
    assert len(got.freqs) == 4
    _compare(got, want)


def test_non_integer_period_is_refused():
    x = torch.zeros((4, 1000), dtype=torch.float64)
    for fn in (lockin.process_didv_traces, jlockin.process_didv_traces):
        with pytest.raises(ValueError, match="integer number of samples"):
            fn(x if fn is lockin.process_didv_traces else x.numpy(),
               1000.0, 300.0, SGAMP, RSH)
