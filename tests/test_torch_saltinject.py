"""The port's salt injection (ops/saltinject.py) and energy normalization
against the JAX package's.

Inputs come from a numpy seed: a trace batch of 2 channels × 1000
samples and a 64-sample template with a non-zero head (random values,
pretrigger 16), so that every clipped sample shows. Salts are placed by
hand: a start below −N, in [−N, 0), inside the trace and past its end,
each on both channels and beside a second salt inside the trace, with
and without a window start, with the rows in the file's channel order and
permuted.

Tolerances:

- the port's ``inject_salts`` (float64) against the JAX host injector
  ``Salting.inject_raw_salt``: 1e-12 of the largest |value|;
- the port's host injector against the JAX one: exact;
- the port against JAX ``inject_salts`` (float32): 1e-6 of the largest
  |value|, in the cases where JAX is right (no template sample lands in
  [−N, 0));
- ``energy_normalization``: 1e-12 relative.

Two tests show the reference faults the port does not copy (ROADMAP.md
§3): JAX ``inject_salts`` wraps a start in [−N, 0) to the end of the
trace, and JAX's planner gives a window's salt no slot once salts far
outside the window fill ``max_salts_per_event``. In both the JAX device
path differs from its host path and the port agrees with the host path.
"""

import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from detprocess_tpu.io.filterfile import FilterData as JaxFilterData
from detprocess_tpu.models import didv as jdidv
from detprocess_tpu.ops import saltinject as jsi
from detprocess_tpu.pipelines.salting import Salting as JaxSalting
from detprocess_tpu_torch.io.filterdata import FilterData
from detprocess_tpu_torch.models import didv
from detprocess_tpu_torch.ops import saltinject
from detprocess_tpu_torch.pipelines.salting import Salting

torch.set_num_threads(1)

FS = 1.25e6
N = 1000
NT = 64
PRE = 16
CHANNELS = ["chan1", "chan2"]
SERIES = 120260901120000
# template starts (sample 0) in trace coordinates
STARTS = {"below -N": -N - 40, "in [-N, 0)": -30, "inside": 400,
          "past the end": N - 20}
WINDOW_START = 300


def _template(seed):
    return np.random.default_rng(seed).standard_normal(NT) + 0.5


def _filter_data(cls):
    fd = cls(verbose=False)
    for i, chan in enumerate(CHANNELS):
        fd.set_template(chan, _template(i), FS, pretrigger_length_samples=PRE)
    return fd


def _salts(start, ws=0):
    """Salts of event 1: both channels at ``start`` (chan2 7 samples
    later), chan1 once more inside the trace; one salt of event 2."""
    ti = np.array([start, start + 7, 500, 600]) + PRE + ws
    return {"series_number": np.full(4, SERIES, np.int64),
            "event_number": np.array([1, 1, 1, 2], np.int64),
            "salt_channel": np.array(["chan1", "chan2", "chan1", "chan1"],
                                     dtype=object),
            "salt_template_tag": np.array(["default"] * 4, dtype=object),
            "salt_amplitude": np.array([1.5, -2.0, 0.75, 3.0]),
            "salt_energy_ev": np.full(4, 10.0),
            "trigger_index": ti.astype(np.int64)}


def _both(table):
    port = Salting(_filter_data(FilterData), verbose=False)
    port.set_dataframe(table)
    ref = JaxSalting(_filter_data(JaxFilterData), verbose=False)
    ref.set_dataframe(pd.DataFrame(table))
    return port, ref


def _port_inject(port, traces, rows, ws=None, k=16, events=(1,)):
    inj = port.make_device_injector(CHANNELS, max_salts_per_event=k)
    plan = inj.plan([SERIES] * len(events), list(events), traces.shape[-1],
                    window_starts=ws, channels=rows)
    x = torch.tensor(traces)
    saltinject.inject_salts(x, *plan.to("cpu"),
                            torch.as_tensor(inj.templates, dtype=x.dtype))
    return x.numpy()


def _jax_inject(ref, traces, rows, ws=None, k=16):
    inj = ref.make_device_injector(rows, max_salts_per_event=k)
    plan = inj.plan([{"series_number": SERIES, "event_number": 1}],
                    window_starts=ws)
    return np.asarray(jsi.inject_salts(
        jnp.asarray(traces.astype(np.float32)), jnp.asarray(plan.idx),
        jnp.asarray(plan.chan), jnp.asarray(plan.tid),
        jnp.asarray(plan.amp), jnp.asarray(inj.templates)))


ADMIN = {"series_number": SERIES, "event_number": 1}
CASES = [(where, ws, perm) for where in STARTS for ws in (None, WINDOW_START)
         for perm in (False, True)]


@pytest.mark.parametrize("where,ws,perm", CASES)
def test_inject_salts_matches_the_host_injector(where, ws, perm):
    table = _salts(STARTS[where], ws or 0)
    port, ref = _both(table)
    rows = CHANNELS[::-1] if perm else CHANNELS
    traces = np.random.default_rng(7).standard_normal((1, 2, N))
    got = _port_inject(port, traces, rows,
                       None if ws is None else [ws])
    want = ref.inject_raw_salt(traces[0], ADMIN, rows,
                               window_start=ws or 0)
    np.testing.assert_allclose(got[0], want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    # the clipping: nothing added outside the template's span in the trace
    s = STARTS[where]
    added = got[0] - traces[0]
    first = rows.index("chan1")
    lo, hi = max(s, 0), min(s + NT, N)
    outside = np.ones(N, bool)
    outside[lo:max(lo, hi)] = False
    outside[500 - 0:500 + NT] = False
    assert not added[first, outside].any()
    # the port's host injector: the same arithmetic, exactly
    host = port.make_injector(CHANNELS)(traces[0], ADMIN,
                                        window_start=ws or 0, channels=rows)
    np.testing.assert_array_equal(host, want)


@pytest.mark.parametrize("where,ws,perm", [
    c for c in CASES if c[0] in ("inside", "past the end")])
def test_inject_salts_matches_jax_where_jax_is_right(where, ws, perm):
    table = _salts(STARTS[where], ws or 0)
    port, ref = _both(table)
    rows = CHANNELS[::-1] if perm else CHANNELS
    traces = np.random.default_rng(8).standard_normal((1, 2, N))
    wss = None if ws is None else [ws]
    got = _port_inject(port, traces, rows, wss)
    want = _jax_inject(ref, traces, rows, wss)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_reference_fault_negative_start_wraps_in_jax():
    """A start in [−N, 0): JAX's drop-mode scatter wraps the template's
    head to the trace's end; the host injector and the port clip it."""
    port, ref = _both(_salts(STARTS["in [-N, 0)"]))
    traces = np.zeros((1, 2, N))
    host = ref.inject_raw_salt(traces[0], ADMIN, CHANNELS)
    dev = _jax_inject(ref, traces, CHANNELS)[0]
    got = _port_inject(port, traces, CHANNELS)[0]
    tail = slice(N - 30, N)
    assert not host[0, tail].any()
    np.testing.assert_allclose(dev[0, tail], 1.5 * _template(0)[:30],
                               rtol=1e-6)
    np.testing.assert_array_equal(got, host)


def test_reference_fault_window_loses_its_salt_to_overflow(capsys):
    """Windowed mode, max_salts_per_event=2: two salts of the event far
    outside the window come first in the table. JAX gives them the slots
    and drops the window's own salt; the port gives slots only to salts
    that overlap the window, as the host injector sees them."""
    ti = np.array([5000, 9000, 20000]) + PRE
    table = {"series_number": np.full(3, SERIES, np.int64),
             "event_number": np.ones(3, np.int64),
             "salt_channel": np.array(["chan1"] * 3, dtype=object),
             "salt_template_tag": np.array(["default"] * 3, dtype=object),
             "salt_amplitude": np.array([1.0, 2.0, 4.0]),
             "salt_energy_ev": np.full(3, 10.0),
             "trigger_index": ti.astype(np.int64)}
    port, ref = _both(table)
    ws = 20000 - 100
    traces = np.zeros((1, 2, N))
    host = ref.inject_raw_salt(traces[0], ADMIN, CHANNELS, window_start=ws)
    dev = _jax_inject(ref, traces, CHANNELS, [ws], k=2)[0]
    assert "max_salts_per_event" in capsys.readouterr().out
    got = _port_inject(port, traces, CHANNELS, [ws], k=2)[0]
    assert capsys.readouterr().out == ""
    assert host[0].any() and not dev.any()
    np.testing.assert_array_equal(got, host)


def test_overflow_warns_and_keeps_the_first_salts(capsys):
    """Beyond max_salts_per_event the planner drops the later salts of an
    event, with JAX's warning."""
    port, _ = _both(_salts(STARTS["inside"]))
    inj = port.make_device_injector(CHANNELS, max_salts_per_event=1)
    plan = inj.plan([SERIES, SERIES], [1, 2], N)
    assert "2 salts dropped" in capsys.readouterr().out
    assert plan.idx.shape == (2, 1)
    np.testing.assert_array_equal(plan.amp[:, 0], [1.5, 3.0])


def test_salts_of_other_channels_and_events_are_left_out():
    """Salts on a channel outside the injector's list or the uploaded rows,
    and events without salts, add nothing."""
    port, _ = _both(_salts(STARTS["inside"]))
    inj = port.make_device_injector(["chan1"])
    plan = inj.plan([SERIES, SERIES, 7], [1, 3, 1], N,
                    channels=["chan2", "chan1"])
    assert plan.amp.shape == (3, 2)
    np.testing.assert_array_equal(plan.amp, [[1.5, 0.75], [0, 0], [0, 0]])
    np.testing.assert_array_equal(plan.chan[0], [1, 1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_energy_normalization_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 512
    tmpl = np.abs(rng.standard_normal(n)).cumsum()[::-1].copy()
    dpdi = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got = didv.energy_normalization(tmpl, dpdi, FS)
    want = jdidv.energy_normalization(tmpl, dpdi, FS)
    assert got == pytest.approx(want, rel=1e-12)
    np.testing.assert_allclose(didv.convert_template_to_power(tmpl, dpdi),
                               jdidv.convert_template_to_power(tmpl, dpdi),
                               rtol=1e-12, atol=0)
