"""One long trace split in time over the port's mesh, against the JAX
package's ``sharded_longtrace_trigger`` on its 8-device virtual CPU mesh
and against the port's unsharded FIR, Δχ² and tiled merge: the
counterpart of tests/test_longtrace_sharded.py.

The same float64 trace (numpy, seeded) goes to both; pulses straddle
every shard boundary, and a pileup pair sits across one. Indices and
counts exactly; Δχ² and amplitudes at rtol 1e-8 (the sharded FIR's
overlap-save segments differ from the unsharded ones).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detprocess_tpu.models import pulse
from detprocess_tpu.ops import filterbank as jfb
from detprocess_tpu.ops import trigger as jtrig
from detprocess_tpu.parallel import mesh as jmesh
from detprocess_tpu_torch.ops import filterbank
from detprocess_tpu_torch.ops import trigger as trig
from detprocess_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

FS = 1.25e6
NT = 1024
PRETRIG = 256
THRESH_SIGMA = 6.0
RTOL = 1e-8


@pytest.fixture(scope="module")
def setup():
    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=10e-6,
                               tau_f1=100e-6)
    psd = np.full(NT, 4e-18)
    jbank = jfb.make_ofnxm_bank(tmpl, psd.astype(complex), FS, PRETRIG)
    bank = filterbank.make_ofnxm_bank(tmpl, psd.astype(complex), FS,
                                      PRETRIG)
    return dict(tmpl=tmpl, sigma=np.sqrt(psd[0] * FS),
                jkernel=jtrig.make_trigger_kernel(jbank,
                                                  real_dtype=np.float64),
                kernel=trig.make_trigger_kernel(bank, real_dtype=np.float64),
                thr=trig.chi2_threshold(THRESH_SIGMA, 1))


def _trace(s, l_glob, n_shards, seed):
    """Noise, interior pulses, one whose FIR response straddles each
    boundary, and a pileup pair across the first boundary."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(l_glob) * s["sigma"]
    l_loc = l_glob // n_shards
    pos = list(range(20_000, l_glob - 20_000, 23_117))
    pos += [k * l_loc - NT // 3 for k in range(1, n_shards)]
    pos += [l_loc - 30, l_loc + 40]
    for t0 in pos:
        x[t0 - PRETRIG: t0 - PRETRIG + NT] += 3e-6 * s["tmpl"]
    return x, pos


def _unsharded(s, x, window, capacity=4096):
    xt = torch.as_tensor(x[None, :])
    q = trig.of_fir(xt, s["kernel"])
    d, a = trig.delta_chi2(q, s["kernel"].iw_matrix)
    return trig.find_triggers_kernel(d, a, s["thr"], window, capacity)


def _port(s, x, n_shards, window, capacity=512):
    m = pmesh.make_mesh(n_shards, device="cpu")
    out = pmesh.sharded_longtrace_trigger(m, s["kernel"], s["thr"], window,
                                          capacity)(
        pmesh.shard_time(m, torch.as_tensor(x[None, :])))
    return out, pmesh.merge_sharded_triggers(out.indices, out.dchi2,
                                             out.amplitudes)


def _jax(s, x, n_shards, window, capacity=512):
    jm = jmesh.make_mesh(n_shards)
    fn = jmesh.sharded_longtrace_trigger(jm, s["jkernel"], s["thr"], window,
                                         capacity)
    xs = jax.device_put(jnp.asarray(x[None, :]), jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec(None, jmesh.EVENTS_AXIS)))
    idx, d, a, cnt = fn(xs)
    return jmesh.merge_sharded_triggers(idx, d, a), np.asarray(cnt)


@pytest.mark.parametrize("window", [125, 3])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_equals_jax_and_unsharded(setup, n_shards, window):
    l_glob = 8 * 32768
    x, pos = _trace(setup, l_glob, n_shards, 99)
    ref = _unsharded(setup, x, window)
    k = int(ref.count)
    out, (g_idx, g_d, g_a) = _port(setup, x, n_shards, window)
    (j_idx, j_d, j_a), j_cnt = _jax(setup, x, n_shards, window)

    np.testing.assert_array_equal(g_idx, ref.indices[:k].numpy())
    np.testing.assert_allclose(g_d, ref.dchi2[:k].numpy(), rtol=RTOL)
    np.testing.assert_allclose(g_a, ref.amplitudes[:, :k].numpy(),
                               rtol=RTOL)
    np.testing.assert_array_equal(g_idx, j_idx)
    np.testing.assert_allclose(g_d, j_d, rtol=RTOL)
    np.testing.assert_allclose(g_a, j_a, rtol=RTOL)
    np.testing.assert_array_equal(out.count.numpy(), j_cnt)
    assert int(out.count_total) == int(ref.count_total) == k

    found = set(int(i) for i in g_idx)
    for t0 in pos:
        assert any(abs(t0 - i) <= 450 for i in found), t0
    for t0 in pos[:3]:
        assert any(abs(t0 - i) <= 6 for i in found), t0


@pytest.mark.parametrize("window", [125, 3])
def test_boundary_group_single_winner(setup, window):
    """A dense above-threshold run across a boundary merges (window 125)
    into one trigger at its maximum, on the shard after the boundary."""
    n_shards, l_glob = 4, 4 * 65536
    b = 2 * (l_glob // n_shards)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(l_glob) * setup["sigma"]
    amps = [2e-6, 3e-6, 8e-6, 4e-6, 2.5e-6, 2e-6]
    for k, t0 in enumerate(range(b - 120, b + 181, 60)):
        x[t0 - PRETRIG: t0 - PRETRIG + NT] += amps[k] * setup["tmpl"]
    ref = _unsharded(setup, x, window)
    _, (g_idx, g_d, _) = _port(setup, x, n_shards, window, 64)
    (j_idx, _, _), _ = _jax(setup, x, n_shards, window, 64)
    np.testing.assert_array_equal(g_idx, ref.indices[:int(ref.count)])
    np.testing.assert_array_equal(g_idx, j_idx)
    if window == 125:
        winner = b - 120 + 2 * 60
        in_comb = [i for i in g_idx if b - 200 < i < b + 260]
        assert len(in_comb) == 1 and abs(int(in_comb[0]) - winner) <= 2


def _merge_on_shards(d, a, n_shards, window, capacity=64):
    """ops/trigger.find_triggers_sharded on the time shards of Δχ² d [L]
    and amplitudes a [M, L], merged into one list."""
    m = pmesh.make_mesh(n_shards, device="cpu")
    l_loc = d.shape[-1] // n_shards
    sets = trig.find_triggers_sharded(
        m, list(torch.as_tensor(d).split(l_loc)),
        list(torch.as_tensor(a).split(l_loc, dim=-1)), 1.0, window,
        capacity, [k * l_loc for k in range(n_shards)])
    return sets, pmesh.merge_sharded_triggers(
        torch.cat([s.indices for s in sets]),
        torch.cat([s.dchi2 for s in sets]),
        torch.cat([s.amplitudes for s in sets], dim=-1))


@pytest.mark.parametrize("window", [125, 3])
@pytest.mark.parametrize("peak_shard", [0, 1, 2, 3])
def test_group_spanning_shards_without_a_start(peak_shard, window):
    """An above-threshold run from shard 0 through shards 1 and 2 (which
    hold no group start of their own) into shard 3 is one group with one
    winner, wherever its maximum lies; with the maximum reached twice, the
    first position wins. Δχ² made directly (threshold 1), beside isolated
    groups on every shard."""
    n_shards, l_loc = 8, 4096
    rng = np.random.default_rng(21 + peak_shard)
    d = rng.uniform(0.0, 0.9, n_shards * l_loc)
    lo, hi = l_loc - 300, 3 * l_loc + 500
    d[lo:hi] = rng.uniform(1.5, 5.0, hi - lo)
    peak = {0: l_loc - 100, 1: l_loc + 2000, 2: 2 * l_loc + 7,
            3: 3 * l_loc + 400}[peak_shard]
    d[peak] = 9.0
    if peak + l_loc // 2 < hi:         # the maximum again, later on
        d[peak + l_loc // 2] = 9.0
    singles = [k * l_loc + 2048 for k in (0, 4, 5, 6, 7)]
    d[singles] = 3.0
    a = np.stack([d * 2.0, -d])
    ref = trig.find_triggers_kernel(torch.as_tensor(d),
                                    torch.as_tensor(a), 1.0, window, 64)
    sets, (g_idx, g_d, g_a) = _merge_on_shards(d, a, n_shards, window)
    k = int(ref.count)
    np.testing.assert_array_equal(g_idx, ref.indices[:k].numpy())
    np.testing.assert_array_equal(g_d, ref.dchi2[:k].numpy())
    np.testing.assert_array_equal(g_a, ref.amplitudes[:, :k].numpy())
    assert int(sets[0].count_total) == int(ref.count_total) == k
    in_run = [int(i) for i in g_idx if lo <= i < hi]
    assert in_run == [peak]
    assert sorted(set(g_idx.tolist()) - set(in_run)) == singles
    # shards 1 and 2 lie inside the group: no winner unless it is there
    for s in (1, 2):
        assert int(sets[s].count) == int(peak // l_loc == s)


@pytest.mark.parametrize("window", [125, 3])
def test_count_total_is_global(setup, window):
    x, _ = _trace(setup, 8 * 32768, 8, 17)
    out, (g_idx, _, _) = _port(setup, x, 8, window)
    ref = _unsharded(setup, x, window)
    assert int(out.count.sum()) == len(g_idx) == int(out.count_total)
    assert int(out.count_total) == int(ref.count_total)


def test_refusals(setup):
    m = pmesh.make_mesh(4, device="cpu")
    fn = pmesh.sharded_longtrace_trigger(m, setup["kernel"], setup["thr"],
                                         125, 16)
    with pytest.raises(ValueError, match="smaller than the template"):
        fn(pmesh.shard_time(m, torch.zeros(1, 4 * 512, dtype=torch.float64)))
    with pytest.raises(ValueError, match="multiple of the merge tile"):
        fn(pmesh.shard_time(m, torch.zeros(1, 4 * 1056, dtype=torch.float64)))
    with pytest.raises(ValueError, match="evenly"):
        pmesh.shard_time(m, torch.zeros(1, 4 * 1024 + 2))
