"""The port's mesh (``detprocess_tpu_torch/parallel``) against the JAX
package's on its 8-device virtual CPU mesh (tests/conftest.py), the
counterpart of tests/test_parallel.py.

Both sides get the same float64 inputs made with numpy from a seed; the
port runs on virtual CPU shards (``make_mesh(n, device="cpu")``).
Tolerances: spectra and trigger values at rtol 1e-9, trigger indices and
counts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detprocess_tpu.models import pulse as jpulse
from detprocess_tpu.ops import filterbank as jfb
from detprocess_tpu.ops import spectral as jspectral
from detprocess_tpu.ops import trigger as jtrig
from detprocess_tpu.parallel import mesh as jmesh
from detprocess_tpu_torch import entry
from detprocess_tpu_torch.ops import filterbank, spectral
from detprocess_tpu_torch.ops import trigger as trig
from detprocess_tpu_torch.parallel import collectives, mesh as pmesh

torch.set_num_threads(1)

FS = 1.25e6
N = 1024
RTOL = 1e-9
SHARDS = [1, 2, 8]


def _traces(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("nd", SHARDS)
def test_sharded_psd_matches_jax(nd):
    x = _traces((16, N), 0)
    jm = jmesh.make_mesh(nd)
    want = np.asarray(jmesh.sharded_psd(jm, FS)(
        jmesh.shard_batch(jm, jnp.asarray(x))))
    m = pmesh.make_mesh(nd, device="cpu")
    got = pmesh.sharded_psd(m, FS)(pmesh.shard_batch(m, torch.as_tensor(x)))
    assert got.dtype == torch.float64 and got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("nd", SHARDS)
def test_sharded_csd_matches_jax(nd):
    x = _traces((16, 2, N), 2)
    jm = jmesh.make_mesh(nd)
    out = np.asarray(jmesh.sharded_csd(jm, FS)(
        jmesh.shard_batch(jm, jnp.asarray(x))))
    want = out[..., 0] + 1j * out[..., 1]
    m = pmesh.make_mesh(nd, device="cpu")
    got = pmesh.sharded_csd(m, FS)(pmesh.shard_batch(m, torch.as_tensor(x)))
    assert got.dtype == torch.complex128 and got.shape == (2, 2, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.fixture(scope="module")
def trigger_case():
    nt, pretrig, l, e = 1024, 256, 65536, 8
    template = jpulse.make_template(FS, nt, pretrig, A=1.0, tau_r=20e-6,
                                    tau_f1=200e-6)
    psd = np.full(nt, 4e-18)
    jbank = jfb.make_ofnxm_bank(template, psd.astype(complex), FS, pretrig)
    bank = filterbank.make_ofnxm_bank(template, psd.astype(complex), FS,
                                      pretrig)
    thr = float(trig.chi2_threshold(5.0, 1))
    rng = np.random.default_rng(7)
    traces = rng.standard_normal((e, 1, l)) * np.sqrt(psd[0] * FS)
    for k in range(e):
        pos = 5000 + 7000 * k
        traces[k, 0, pos - pretrig:pos - pretrig + nt] += 1e-5 * template
    return dict(
        jkernel=jtrig.make_trigger_kernel(jbank, real_dtype=np.float64),
        kernel=trig.make_trigger_kernel(bank, real_dtype=np.float64),
        thr=thr, traces=traces)


@pytest.mark.parametrize("nd", SHARDS)
def test_sharded_trigger_matches_jax(trigger_case, nd):
    c = trigger_case
    jm = jmesh.make_mesh(nd)
    idx, dchi2, amps, count = (np.asarray(a) for a in jmesh.sharded_trigger(
        jm, c["jkernel"], c["thr"], 125, 64)(
        jmesh.shard_batch(jm, jnp.asarray(c["traces"]))))
    m = pmesh.make_mesh(nd, device="cpu")
    ts = pmesh.sharded_trigger(m, c["kernel"], c["thr"], 125, 64)(
        pmesh.shard_batch(m, torch.as_tensor(c["traces"])))
    np.testing.assert_array_equal(ts.count.numpy(), count)
    for e in range(len(count)):
        k = int(count[e])
        assert k >= 1
        np.testing.assert_array_equal(ts.indices[e, :k].numpy(),
                                      idx[e, :k])
        np.testing.assert_allclose(ts.dchi2[e, :k].numpy(), dchi2[e, :k],
                                   rtol=RTOL)
        np.testing.assert_allclose(ts.amplitudes[e, :, :k].numpy(),
                                   amps[e, :, :k], rtol=RTOL)
        j = int(np.argmin(np.abs(idx[e, :k] - (5000 + 7000 * e))))
        assert abs(int(idx[e, j]) - (5000 + 7000 * e)) <= 5


def test_uneven_and_empty_shards_give_the_unsharded_result(trigger_case):
    """Batches that do not divide (5 rows on 8 shards: three empty) take
    the unsharded result, where the JAX package pads."""
    x = torch.as_tensor(_traces((5, N), 3))
    m = pmesh.make_mesh(8, device="cpu")
    parts = pmesh.shard_batch(m, x)
    assert [p.shape[0] for p in parts] == [1, 1, 1, 1, 1, 0, 0, 0]
    np.testing.assert_allclose(pmesh.sharded_psd(m, FS)(parts).numpy(),
                               spectral.welch_psd(x, FS).numpy(), rtol=RTOL)
    x2 = torch.as_tensor(_traces((7, 3, N), 4))
    parts2 = pmesh.shard_batch(pmesh.make_mesh(3, device="cpu"), x2)
    assert [p.shape[0] for p in parts2] == [3, 2, 2]
    np.testing.assert_allclose(
        pmesh.sharded_csd(pmesh.make_mesh(3, device="cpu"), FS)(
            parts2).numpy(), spectral.welch_csd(x2, FS).numpy(), rtol=RTOL,
        atol=1e-15)
    c = trigger_case
    ev = torch.as_tensor(c["traces"][:3])
    q, _ = trig.of_fir_blocks(ev, c["kernel"])
    d, a = trig.delta_chi2_blocks(q, c["kernel"].iw_matrix)
    want = trig.find_triggers_blocks(d, a, c["thr"], 125, 64)
    m4 = pmesh.make_mesh(4, device="cpu")
    got = pmesh.sharded_trigger(m4, c["kernel"], c["thr"], 125, 64)(
        pmesh.shard_batch(m4, ev))
    for f in ("indices", "count", "count_total"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f).numpy())
    np.testing.assert_allclose(got.dchi2.numpy(), want.dchi2.numpy(),
                               rtol=1e-12)


def test_sharded_map_and_replicate_are_shard_invariant():
    """The feature step per shard (banks replicated, one copy a device)
    gives the same columns on 1, 2 and 8 shards."""
    bank, template, _ = entry.build_bank(N, N // 2)
    x = torch.as_tensor(_traces((16, N), 5) * 1e-8 + 2e-6 * template)
    outs = []
    for nd in SHARDS:
        m = pmesh.make_mesh(nd, device="cpu")
        banks = pmesh.replicate(m, filterbank.bank_to_torch(
            bank, "cpu", torch.float64))
        assert all(b is banks[0] for b in banks)     # virtual shards share
        run = pmesh.sharded_map(
            m, lambda b, bk: entry.FeatureStep(bk, ["chan1"], FS, N // 2, N)(
                b[:, None, :]))
        outs.append(pmesh.unshard(m, run(pmesh.shard_batch(m, x), banks)))
    for out in outs[1:]:
        for k, v in outs[0].items():
            np.testing.assert_allclose(out[k].numpy(), v.numpy(),
                                       rtol=1e-12, err_msg=k)


def test_collectives_order_and_edges():
    m = pmesh.make_mesh(4, device="cpu")
    vals = [torch.tensor([float(i)]) for i in range(4)]
    assert collectives.all_gather(m, vals)[:, 0].tolist() == [0, 1, 2, 3]
    assert float(collectives.psum(m, vals)) == 6.0
    left = collectives.ppermute(m, vals, 1)
    right = collectives.ppermute(m, vals, -1)
    assert left[0] is None and [float(v) for v in left[1:]] == [0, 1, 2]
    assert right[-1] is None and [float(v) for v in right[:-1]] == [1, 2, 3]
    with pytest.raises(ValueError, match="neighbour"):
        collectives.ppermute(m, vals, 2)
    assert collectives.bounds(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]


def test_make_mesh_refuses_overasking_on_cuda(monkeypatch):
    """More CUDA devices than exist is an error naming the count, not a
    silent clamp (JAX ``make_mesh``); no mesh is made on the CPU unless the
    caller asks for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="only 2 CUDA device"):
        pmesh.make_mesh(3)
    with pytest.raises(ValueError, match="only 2 CUDA device"):
        pmesh.make_mesh(4, device="cuda")
    m = pmesh.make_mesh(2)
    assert m.devices == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert len(pmesh.make_mesh()) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh(2)
    cpu = pmesh.make_mesh(3, device="cpu")
    assert cpu.devices == [torch.device("cpu")] * 3 and cpu.size == 3


def test_mesh_refusals():
    m = pmesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="evenly"):
        pmesh.shard_time(m, torch.zeros(1, 1001))
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        collectives.check_mesh(object(), torch.device("cpu"))
    with pytest.raises(ValueError, match="shards for a caller on"):
        collectives.check_mesh(m, torch.device("cuda", 0))


@pytest.mark.parametrize("nd", [4, 8])
def test_dryrun_multichip(nd):
    out = entry.dryrun_multichip(nd, device="cpu")
    assert out["feature_events"] == 4 * nd
    assert out["triggers"] >= 4 * nd
    assert out["longtrace_triggers"] >= nd
    assert out["shell_triggers"] >= 2 * (nd + 1)
    assert out["coincidence_merges"] == nd + 1


def test_jax_mesh_has_eight_devices():
    assert len(jax.devices()) == 8
