"""The port's mesh over two processes: ``parallel/multihost.initialize``
(``torch.distributed`` with gloo on a local coordinator) and
``global_mesh`` of 2 processes × 2 virtual CPU shards, the counterpart of
tests/test_multihost.py.

Each worker makes the same float64 inputs from one seed, takes its own
shards of them, and holds the sharded PSD and the time-sharded long trace
over the 4 global shards against the one-process runs of the same inputs:
the PSD at rtol 1e-10, the long trace's indices and counts exactly and its
values at rtol 1e-8. A worker that fails or outlives its 120 s fails the
test; the workers import no JAX.
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = r"""
import sys
import numpy as np
import torch

from detprocess_tpu_torch.models import pulse
from detprocess_tpu_torch.ops import filterbank, spectral
from detprocess_tpu_torch.ops import trigger as trig
from detprocess_tpu_torch.parallel import collectives, multihost
from detprocess_tpu_torch.parallel import mesh as pmesh

pid, port = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
group = multihost.initialize(f"127.0.0.1:{port}", num_processes=2,
                             process_id=pid, backend="gloo",
                             timeout_sec=100)
assert group is not None
mesh = multihost.global_mesh(["cpu", "cpu"])
assert (mesh.size, mesh.offset, mesh.backend) == (4, 2 * pid, "gloo"), mesh

fs = 1.25e6
rng = np.random.default_rng(1234)            # the same inputs everywhere
traces = torch.as_tensor(rng.standard_normal((18, 256)))
psd = pmesh.sharded_psd(mesh, fs)(pmesh.shard_batch(mesh, traces))
np.testing.assert_allclose(psd.numpy(),
                           spectral.welch_psd(traces, fs).numpy(),
                           rtol=1e-10)

nt, pre = 1024, 256
tmpl = pulse.make_template(fs, nt, pre, A=1.0, tau_r=10e-6, tau_f1=100e-6)
level = 4e-18
bank = filterbank.make_ofnxm_bank(tmpl, np.full(nt, level).astype(complex),
                                  fs, pre)
kernel = trig.make_trigger_kernel(bank, real_dtype=np.float64)
thr = trig.chi2_threshold(6.0, 1)
l_loc = 16384
x = rng.standard_normal(4 * l_loc) * np.sqrt(level * fs)
for t0 in [5000, l_loc - 300, 2 * l_loc - 30, 2 * l_loc + 40,
           3 * l_loc + 100, 60000]:
    x[t0 - pre:t0 - pre + nt] += 3e-6 * tmpl
for window in (125, 3):
    out = pmesh.sharded_longtrace_trigger(mesh, kernel, thr, window, 64)(
        pmesh.shard_time(mesh, torch.as_tensor(x[None, :])))
    parts = collectives.gather_host(mesh, (
        out.indices.numpy(), out.dchi2.numpy(), out.amplitudes.numpy()))
    idx, d, a = pmesh.merge_sharded_triggers(
        np.concatenate([p[0] for p in parts]),
        np.concatenate([p[1] for p in parts]),
        np.concatenate([p[2] for p in parts], axis=-1))
    q = trig.of_fir(torch.as_tensor(x[None, :]), kernel)
    dd, aa = trig.delta_chi2(q, kernel.iw_matrix)
    ref = trig.find_triggers_kernel(dd, aa, thr, window, 256)
    k = int(ref.count)
    np.testing.assert_array_equal(idx, ref.indices[:k].numpy())
    np.testing.assert_allclose(d, ref.dchi2[:k].numpy(), rtol=1e-8)
    np.testing.assert_allclose(a, ref.amplitudes[:, :k].numpy(), rtol=1e-8)
    assert int(out.count_total) == int(ref.count_total) == k
print(f"WORKER{pid} OK {k}")
"""


def test_two_process_gloo_mesh(tmp_path):
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(worker_py), str(pid), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multi-process workers timed out:\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"WORKER{pid} OK" in out, out


def test_initialize_is_a_no_op_for_one_process():
    from detprocess_tpu_torch.parallel import multihost
    assert multihost.initialize() is None
    assert multihost.initialize(num_processes=1) is None
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize("127.0.0.1:1", num_processes=2, process_id=0)
    mesh = multihost.global_mesh(["cpu", "cpu"])
    assert mesh.group is None and mesh.size == 2
