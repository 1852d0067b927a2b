"""Float64 runs on the card: the route each spectrum and fit takes.

On a CUDA tensor ``ops/fft.rfft`` sends float64 traces to
``torch.fft.rfft`` (cuFFT), counted as ``cufft_rfft_f64``; the feature
steps build the fused no-delay kernel's module only for float32 runs, so a
float64 run fits ``of1x1_nodelay`` with ``of1x1_nodelay_half``. Here, with
no card:

- ``GroupStep`` and ``FeatureStep`` built for a "cuda" device under a
  torch function mode that places the card's tensors on the CPU (no
  kernel is built or launched at construction): no ``FusedNodelayOF`` in
  float64, one in float32;
- ``FeatureProcessing`` and ``TriggerProcessing`` in float64 with the
  card's route stood in (``ops/fft.rfft`` is ``rfft_cuda`` on the CPU
  tensors): no kernel launch, one ``cufft_rfft_f64`` call a spectrum, no
  float32 route, and the tables equal the plain CPU run's exactly.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import torch_feature_cases as cases
from detprocess_tpu_torch.ops import _kernels
from detprocess_tpu_torch.ops import fft as tfft
from detprocess_tpu_torch.ops import filterbank as tfb
from detprocess_tpu_torch.ops.cuda_of import FusedNodelayOF
from detprocess_tpu_torch.pipelines.feature_group import GroupStep
from detprocess_tpu_torch.pipelines.feature_step import FeatureStep
from detprocess_tpu_torch.pipelines.features import FeatureProcessing
from detprocess_tpu_torch.pipelines.triggers import TriggerProcessing
from test_torch_h5_storage import TRIG_CONFIG, _trigger_raw

torch.set_num_threads(1)


class CardOnCpu(TorchFunctionMode):
    """Tensors asked for on a CUDA device are made on the CPU."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        d = kwargs.get("device")
        if d is not None and torch.device(d).type == "cuda":
            kwargs["device"] = "cpu"
        return func(*args, **kwargs)


@pytest.mark.parametrize("dtype,fused", [(torch.float32, 1),
                                         (torch.float64, 0)])
def test_steps_build_the_fused_module_for_float32_only(tmp_path, dtype,
                                                       fused):
    raw, fpath, cpath = cases.write_inputs(str(tmp_path))
    shell = FeatureProcessing(raw, cpath, fpath, verbose=False, device="cpu")
    (group,) = [g for g in shell._plan.groups if g.nb_samples == cases.N]
    slots = {s.slot for s in group.specs if s.base == "of1x1_nodelay"}
    tmpl = cases.templates(cases.N, cases.PRETRIG)["chan1"]
    bank = tfb.make_of1x1_bank(tmpl, cases.psd(cases.N), cases.FS,
                               cases.PRETRIG)
    with CardOnCpu():
        step = GroupStep(group, cases.FS, (cases.N, cases.PRETRIG), "cuda",
                         dtype)
        fstep = FeatureStep(tfb.bank_to_torch(bank, "cuda", dtype),
                            ["chan1"], cases.FS, cases.PRETRIG, cases.N)
    assert slots and len(step.nodelay) == fused * len(slots)
    assert all(isinstance(m, FusedNodelayOF) for m in step.nodelay.values())
    assert (fstep.nodelay is None) == (not fused)


def _card_route(monkeypatch):
    """``ops/fft.rfft`` as on the card; the fused module must not run."""
    monkeypatch.setattr(tfft, "rfft", tfft.rfft_cuda)

    def refuse(self, traces):
        raise AssertionError("the fused module ran in a float64 run")

    monkeypatch.setattr(FusedNodelayOF, "forward", refuse)


def test_feature_shell_float64_takes_the_float64_route(monkeypatch,
                                                       tmp_path):
    raw, fpath, cpath = cases.write_inputs(str(tmp_path))

    def run():
        shell = FeatureProcessing(raw, cpath, fpath, verbose=False,
                                  device="cpu")
        return shell.process(batch_size=8, dtype=np.float64)

    plain = run()
    _card_route(monkeypatch)
    _kernels.reset_launch_counts()
    routed = run()
    launches, library = _kernels.launch_counts(), _kernels.library_counts()
    _kernels.reset_launch_counts()
    assert launches == {name: 0 for name in _kernels.KERNELS}
    # three batches; the full-length group reads chan1, chan2 and their
    # sum, the cut group chan1 and chan2: five spectra a batch
    assert library == {"cufft_rfft": 0, "cufft_rfft_f64": 3 * 5}
    assert list(routed) == list(plain)
    for key in plain:
        np.testing.assert_array_equal(np.asarray(routed[key]),
                                      np.asarray(plain[key]), err_msg=key)


def test_trigger_shell_float64_takes_the_float64_route(monkeypatch,
                                                       tmp_path):
    paths, fd = _trigger_raw(tmp_path, np.random.default_rng(9))

    def run():
        shell = TriggerProcessing(paths, TRIG_CONFIG, fd, verbose=False,
                                  device="cpu")
        return shell.process(capacity=64, event_batch=2, dtype=np.float64)

    plain = run()
    _card_route(monkeypatch)
    _kernels.reset_launch_counts()
    routed = run()
    launches, library = _kernels.launch_counts(), _kernels.library_counts()
    _kernels.reset_launch_counts()
    assert launches == {name: 0 for name in _kernels.KERNELS}
    assert library["cufft_rfft"] == 0 and library["cufft_rfft_f64"] > 0
    assert list(routed) == list(plain) and len(plain["trigger_index"])
    for key in plain:
        a, b = np.asarray(routed[key]), np.asarray(plain[key])
        if a.dtype == object:
            a, b = ([None if x != x else x for x in c] for c in (a, b))
        np.testing.assert_array_equal(a, b, err_msg=key)
