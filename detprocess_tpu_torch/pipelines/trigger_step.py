"""The continuous-data trigger step: a batch of continuous events in, first-
pass and residual-pass trigger sets out.

Counterpart of the tiled branch of the channel function that
``detprocess_tpu/pipelines/triggers.py::TriggerProcessing._make_channel_fn``
builds (``run_one`` :632-655), batched over events. Per batch [E, C, L]:

1. the overlap-save FIR (the stages of ``ops/trigger.of_fir_blocks``: the
   segment rFFT, which is the hand-written kernel on the card, the channel
   mix and the inverse);
2. Δχ² (``delta_chi2_from_q``) and the tiled threshold + pileup merge
   (``find_triggers_tiled``, amplitudes W⁻¹q at the winners only);
3. in residual mode: the saturation veto (50 kHz low-pass,
   ``saturation_mask`` over ±Nt/4), the subtraction of each first-pass
   trigger's Δχ² response (``residual_subtract_conv``: one more FIR, over
   the residual basis) and a second merge on the residual Δχ²; the
   residual set's ``n_vetoed`` counts the first-pass triggers that the
   veto kept out of the subtraction.

The χ² threshold is ``chi2_threshold(threshold_sigma, M)``
(triggers.py:523). Pileup windows below 7 samples run the same tiled
merge at tiles of 1, 2 or 4 samples, where the JAX package runs its
sub-tile branch (:656-672). With a ``window_fn`` both merges are the
dynamic-window merge (``find_triggers_dynamic_batched``) on the flat
[E, L] Δχ², as JAX's ``run_batch_dynamic`` (:674-714) runs them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from detprocess_tpu_torch import device as dev
from detprocess_tpu_torch.ops import spectral, trigger

SATURATION_LPF_HZ = 50e3      # the veto's low-pass cut (triggers.py:627)
DEFAULT_CAPACITY = 4096       # triggers.py:533
# the layers of TriggerStep.forward, in order (the last three in residual
# mode only; with a window_fn both merges are the dynamic merge)
LAYERS = ("FIR segments + rFFT kernel", "FIR mix", "FIR irfft + valid",
          "Δχ²", "tiled merge", "LPF + saturation", "residual convolution",
          "second merge")


class TriggerStep(nn.Module):
    """Continuous-data trigger for one trigger channel.

    Parameters
    ----------
    kernel : ``ops/trigger.make_trigger_kernel`` output (host numpy).
    basis : ``ops/trigger.make_residual_basis(kernel)``; needed for
        ``run_residual``.
    threshold_sigma, pileup_window : trigger threshold in σ and pileup
        window in samples.
    capacity : trigger slots per event and pass.
    run_residual : also run the residual re-trigger.
    sat_amps : per-channel saturation amplitudes of the low-passed trace
        (None: no saturation veto).
    positive_pulses : pulses go up (False: down).
    device, dtype : where and in what precision the step runs.
    window_fn : the dynamic mode's merge window as a function of the
        group's running maximum Δχ² (``ops/trigger.WINDOW_FN_CONTRACT``);
        None: the static ``pileup_window``.
    candidate_capacity, premerge_window : the dynamic merge's candidate
        units and pre-merge window (``find_triggers_dynamic_batched``).
    """

    def __init__(self, kernel: trigger.TriggerKernel,
                 basis: Optional[trigger.ResidualBasis],
                 threshold_sigma: float, pileup_window: int,
                 capacity: int = DEFAULT_CAPACITY,
                 run_residual: bool = False,
                 sat_amps: Optional[Sequence[float]] = None,
                 positive_pulses: bool = True, *, device,
                 dtype: torch.dtype = torch.float32, window_fn=None,
                 candidate_capacity: int = DEFAULT_CAPACITY,
                 premerge_window: Optional[int] = None):
        super().__init__()
        if window_fn is not None:
            trigger.check_window_fn(window_fn)
        if run_residual and basis is None:
            raise ValueError("run_residual needs the residual basis")
        device = torch.device(device)
        if device.type == "cuda":
            dev.set_full_f32()          # Δχ² and amplitudes in full float32
        self.kernel = kernel
        self.basis = basis
        self.threshold = trigger.chi2_threshold(
            threshold_sigma, kernel.iw_matrix.shape[0])
        self.pileup_window = int(pileup_window)
        self.capacity = int(capacity)
        self.run_residual = bool(run_residual)
        self.positive_pulses = bool(positive_pulses)
        self.window_fn = window_fn
        self.candidate_capacity = int(candidate_capacity)
        self.premerge_window = premerge_window
        cdtype = trigger._COMPLEX[dtype]

        def put(name, a, dt):
            self.register_buffer(name, None if a is None else torch.as_tensor(
                a, dtype=dt, device=device))

        put("g_fft", kernel.g_fft, cdtype)
        put("iw_matrix", kernel.iw_matrix, dtype)
        put("response", kernel.response, dtype)
        put("basis_g_fft", None if basis is None else basis.fir.g_fft,
            cdtype)
        put("sat_amps", None if sat_amps is None else list(sat_amps), dtype)

    def device_kernels(self):
        """The trigger kernel and residual basis with this module's
        tensors in place of their host arrays."""
        kernel = self.kernel._replace(g_fft=self.g_fft,
                                      iw_matrix=self.iw_matrix,
                                      response=self.response)
        basis = (None if self.basis is None else self.basis._replace(
            fir=self.basis.fir._replace(g_fft=self.basis_g_fft)))
        return kernel, basis

    def saturation(self, traces: torch.Tensor):
        """Saturation flags [E, L] of ``traces`` [E, C, L], or None without
        saturation amplitudes."""
        if self.sat_amps is None:
            return None
        lpf = spectral.lowpass_filter(traces, SATURATION_LPF_HZ,
                                      self.kernel.fs)
        return trigger.saturation_mask(lpf, self.sat_amps,
                                       self.kernel.nt // 4,
                                       self.positive_pulses)

    def merge(self, dchi2: torch.Tensor, q_blocks: torch.Tensor,
              length: int):
        """The threshold + pileup merge of Δχ² [E, R, B] of traces of
        ``length`` samples with the amplitudes W⁻¹q at the winners: tiled,
        or with a ``window_fn`` dynamic on the flat [E, L] series."""
        if self.window_fn is None:
            return trigger.find_triggers_tiled(
                dchi2, q_blocks, self.threshold, self.pileup_window,
                self.capacity, amps_transform=self.iw_matrix)
        return trigger.find_triggers_dynamic_batched(
            dchi2.flatten(-2)[..., :length],
            q_blocks.flatten(-2)[..., :length], self.threshold,
            self.window_fn, self.capacity, self.candidate_capacity,
            amps_transform=self.iw_matrix,
            premerge_window=self.premerge_window)

    def forward(self, traces: torch.Tensor, run_layer=None, timer=None):
        """``traces`` [E, C, L] → (first-pass TriggerSet, residual-pass
        TriggerSet or None), each batched over E.

        ``run_layer(name, fn, *args)``, if given, runs each layer in place
        of ``fn(*args)`` and returns its result, so that a caller can time
        or keep the layers of this very path (names in :data:`LAYERS`).
        ``timer``: a ``StageTimer`` for the residual subtraction's host
        read (span ``residual.index_read``)."""
        run = run_layer or _call
        kernel, basis = self.device_kernels()
        spec = run(LAYERS[0], trigger.fir_spectra, traces, kernel)
        mixed = run(LAYERS[1], trigger.fir_mix, spec, kernel.g_fft)
        q_blocks, _ = run(LAYERS[2], trigger.fir_inverse, mixed, kernel,
                          traces.shape[-1])
        dchi2 = run(LAYERS[3], trigger.delta_chi2_from_q, q_blocks,
                    self.iw_matrix)
        ts = run(LAYERS[4], self.merge, dchi2, q_blocks, traces.shape[-1])
        if not self.run_residual:
            return ts, None
        sat = run(LAYERS[5], self.saturation, traces)
        resid = run(LAYERS[6], trigger.residual_subtract_conv, dchi2, ts,
                    kernel, basis, sat, timer)
        ts2 = run(LAYERS[7], self.merge, resid, q_blocks, traces.shape[-1])
        if sat is not None:
            ts2 = ts2._replace(n_vetoed=trigger.vetoed_count(ts, sat))
        return ts, ts2


def _call(name, fn, *args):
    return fn(*args)
