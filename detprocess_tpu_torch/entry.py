"""Entry points: the of1x1 feature step and the continuous-data trigger
step on one device.

- :func:`entry` is the counterpart of ``__graft_entry__.entry()`` of the
  JAX package: the same trace length (16384 samples at fs = 1.25 MHz,
  pretrigger n/2), template, 1/f noise PSD and example batch, here as a
  :class:`FeatureStep` module and its example arguments on an explicit
  device.
- :func:`trigger_entry` is the trigger configuration of
  ``benchmarks/trigger_stages.py:44-61`` (8 continuous events of
  1,250,000 samples, 4096-sample template, flat noise PSD, pileup window
  125 samples, 5σ) as a residual-mode :class:`TriggerStep` and a batch of
  its noise.
- :func:`feature_processing_entry` is BASELINE.json config 4, "Multichannel
  OF across a 4-channel detector array with per-channel templates/PSDs
  from one YAML config", as a :class:`FeatureProcessing` shell over flat
  int16 dump files that it writes: 4 channels at 1.25 MHz, N = 32768,
  pretrigger 16384; per channel the of1x1 no-delay, unconstrained and
  constrained (±100 µs) fits, a baseline up to −200 µs, integral, maximum
  and minimum; the compound channel ``chan1+chan2+chan3+chan4`` with a
  no-delay fit and a baseline. The builders of that configuration
  (:func:`shell_config`, :func:`shell_filter_data`,
  :func:`shell_events`, :func:`write_shell_dumps`) are shared with the GPU
  smoke run.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from detprocess_tpu_torch import device as dev
from detprocess_tpu_torch.io.filterdata import FilterData
from detprocess_tpu_torch.io.rawdata import RawIndex, write_flat_dump
from detprocess_tpu_torch.models import pulse
from detprocess_tpu_torch.ops import filterbank, trigger
from detprocess_tpu_torch.pipelines.feature_step import FeatureStep
from detprocess_tpu_torch.pipelines.features import FeatureProcessing
from detprocess_tpu_torch.pipelines.trigger_step import TriggerStep

FS = 1.25e6
CHANNEL = "chan1"

# trigger configuration (benchmarks/trigger_stages.py:42-52)
TRIGGER_NT = 4096
TRIGGER_PRETRIG = 1024
TRIGGER_PSD = 4e-18           # flat two-sided noise PSD, A²/Hz
TRIGGER_EVENTS = 8
TRIGGER_L = 1_250_000
TRIGGER_WINDOW = 125
TRIGGER_SIGMA = 5.0
# saturation level of the 50 kHz low-passed trace, in amplitude
# resolutions: far above the 10σ pulses of the smoke run, so that the
# veto runs on every batch and vetoes only what saturates
TRIGGER_SAT_RESOLUTIONS = 1000.0


def build_bank(n: int, pretrig: int, fs: float = FS):
    """Two-pole template (τ_r 20 µs, τ_f 200 µs) and the 1/f PSD
    1e-20·(1 + 100 Hz/|f|) A²/Hz; returns (OF1x1Bank, template, psd)."""
    template = pulse.make_template(fs, n, pretrig, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
    f = np.abs(np.fft.fftfreq(n, 1 / fs))
    f[0] = f[1]
    psd = 1e-20 * (1.0 + 100.0 / f)
    bank = filterbank.make_of1x1_bank(template, psd, fs, pretrig)
    return bank, template, psd


def _device(device) -> torch.device:
    """``device``, or the GPU (``device.require_cuda``, which raises
    without one) for None."""
    return dev.require_cuda() if device is None else torch.device(device)


def entry(device=None, dtype=torch.float32):
    """Return ``(step, (traces,))``: a :class:`FeatureStep` for one channel
    and an example batch [16, 1, 16384] on ``device`` (None: the GPU)."""
    device = _device(device)
    n = 16384
    pretrig = n // 2
    batch = 16
    bank, template, _ = build_bank(n, pretrig)
    step = FeatureStep(filterbank.bank_to_torch(bank, device, dtype),
                       [CHANNEL], FS, pretrig, n)
    rng = np.random.default_rng(0)
    traces = (rng.standard_normal((batch, n)) * 1e-8
              + 2e-6 * template[None, :]).astype(np.float32)
    x = torch.as_tensor(traces[:, None, :], dtype=dtype, device=device)
    return step, (x,)


def build_trigger(fs: float = FS, real_dtype=np.float32):
    """Two-pole template (τ_r 20 µs, τ_f 200 µs, Nt 4096, pretrigger 1024),
    the flat PSD 4e-18 A²/Hz, the NxM bank, the trigger kernel and its
    residual basis; returns (kernel, basis, template)."""
    template = pulse.make_template(fs, TRIGGER_NT, TRIGGER_PRETRIG, A=1.0,
                                   tau_r=20e-6, tau_f1=200e-6)
    psd = np.full(TRIGGER_NT, TRIGGER_PSD)
    bank = filterbank.make_ofnxm_bank(template, psd.astype(complex), fs,
                                      TRIGGER_PRETRIG)
    kernel = trigger.make_trigger_kernel(bank, real_dtype=real_dtype)
    return kernel, trigger.make_residual_basis(kernel), template


def trigger_entry(device=None, dtype=torch.float32):
    """Return ``(step, (traces,))``: a residual-mode :class:`TriggerStep`
    with the saturation veto on, and a batch of white noise [8, 1,
    1250000] of the configuration's PSD on ``device`` (None: the GPU)."""
    device = _device(device)
    kernel, basis, _ = build_trigger(
        real_dtype=np.float64 if dtype == torch.float64 else np.float32)
    sat = TRIGGER_SAT_RESOLUTIONS * float(kernel.resolution[0])
    step = TriggerStep(kernel, basis, TRIGGER_SIGMA, TRIGGER_WINDOW,
                       run_residual=True, sat_amps=[sat], device=device,
                       dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((TRIGGER_EVENTS, 1, TRIGGER_L), generator=gen,
                    device=device, dtype=dtype) * np.sqrt(TRIGGER_PSD * FS)
    return step, (x,)


# the feature shell's configuration (BASELINE.json config 4)
SHELL_CHANNELS = ("chan1", "chan2", "chan3", "chan4")
SHELL_COMPOUND = "+".join(SHELL_CHANNELS)
SHELL_N = 32768
SHELL_PRETRIG = 16384
SHELL_TAU_R = 20e-6
SHELL_TAU_F = (200e-6, 250e-6, 300e-6, 350e-6)   # one fall time a channel
SHELL_PSD_SCALE = (1.0, 0.9, 0.8, 0.7)           # × the 1/f PSD of build_bank
SHELL_CAL = 4e-10                                # ADC volts per bit
SHELL_CLN = (1.0, 1.25, 1.5, 2.0)                # close_loop_norm a channel
SHELL_WINDOW_USEC = 100.0                        # the constrained window
SHELL_SERIES = "I1_D20260101_T000000"


def shell_config(n: int = SHELL_N, pretrig: int = SHELL_PRETRIG) -> dict:
    """The processing config (the dict a YAML file would load to)."""
    per_channel = {
        "of1x1_nodelay": {"run": True},
        "of1x1_unconstrained": {"run": True},
        "of1x1_constrained": {
            "run": True, "window_min_from_trig_usec": -SHELL_WINDOW_USEC,
            "window_max_from_trig_usec": SHELL_WINDOW_USEC},
        "baseline": {"run": True, "window_max_from_trig_usec": -200},
        "integral": {"run": True},
        "maximum": {"run": True},
        "minimum": {"run": True},
    }
    return {"feature": {
        "trace_length_samples": n, "pretrigger_length_samples": pretrig,
        ",".join(SHELL_CHANNELS): per_channel,
        SHELL_COMPOUND: {"of1x1_nodelay": {"run": True},
                         "baseline": {"run": True}},
    }}


def shell_templates(n: int = SHELL_N, pretrig: int = SHELL_PRETRIG,
                    fs: float = FS) -> np.ndarray:
    """Two-pole templates [4, n], τ_r 20 µs and one τ_f a channel."""
    return np.stack([pulse.make_template(fs, n, pretrig, A=1.0,
                                         tau_r=SHELL_TAU_R, tau_f1=tau)
                     for tau in SHELL_TAU_F])


def shell_psds(n: int = SHELL_N, fs: float = FS) -> np.ndarray:
    """Two-sided 1/f PSDs [4, n]: build_bank's, scaled a channel."""
    f = np.abs(np.fft.fftfreq(n, 1 / fs))
    f[0] = f[1]
    return np.stack([s * 1e-20 * (1.0 + 100.0 / f)
                     for s in SHELL_PSD_SCALE])


def shell_filter_data(n: int = SHELL_N, pretrig: int = SHELL_PRETRIG,
                      fs: float = FS) -> FilterData:
    """Templates and PSDs of the four channels and of their sum (the
    templates' sum, normalized, and the PSDs' sum)."""
    fd = FilterData(verbose=False)
    tmpl, psd = shell_templates(n, pretrig, fs), shell_psds(n, fs)
    for chan, t, p in zip(SHELL_CHANNELS, tmpl, psd):
        fd.set_template(chan, t, fs, pretrigger_length_samples=pretrig)
        fd.set_psd(chan, p, fs)
    total = tmpl.sum(axis=0)
    fd.set_template(SHELL_COMPOUND, total / total.max(), fs,
                    pretrigger_length_samples=pretrig)
    fd.set_psd(SHELL_COMPOUND, psd.sum(axis=0), fs)
    return fd


def shell_conv() -> np.ndarray:
    """Per-channel ADC conversion, amps = code · conv."""
    return SHELL_CAL / np.asarray(SHELL_CLN)


def shell_events(gen: torch.Generator, nevents: int, device,
                 n: int = SHELL_N, pretrig: int = SHELL_PRETRIG,
                 fs: float = FS, max_shift: int = 50):
    """``nevents`` events as int16 codes [E, 4, n] on ``device``: noise of
    each channel's PSD plus a pulse of 1–5 µA a channel, all channels
    shifted by one offset an event (within ±``max_shift`` samples).
    Returns (codes, amps [E, 4], shifts [E])."""
    nh = n // 2 + 1
    c = len(SHELL_CHANNELS)
    half_scale = torch.as_tensor(np.sqrt(shell_psds(n, fs)[:, :nh] * fs
                                         * n / 2.0), dtype=torch.float32,
                                 device=device)
    z = torch.randn((nevents, c, 2, nh), generator=gen, device=device)
    nf = torch.complex(z[:, :, 0], z[:, :, 1]) * half_scale
    nf[..., 0] = 0.0
    nf[..., -1] = z[:, :, 0, -1] * half_scale[:, -1] * np.sqrt(2.0)
    traces = torch.fft.irfft(nf, n=n)
    amps = torch.empty((nevents, c), device=device).uniform_(
        1e-6, 5e-6, generator=gen)
    shifts = torch.randint(-max_shift, max_shift + 1, (nevents,),
                           generator=gen, device=device)
    tmpl = torch.as_tensor(shell_templates(n, pretrig, fs),
                           dtype=torch.float32, device=device)
    cols = (torch.arange(n, device=device)[None, :] - shifts[:, None]) % n
    traces += amps[:, :, None] * tmpl[:, cols].permute(1, 0, 2)
    conv = torch.as_tensor(shell_conv(), dtype=torch.float32, device=device)
    codes = torch.round(traces / conv[:, None])
    if float(codes.abs().max()) > np.iinfo(np.int16).max:
        raise ValueError("int16 ADC overflow in the synthetic events")
    return codes.to(torch.int16), amps, shifts


def shell_index(paths, n: int = SHELL_N, pretrig: int = SHELL_PRETRIG,
                fs: float = FS) -> RawIndex:
    """The raw index of flat int16 dumps of the shell's channels."""
    return RawIndex.from_flat(
        paths, SHELL_CHANNELS, n, fs, SHELL_SERIES, dtype=np.int16,
        adc_conversion_factor=SHELL_CAL,
        detector_config={c: {"close_loop_norm": cln}
                         for c, cln in zip(SHELL_CHANNELS, SHELL_CLN)},
        nb_pretrigger_samples=pretrig)


def write_shell_dumps(directory: str, gen: torch.Generator, nevents: int,
                      nfiles: int, device, chunk: int = 512,
                      n: int = SHELL_N, pretrig: int = SHELL_PRETRIG):
    """Write ``nevents`` events (:func:`shell_events`) into ``nfiles``
    flat dumps in ``directory``, ``chunk`` events made at a time; returns
    (paths, amps [E, 4], shifts [E]) as numpy arrays."""
    per = -(-nevents // nfiles)
    paths, amps, shifts = [], [], []
    for i in range(nfiles):
        path = os.path.join(directory, f"flat_{SHELL_SERIES}_F{i + 1:04d}.bin")
        count = min(per, nevents - i * per)
        for j in range(0, count, chunk):
            codes, a, s = shell_events(gen, min(chunk, count - j), device,
                                       n, pretrig)
            write_flat_dump(path, codes.cpu().numpy(), append=j > 0)
            amps.append(a.cpu().numpy())
            shifts.append(s.cpu().numpy())
        paths.append(path)
    return paths, np.concatenate(amps), np.concatenate(shifts)


def feature_processing_entry(device=None, directory: str | None = None,
                             nevents: int = 16, seed: int = 0):
    """Return ``(shell, index)``: the :class:`FeatureProcessing` shell of
    the 4-channel configuration over ``nevents`` synthetic events that it
    writes as two flat int16 dumps into ``directory`` (a new temporary
    directory by default). ``device=None`` means the GPU."""
    device = _device(device)
    if directory is None:
        directory = tempfile.mkdtemp(prefix="detprocess_shell_")
    gen = torch.Generator().manual_seed(seed)
    paths, _, _ = write_shell_dumps(directory, gen, nevents, 2, "cpu")
    index = shell_index(paths)
    shell = FeatureProcessing(index, shell_config(), shell_filter_data(),
                              verbose=False, device=device)
    return shell, index
