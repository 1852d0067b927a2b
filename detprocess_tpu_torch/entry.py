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
- :func:`feature_coverage_entry` is the configuration users write from
  docs/CONFIG.md:38-75 and examples/processing/process_example.yaml: every
  feature algorithm beside the of1x1 fits and the trace stats, on the
  four shell channels at N = 32768: ``of1x2x2`` (scintillation and
  evaporation templates, Δ within 0–500 µs) and an ``of1x1_nodelay`` on
  chan1, ``ofnxm`` with one template shared by chan1|chan2 (a 2 × 2 CSD
  with a cross term), ``ofnxmx2`` on chan1, ``psd_amp``, ``psd_peaks``
  and ``phase`` on chan2, ``rftau`` on chan3 and chan4. The functions
  that make its parts (:func:`coverage_config`,
  :func:`coverage_filter_data`, :func:`coverage_events`,
  :func:`write_coverage_dumps`) are shared with the GPU smoke run.
- :func:`trigger_processing_entry` is the trigger half of BASELINE.json
  config 5, "Continuous-stream OF trigger", as a :class:`TriggerProcessing`
  shell over flat int16 continuous dumps of the same four channels that it
  writes: 1,250,000 samples an event, each channel 1x1 on its Nt = 4096
  template and PSD, 5σ, pileup window 0.1 ms, coincidence window 0.2 ms;
  chan1 also in residual mode with its saturation veto and 5 ms edge
  exclusion. Each event holds 40 coincident 10σ pulses, single 10σ pulses
  on chan2–chan4 and, on chan1, pulses above its saturation level. Its
  builders (:func:`trigger_shell_config`, :func:`trigger_shell_pulses`,
  :func:`write_trigger_dumps`, :func:`trigger_shell_index`) are shared
  with the GPU smoke run.
- :func:`filter_generation_entry` is filter generation as docs/CONFIG.md
  :115-128 configures it (N = 32768, pretrigger 16384, analytic
  templates) at 2048 randoms, four times the default ``nrandoms``, as a
  :class:`FilterDataProcessing` over flat int16 continuous dumps of the
  four shell channels that it writes: 1,250,000 samples an event, each
  channel's noise drawn from its shell PSD on that grid (chan1's and
  chan2's correlated as :func:`coverage_csd` says), a DC offset a
  channel, and one 1–2 µA pulse and one 2-sample glitch of 1–2 µA a
  channel and event for the cuts to find. Templates: each channel's
  two-pole shell template (``default``), chan1's sum of two two-poles
  (``sum``) and chan2's three-pole (``threepole``). Its builders
  (:func:`filtergen_config`, :func:`filtergen_templates`,
  :func:`filtergen_csd`, :func:`filtergen_artifacts`,
  :func:`write_filtergen_dumps`, :func:`filtergen_index`) are shared with
  the GPU smoke run.
- :func:`salting_chain_entry` is the salting check of
  examples/salting/saltchecks.py on the trigger configuration: noise-only
  continuous dumps of the four shell channels, salts coincident on all
  four at 2, 3, 4, 5, 6, 7 and 9 σ of each channel's trigger resolution
  (72 at each by default), the trigger shell and, on a table of the
  injected indices, a feature shell of of1x1 no-delay fits at Nt = 4096,
  both with the device injector. The GPU smoke run uses its parts too
  (:func:`salting_feature_config`, :func:`salting_truth_table`).
- :func:`ivsweep_entry` is an IV/dIdV sweep of one channel as
  examples/iv_didv/ivsweep_analysis.py and tests/test_ivsweep_pipeline.py
  configure it (fs 1.25 MHz, square wave 100 Hz and 2e-8 A, Rsh 5 mΩ,
  Rp 4 mΩ, Rn 300 mΩ, Tc 40 mK, Tbath 20 mK) at a sweep's size: 32 bias
  points (8 normal, 16 in the transition with R0 from 0.25 to 0.03 Ω at
  loop gain 10 and β 2, 8 superconducting), each with 128 noise traces of
  32768 samples and 32 dIdV traces of 8 periods, written as flat int16
  dumps (:func:`write_ivsweep_dumps`); :func:`run_ivsweep` processes
  and analyses it. :func:`didv_filtergen_entry` is the dIdV branch of
  filter generation on dIdV series of that configuration.
- :func:`cli_chain_entry` is the command line over files: the
  filter-generation events as a flat raw group (one series, one dump),
  the sweep as a flat group of ``iv``/``didv`` series with ``tes_bias``
  in their manifests (:func:`write_ivsweep_group`), and JSON setups
  (:func:`cli_setup`: filter generation at the trigger templates'
  geometry, the trigger shell, the salting chain's salts and feature
  fit; :func:`cli_sweep_setup`), with the argument lists of its three
  calls (:class:`CliChain`).
- :func:`dryrun_multichip` is ``__graft_entry__.dryrun_multichip``: the
  sharded feature step, PSD, CSD, event-sharded trigger, time-sharded
  long trace, and the trigger shell with ``mesh=`` on int16 data with the
  device injector, then with two coincident channels, on ``n`` shards of
  one device (virtual shards).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from detprocess_tpu_torch import device as dev
from detprocess_tpu_torch.io.filterdata import FilterData
from detprocess_tpu_torch.io.rawdata import (RawIndex, write_flat_dump,
                                             write_flat_series)
from detprocess_tpu_torch.models import pulse, tesnoise
from detprocess_tpu_torch.ops import filterbank, trigger
from detprocess_tpu_torch.pipelines.feature_step import FeatureStep
from detprocess_tpu_torch.pipelines.features import FeatureProcessing
from detprocess_tpu_torch.pipelines.filtergen import FilterDataProcessing
from detprocess_tpu_torch.pipelines.salting import Salting
from detprocess_tpu_torch.pipelines.trigger_step import TriggerStep
from detprocess_tpu_torch.pipelines.triggers import TriggerProcessing
from detprocess_tpu_torch.parallel import mesh as pmesh

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


# the trigger shell's configuration (the trigger half of BASELINE.json
# config 5): the four shell channels, continuous, each 1x1 on the
# shell's templates and PSDs at Nt = 4096
TSHELL_SERIES = "I1_D20260101_T120000"
TSHELL_SIGMA = 5.0
TSHELL_WINDOW_MSEC = 0.1          # pileup window, 125 samples
TSHELL_COINCIDENT_MSEC = 0.2      # coincidence window, 250 samples
TSHELL_EDGE_MSEC = 5.0            # chan1's edge exclusion
TSHELL_SAT = 5e-7                 # chan1's saturation level (A, low-passed)
TSHELL_COINCIDENT = 40            # coincident pulses an event
TSHELL_SINGLES = 2                # single-channel pulses a channel and event
TSHELL_PULSE_SIGMA = 10.0         # their amplitude, in resolutions
TSHELL_SPREAD = 20                # coincident channel offsets, ± samples
TSHELL_SAT_PULSE = 8e-6           # the saturating pulse on chan1 (A)
TSHELL_MARGIN = 5000              # a 10σ pulse's clearance in its slot
TSHELL_WINDOW = int(TSHELL_WINDOW_MSEC * FS / 1000)   # in samples
# the trigger modes: pulse pairs on chan2 whose above-threshold spans
# (±301 samples at 20σ) lie further apart than the static window and
# closer than the dynamic one, which widens above a Δχ² cut; at this
# spacing each pulse's Δχ² sidelobes fall under the other's main lobe
TSHELL_PAIR_SIGMA = 20.0          # the pairs' amplitude, in resolutions
TSHELL_PAIR_SEP = 1050            # samples between a pair's trigger points
TSHELL_PAIR_CHANNELS = (1,)       # chan2
TSHELL_DYNAMIC_CUT = 150.0        # Δχ² above which the window widens
TSHELL_DYNAMIC_WINDOW = 2000.0    # samples
TSHELL_SUBTILE_WINDOWS = (6, 1, 0, 3)   # samples: tiles of 4, 2, 1 and 4


def trigger_shell_config(coincident_window_msec=TSHELL_COINCIDENT_MSEC,
                         pileup_windows=None):
    """The trigger config (the dict a YAML file would load to): every
    channel 5σ with a 0.1 ms pileup window, or ``pileup_windows`` samples
    a channel; chan1 also in residual mode, with the saturation veto and
    edge exclusion."""
    if pileup_windows is None:
        windows = [{"pileup_window_msec": TSHELL_WINDOW_MSEC}] * len(
            SHELL_CHANNELS)
    else:
        windows = [{"pileup_window_samples": int(w)} for w in pileup_windows]
    chans = {c: {"run": True, "template_tag": "default",
                 "threshold_sigma": TSHELL_SIGMA, **w}
             for c, w in zip(SHELL_CHANNELS, windows)}
    chans["chan1"].update(run_residual=True, saturation_amplitudes=[TSHELL_SAT],
                          edge_exclusion_msec=TSHELL_EDGE_MSEC)
    return {"trigger": {"coincident_window_msec": coincident_window_msec,
                        **chans}}


def trigger_shell_window_fn(m: torch.Tensor) -> torch.Tensor:
    """The dynamic pileup window of the trigger modes: the static window
    up to a group maximum of TSHELL_DYNAMIC_CUT in Δχ², TSHELL_DYNAMIC_WINDOW
    samples above (monotonic, so the default pre-merge is exact)."""
    return torch.where(m > TSHELL_DYNAMIC_CUT, TSHELL_DYNAMIC_WINDOW,
                       float(TSHELL_WINDOW))


def trigger_shell_resolutions(fs: float = FS,
                              filter_data=None) -> np.ndarray:
    """Each channel's amplitude resolution (A) in its trigger bank, from
    ``filter_data`` (default: the shell's analytic templates and PSDs at
    the trigger length)."""
    fd = (shell_filter_data(TRIGGER_NT, TRIGGER_PRETRIG, fs)
          if filter_data is None else filter_data)
    out = []
    for chan in SHELL_CHANNELS:
        tmpl, _ = fd.get_template(chan)
        psd, _ = fd.get_psd(chan)
        out.append(filterbank.make_ofnxm_bank(
            tmpl, psd.astype(complex), fs, TRIGGER_PRETRIG).resolution[0])
    return np.asarray(out)


def trigger_shell_pulses(gen: torch.Generator, nevents: int,
                         length: int = TRIGGER_L,
                         ncoincident: int = TSHELL_COINCIDENT,
                         nsingles: int = TSHELL_SINGLES,
                         saturating: bool = True, npairs: int = 0) -> dict:
    """Pulse indices (trigger points) of ``nevents`` continuous events:
    ``coincident`` [E, P, 4] (one index a pulse, each channel offset
    within ±TSHELL_SPREAD), ``single`` [E, 3, S] on chan2–chan4, one
    10σ pulse a slot of [20000, L − 250000), each at least TSHELL_MARGIN
    from its slot's edges; ``big`` [E, S] chan1 singles of ``big_amp``
    1–5 µA and ``sat`` [E] the TSHELL_SAT_PULSE pulse (None without
    ``saturating``), at L − 210000, − 140000 (S = 2) and − 70000
    (± 1000), clear of every 10σ pulse by more than an FIR segment and
    two templates; ``pairs`` [E, 1, npairs, 2] on chan2, two
    TSHELL_PAIR_SIGMA pulses TSHELL_PAIR_SEP apart around the middle of
    a slot of their own."""
    nslot = ncoincident + 3 * nsingles + len(TSHELL_PAIR_CHANNELS) * npairs
    lo, hi = 20000, length - 250000
    slot = (hi - lo) // max(nslot, 1)
    if nslot and slot <= 2 * TSHELL_MARGIN:
        raise ValueError(f"{nslot} pulses do not fit into {length} samples")
    pos = lo + slot * torch.arange(nslot) + torch.randint(
        TSHELL_MARGIN, slot - TSHELL_MARGIN, (nevents, nslot), generator=gen)
    perm = torch.argsort(torch.rand((nevents, nslot), generator=gen), dim=-1)
    pos = pos.gather(-1, perm)
    spread = torch.randint(-TSHELL_SPREAD, TSHELL_SPREAD + 1,
                           (nevents, ncoincident, len(SHELL_CHANNELS)),
                           generator=gen)
    big_at = length - torch.tensor([210000, 140000, 70000])
    jitter = torch.randint(-1000, 1001, (nevents, 3), generator=gen)
    big = (big_at + jitter)[:, :nsingles]
    nlone = ncoincident + 3 * nsingles
    centre = pos[:, nlone:].reshape(nevents, len(TSHELL_PAIR_CHANNELS),
                                    npairs, 1)
    half = TSHELL_PAIR_SEP // 2
    return {"coincident": (pos[:, :ncoincident, None] + spread).numpy(),
            "single": pos[:, ncoincident:nlone].reshape(
                nevents, 3, nsingles).numpy(),
            "pairs": (centre + torch.tensor([-half, half])).numpy(),
            "big": big.numpy(),
            "big_amp": torch.empty(big.shape).uniform_(
                1e-6, 5e-6, generator=gen).numpy(),
            "sat": ((big_at[2] + jitter[:, 2]).numpy() if saturating
                    else None)}


def trigger_shell_events(gen: torch.Generator, pulses: dict, first: int,
                         count: int, device, length: int = TRIGGER_L,
                         fs: float = FS) -> torch.Tensor:
    """Events ``first`` … ``first + count − 1`` of ``pulses`` as int16
    codes [count, 4, L] on ``device``: each channel's PSD-matched noise
    plus its pulses (10σ of its resolution; chan1's large ones; the
    pairs)."""
    c = len(SHELL_CHANNELS)
    nh = length // 2 + 1
    scale = torch.as_tensor(np.sqrt(shell_psds(length, fs)[:, :nh] * fs
                                    * length / 2.0), dtype=torch.float32,
                            device=device)
    tmpl = torch.as_tensor(shell_templates(TRIGGER_NT, TRIGGER_PRETRIG, fs),
                           dtype=torch.float32, device=device)
    amp10 = TSHELL_PULSE_SIGMA * trigger_shell_resolutions(fs)
    conv = torch.as_tensor(shell_conv(), dtype=torch.float32, device=device)
    steps = torch.arange(TRIGGER_NT, device=device) - TRIGGER_PRETRIG
    out = torch.empty((count, c, length), dtype=torch.int16, device=device)
    for k in range(count):
        e = first + k
        z = torch.randn((c, 2, nh), generator=gen).to(device)
        nf = torch.complex(z[:, 0], z[:, 1]) * scale
        nf[:, 0] = 0.0
        x = torch.fft.irfft(nf, n=length)
        for ch in range(c):
            at = [pulses["coincident"][e, :, ch]]
            amps = [np.full(at[0].shape, amp10[ch])]
            if ch == 0:
                at.append(pulses["big"][e])
                amps.append(pulses["big_amp"][e])
                if pulses["sat"] is not None:
                    at.append(pulses["sat"][e:e + 1])
                    amps.append([TSHELL_SAT_PULSE])
            else:
                at.append(pulses["single"][e, ch - 1])
                amps.append(np.full(at[-1].shape, amp10[ch]))
            if ch in TSHELL_PAIR_CHANNELS:
                at.append(pulses["pairs"][
                    e, TSHELL_PAIR_CHANNELS.index(ch)].reshape(-1))
                amps.append(np.full(at[-1].shape, TSHELL_PAIR_SIGMA
                                    * amp10[ch] / TSHELL_PULSE_SIGMA))
            at = torch.as_tensor(np.concatenate(at), device=device)
            amp = torch.as_tensor(np.concatenate(amps), dtype=torch.float32,
                                  device=device)
            x[ch].index_add_(0, (at[:, None] + steps).reshape(-1),
                             (amp[:, None] * tmpl[ch]).reshape(-1))
        codes = torch.round(x / conv[:, None])
        if float(codes.abs().max()) > np.iinfo(np.int16).max:
            raise ValueError("int16 ADC overflow in the synthetic events")
        out[k] = codes.to(torch.int16)
    return out


def write_trigger_dumps(directory: str, gen: torch.Generator, nevents: int,
                        nfiles: int, device, length: int = TRIGGER_L,
                        **counts):
    """Write ``nevents`` continuous events (:func:`trigger_shell_events`)
    into ``nfiles`` flat dumps in ``directory``, one event made at a time;
    returns (paths, the :func:`trigger_shell_pulses` dict)."""
    pulses = trigger_shell_pulses(gen, nevents, length, **counts)
    per = -(-nevents // nfiles)
    paths = []
    for i in range(nfiles):
        path = os.path.join(directory,
                            f"flat_{TSHELL_SERIES}_F{i + 1:04d}.bin")
        for j in range(i * per, min((i + 1) * per, nevents)):
            codes = trigger_shell_events(gen, pulses, j, 1, device, length)
            write_flat_dump(path, codes.cpu().numpy(), append=j > i * per)
        paths.append(path)
    return paths, pulses


def trigger_shell_index(paths, length: int = TRIGGER_L,
                        fs: float = FS) -> RawIndex:
    """The raw index of flat int16 continuous dumps of the shell's
    channels."""
    return RawIndex.from_flat(
        paths, SHELL_CHANNELS, length, fs, TSHELL_SERIES, dtype=np.int16,
        adc_conversion_factor=SHELL_CAL,
        detector_config={c: {"close_loop_norm": cln}
                         for c, cln in zip(SHELL_CHANNELS, SHELL_CLN)},
        data_type="continuous")


def trigger_processing_entry(device=None, directory: str | None = None,
                             nevents: int = 4, seed: int = 0,
                             length: int = TRIGGER_L, **counts):
    """Return ``(shell, index)``: the :class:`TriggerProcessing` shell of
    the 4-channel trigger configuration over ``nevents`` continuous events
    of ``length`` samples that it writes as two flat int16 dumps into
    ``directory`` (a new temporary directory by default); ``counts``
    (``ncoincident``, ``nsingles``) scale the pulses down for short
    events. ``device=None`` means the GPU."""
    device = _device(device)
    if directory is None:
        directory = tempfile.mkdtemp(prefix="detprocess_trigger_shell_")
    gen = torch.Generator().manual_seed(seed)
    paths, _ = write_trigger_dumps(directory, gen, nevents, 2, "cpu",
                                   length, **counts)
    index = trigger_shell_index(paths, length)
    shell = TriggerProcessing(
        index, trigger_shell_config(),
        shell_filter_data(TRIGGER_NT, TRIGGER_PRETRIG), verbose=False,
        device=device)
    return shell, index


# the feature coverage configuration (docs/CONFIG.md:38-75): the shell's
# four channels, templates and PSDs, plus
COV_SCINT = (10e-6, 60e-6)        # chan1's scintillation template τ_r, τ_f
COV_EVAP = (30e-6, 400e-6)        # its evaporation template
COV_DELAY = (40, 400)             # evaporation after scintillation, samples
COV_SHIFT = 25                    # event offsets within ± samples
COV_SHARED = (50e-6, 500e-6, 0.5)  # chan2's part of the shared pulse
COV_RHO = 0.3                     # chan2's noise: 0.3·chan1's, 3 samples late
COV_LAG = 3
COV_LINE_AMP = 2e-6               # chan2's line near 25 kHz (A) and phase
COV_LINE_PHASE = 0.7
COV_RFTAU = ((20.0, 150.0), (35.0, 250.0))   # chan3, chan4 rise, fall
COV_DELTA_USEC = 500.0
COV_SERIES = "I1_D20260101_T060000"


def coverage_line_freq(n: int = SHELL_N, fs: float = FS) -> float:
    """chan2's line: the frequency bin nearest 25 kHz."""
    return round(25e3 * n / fs) * fs / n


def coverage_config(n: int = SHELL_N, pretrig: int = SHELL_PRETRIG,
                    fs: float = FS) -> dict:
    """The processing config (the dict a YAML file would load to)."""
    return {"feature": {
        "trace_length_samples": n, "pretrigger_length_samples": pretrig,
        "chan1": {
            "of1x2x2": {"run": True, "template_tag_1": "Scintillation",
                        "template_tag_2": "Evaporation",
                        "delta_window_min_usec": 0.0,
                        "delta_window_max_usec": COV_DELTA_USEC},
            "of1x1_nodelay": {"run": True, "template_tag": "Scintillation"},
            "ofnxmx2": {"run": True, "template_tag": "ScintEvap",
                        "template_group_ids": [0, 1],
                        "fit_window": [[pretrig - 30, pretrig + 30],
                                       [pretrig - 10, pretrig + 650]]},
        },
        "chan1|chan2": {
            "ofnxm": {"run": True, "template_tag": "shared",
                      "amplitude_names": ["shared"],
                      "window_min_from_trig_usec": -50.0,
                      "window_max_from_trig_usec": 50.0,
                      "ignored_frequency_peaks": [coverage_line_freq(n, fs)]},
        },
        "chan2": {
            "psd_amp": {"run": True, "f_lims": [[45, 65], [1000, 10000]]},
            "psd_peaks": {"run": True, "f_lims": [[10000, 50000]],
                          "npeaks": 3, "min_separation_hz": 100.0},
            "phase": {"run": True, "f_lims": [[10000, 50000]], "npeaks": 1},
        },
        "chan3,chan4": {"rftau": {"run": True, "rtau": 30.0, "ftau": 100.0}},
    }}


def coverage_templates(n: int = SHELL_N, pretrig: int = SHELL_PRETRIG,
                       fs: float = FS) -> dict:
    """scintillation and evaporation [n] (chan1), and the shared pulse
    [2, n] (chan1's scintillation, chan2's slower part)."""
    scint = pulse.make_template(fs, n, pretrig, A=1.0, tau_r=COV_SCINT[0],
                                tau_f1=COV_SCINT[1])
    evap = pulse.make_template(fs, n, pretrig, A=1.0, tau_r=COV_EVAP[0],
                               tau_f1=COV_EVAP[1])
    part2 = COV_SHARED[2] * pulse.make_template(
        fs, n, pretrig, A=1.0, tau_r=COV_SHARED[0], tau_f1=COV_SHARED[1])
    return {"scint": scint, "evap": evap,
            "shared": np.stack([scint, part2])}


def coverage_csd(n: int = SHELL_N, fs: float = FS) -> np.ndarray:
    """The chan1|chan2 CSD [2, 2, n] of the coverage noise: chan2 is
    COV_RHO·√(psd2/psd1) times chan1 delayed COV_LAG samples, plus its
    own part."""
    psd = shell_psds(n, fs)[:2]
    ph = np.exp(-2j * np.pi * np.fft.fftfreq(n) * COV_LAG)
    csd = np.zeros((2, 2, n), complex)
    csd[0, 0], csd[1, 1] = psd
    csd[1, 0] = COV_RHO * np.sqrt(psd[0] * psd[1]) * ph
    csd[0, 1] = np.conj(csd[1, 0])
    return csd


def coverage_filter_data(n: int = SHELL_N, pretrig: int = SHELL_PRETRIG,
                         fs: float = FS) -> FilterData:
    """The shell's filter data plus the coverage templates and CSDs."""
    fd = shell_filter_data(n, pretrig, fs)
    tm = coverage_templates(n, pretrig, fs)
    kw = dict(pretrigger_length_samples=pretrig)
    fd.set_template("chan1", tm["scint"], fs, tag="Scintillation", **kw)
    fd.set_template("chan1", tm["evap"], fs, tag="Evaporation", **kw)
    fd.set_template("chan1", np.stack([tm["scint"], tm["evap"]])[None],
                    fs, tag="ScintEvap", **kw)
    fd.set_csd("chan1", shell_psds(n, fs)[:1, None, :].astype(complex), fs)
    fd.set_template("chan1|chan2", tm["shared"][:, None, :], fs,
                    tag="shared", **kw)
    fd.set_csd("chan1|chan2", coverage_csd(n, fs), fs)
    return fd


def coverage_events(gen: torch.Generator, nevents: int, device,
                    n: int = SHELL_N, pretrig: int = SHELL_PRETRIG,
                    fs: float = FS):
    """``nevents`` events as int16 codes [E, 4, n] on ``device``: noise of
    each channel's PSD (chan2's correlated with chan1's as
    :func:`coverage_csd` says); on chan1 a scintillation pulse of 1–5 µA
    and an evaporation pulse of 1–3 µA 40–400 samples later; on chan2 the
    shared pulse's part at the scintillation amplitude and the line; on
    chan3 and chan4 two-pole pulses of COV_RFTAU rise and fall times
    (samples) and 1–3 µA; all at one offset an event within ±COV_SHIFT.
    Returns (codes, truth dict of [E] or [E, 2] tensors)."""
    nh = n // 2 + 1
    c = len(SHELL_CHANNELS)
    scale = torch.as_tensor(np.sqrt(shell_psds(n, fs)[:, :nh] * fs * n / 2.0),
                            dtype=torch.float32, device=device)
    z = torch.randn((nevents, c, 2, nh), generator=gen, device=device)
    white = torch.complex(z[:, :, 0], z[:, :, 1])
    white[..., -1] = z[:, :, 0, -1] * np.sqrt(2.0)
    lag = torch.exp(-2j * np.pi * torch.arange(nh, device=device) * COV_LAG
                    / n)
    white[:, 1] = (COV_RHO * white[:, 0] * lag
                   + np.sqrt(1.0 - COV_RHO ** 2) * white[:, 1])
    nf = white * scale
    nf[..., 0] = 0.0
    traces = torch.fft.irfft(nf, n=n)

    def uniform(lo, hi, shape=(nevents,)):
        return torch.empty(shape, device=device).uniform_(lo, hi,
                                                          generator=gen)

    shifts = torch.randint(-COV_SHIFT, COV_SHIFT + 1, (nevents,),
                           generator=gen, device=device)
    delays = torch.randint(COV_DELAY[0], COV_DELAY[1] + 1, (nevents,),
                           generator=gen, device=device)
    a_scint, a_evap = uniform(1e-6, 5e-6), uniform(1e-6, 3e-6)
    a_tau = uniform(1e-6, 3e-6, (nevents, 2))
    tm = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
          for k, v in coverage_templates(n, pretrig, fs).items()}
    idx = torch.arange(n, device=device)

    def rolled(tmpl, by):
        return tmpl[(idx[None, :] - by[:, None]) % n]

    traces[:, 0] += (a_scint[:, None] * rolled(tm["scint"], shifts)
                     + a_evap[:, None] * rolled(tm["evap"], shifts + delays))
    t = torch.arange(n, device=device, dtype=torch.float32)
    line = COV_LINE_AMP * torch.sin(2 * np.pi * coverage_line_freq(n, fs)
                                    * t / fs + COV_LINE_PHASE)
    traces[:, 1] += a_scint[:, None] * rolled(tm["shared"][1], shifts) + line
    for j, (rise, fall) in enumerate(COV_RFTAU):
        tp = t[None, :] - (pretrig + shifts[:, None]).float()
        p = torch.where(tp > 0, torch.exp(-tp / fall) - torch.exp(-tp / rise),
                        torch.zeros_like(tp))
        traces[:, 2 + j] += a_tau[:, j, None] * p / p.amax(dim=-1,
                                                            keepdim=True)
    conv = torch.as_tensor(shell_conv(), dtype=torch.float32, device=device)
    codes = torch.round(traces / conv[:, None])
    if float(codes.abs().max()) > np.iinfo(np.int16).max:
        raise ValueError("int16 ADC overflow in the synthetic events")
    truth = {"shift": shifts, "delay": delays, "scint": a_scint,
             "evap": a_evap, "tau_amp": a_tau}
    return codes.to(torch.int16), truth


def write_coverage_dumps(directory: str, gen: torch.Generator, nevents: int,
                         nfiles: int, device, chunk: int = 256,
                         n: int = SHELL_N, pretrig: int = SHELL_PRETRIG):
    """Write ``nevents`` events (:func:`coverage_events`) into ``nfiles``
    flat dumps in ``directory``, ``chunk`` events made at a time; returns
    (paths, truth dict of numpy arrays)."""
    per = -(-nevents // nfiles)
    paths, truth = [], {}
    for i in range(nfiles):
        path = os.path.join(directory,
                            f"flat_{COV_SERIES}_F{i + 1:04d}.bin")
        count = min(per, nevents - i * per)
        for j in range(0, count, chunk):
            codes, t = coverage_events(gen, min(chunk, count - j), device, n,
                                       pretrig)
            write_flat_dump(path, codes.cpu().numpy(), append=j > 0)
            for k, v in t.items():
                truth.setdefault(k, []).append(v.cpu().numpy())
        paths.append(path)
    return paths, {k: np.concatenate(v) for k, v in truth.items()}


def coverage_index(paths, n: int = SHELL_N, pretrig: int = SHELL_PRETRIG,
                   fs: float = FS) -> RawIndex:
    """The raw index of flat int16 coverage dumps."""
    return RawIndex.from_flat(
        paths, SHELL_CHANNELS, n, fs, COV_SERIES, dtype=np.int16,
        adc_conversion_factor=SHELL_CAL,
        detector_config={c: {"close_loop_norm": cln}
                         for c, cln in zip(SHELL_CHANNELS, SHELL_CLN)},
        nb_pretrigger_samples=pretrig)


def feature_coverage_entry(device=None, directory: str | None = None,
                           nevents: int = 16, seed: int = 0,
                           nfiles: int = 2):
    """Return ``(shell, index, truth)``: the :class:`FeatureProcessing`
    shell of the coverage configuration over ``nevents`` synthetic events
    that it makes on ``device`` and writes as ``nfiles`` flat int16 dumps
    into ``directory`` (a new temporary directory by default), and the
    events' injected values (:func:`coverage_events`). ``device=None``
    means the GPU."""
    device = _device(device)
    if directory is None:
        directory = tempfile.mkdtemp(prefix="detprocess_coverage_")
    os.makedirs(directory, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    paths, truth = write_coverage_dumps(directory, gen, nevents, nfiles,
                                        device)
    index = coverage_index(paths)
    shell = FeatureProcessing(index, coverage_config(),
                              coverage_filter_data(), verbose=False,
                              device=device)
    return shell, index, truth


# the filter-generation configuration (docs/CONFIG.md:115-128): the shell's
# four channels, continuous, at 4 × the default nrandoms
FG_SERIES = "I1_D20260101_T180000"
FG_EVENTS = 64
FG_NRANDOMS = 2048
FG_OFFSETS = (3e-7, 2e-7, -2e-7, -3e-7)     # DC offset a channel (A)
FG_AMP = (1e-6, 2e-6)                       # pulses and |glitches| (A)
FG_GLITCH = 2                               # glitch width, samples
FG_SUM = ((1.0, 0.5), (20e-6, 40e-6), (200e-6, 800e-6))   # chan1's "sum"
FG_THREE = (1.0, 0.3, 20e-6, 250e-6, 1e-3)  # chan2's A, B, τ_r, τ_f1, τ_f2


def filtergen_config(n: int = SHELL_N, pretrig: int = SHELL_PRETRIG,
                     nrandoms: int = FG_NRANDOMS) -> dict:
    """The processing config's noise and template sections (the dict a
    YAML file would load to)."""
    lengths = {"trace_length_samples": n, "pretrigger_length_samples": pretrig}
    template = {chan: {"run": True, **lengths, "A": 1.0,
                       "tau_r": SHELL_TAU_R, "tau_f1": tau, "tag": "default"}
                for chan, tau in zip(SHELL_CHANNELS, SHELL_TAU_F)}
    for chan, tag, block in (
            ("chan1", "sum", {"template_poles": 2,
                              "amplitude_A": list(FG_SUM[0]),
                              "rise_time": list(FG_SUM[1]),
                              "fall_time_1": list(FG_SUM[2])}),
            ("chan2", "threepole", {
                "template_poles": 3, "amplitude_A": FG_THREE[0],
                "amplitude_B": FG_THREE[1], "rise_time": FG_THREE[2],
                "fall_time_1": FG_THREE[3], "fall_time_2": FG_THREE[4]})):
        c = SHELL_CHANNELS.index(chan)
        template[chan] = {
            "template_tag_list": ["default", tag],
            "default": {"template_poles": 2, "amplitude_A": 1.0,
                        "rise_time": SHELL_TAU_R,
                        "fall_time_1": SHELL_TAU_F[c], **lengths},
            tag: {**block, **lengths}}
    return {"noise": {**lengths, "nrandoms": nrandoms},
            "template": template}


def filtergen_templates(n: int = SHELL_N, pretrig: int = SHELL_PRETRIG,
                        fs: float = FS) -> dict:
    """The analytic templates of :func:`filtergen_config`, {(channel,
    tag): [n]}."""
    out = {(c, "default"): t for c, t in zip(
        SHELL_CHANNELS, shell_templates(n, pretrig, fs))}
    t = np.arange(n) / fs
    out[("chan1", "sum")] = pulse.make_template_sum_twopoles(
        t, *FG_SUM, t0=pretrig / fs)
    a, b, tau_r, tau_f1, tau_f2 = FG_THREE
    out[("chan2", "threepole")] = pulse.make_template(
        fs, n, pretrig, A=a, B=b, tau_r=tau_r, tau_f1=tau_f1, tau_f2=tau_f2)
    return out


def filtergen_csd(n: int = SHELL_N, fs: float = FS) -> np.ndarray:
    """The CSD [4, 4, n] the noise is drawn from: the shell PSDs, and
    chan1's and chan2's cross term (:func:`coverage_csd`)."""
    csd = np.zeros((4, 4, n), complex)
    csd[np.arange(4), np.arange(4)] = shell_psds(n, fs)
    csd[:2, :2] = coverage_csd(n, fs)
    return csd


def filtergen_artifacts(rng: np.random.Generator, nevents: int,
                        length: int = TRIGGER_L) -> dict:
    """Per event and channel, one pulse (onset ``pulse`` [E, 4], amplitude
    ``pulse_amp``, the TRIGGER_NT-sample shell template from its onset)
    and one glitch (``glitch`` [E, 4], FG_GLITCH samples of ``glitch_amp``,
    either sign), placed uniformly in the event."""
    shape = (nevents, len(SHELL_CHANNELS))
    return {"pulse": rng.integers(0, length - TRIGGER_NT, shape),
            "pulse_amp": rng.uniform(*FG_AMP, shape),
            "glitch": rng.integers(0, length - FG_GLITCH, shape),
            "glitch_amp": rng.uniform(*FG_AMP, shape)
            * rng.choice([-1.0, 1.0], shape)}


def filtergen_events(gen: torch.Generator, art: dict, first: int,
                     count: int, device, length: int = TRIGGER_L,
                     fs: float = FS) -> torch.Tensor:
    """Events ``first`` … ``first + count − 1`` as int16 codes [count, 4,
    L] on ``device``: the noise of :func:`filtergen_csd` continued to the
    L-sample grid, the DC offsets, and the artifacts of ``art``."""
    c, nh = len(SHELL_CHANNELS), length // 2 + 1
    scale = torch.as_tensor(np.sqrt(shell_psds(length, fs)[:, :nh] * fs
                                    * length / 2.0), dtype=torch.float32,
                            device=device)
    z = torch.randn((count, c, 2, nh), generator=gen, device=device)
    white = torch.complex(z[:, :, 0], z[:, :, 1])
    if length % 2 == 0:
        white[..., -1] = z[:, :, 0, -1] * np.sqrt(2.0)
    lag = torch.exp(-2j * np.pi * torch.arange(nh, device=device) * COV_LAG
                    / length)
    white[:, 1] = (COV_RHO * white[:, 0] * lag
                   + np.sqrt(1.0 - COV_RHO ** 2) * white[:, 1])
    nf = white * scale
    nf[..., 0] = 0.0
    x = torch.fft.irfft(nf, n=length)
    x += torch.as_tensor(FG_OFFSETS, dtype=torch.float32,
                         device=device)[:, None]
    ev = slice(first, first + count)
    base = (torch.arange(count * c, device=device) * length).reshape(count, c)
    tmpl = torch.as_tensor(shell_templates(TRIGGER_NT, 0, fs),
                           dtype=torch.float32, device=device)
    pos = torch.as_tensor(art["pulse"][ev], device=device)
    amp = torch.as_tensor(art["pulse_amp"][ev], dtype=torch.float32,
                          device=device)
    steps = torch.arange(TRIGGER_NT, device=device)
    flat = x.view(-1)
    flat.index_add_(0, ((base + pos)[..., None] + steps).reshape(-1),
                    (amp[..., None] * tmpl).reshape(-1))
    gpos = torch.as_tensor(art["glitch"][ev], device=device)
    gamp = torch.as_tensor(art["glitch_amp"][ev], dtype=torch.float32,
                           device=device)
    gsteps = torch.arange(FG_GLITCH, device=device)
    flat.index_add_(0, ((base + gpos)[..., None] + gsteps).reshape(-1),
                    gamp[..., None].expand(-1, -1, FG_GLITCH).reshape(-1))
    conv = torch.as_tensor(shell_conv(), dtype=torch.float32, device=device)
    codes = torch.round(x / conv[:, None])
    if float(codes.abs().max()) > np.iinfo(np.int16).max:
        raise ValueError("int16 ADC overflow in the synthetic events")
    return codes.to(torch.int16)


def write_filtergen_dumps(directory: str, gen: torch.Generator,
                          rng: np.random.Generator, nevents: int,
                          nfiles: int, device, length: int = TRIGGER_L,
                          chunk: int = 8):
    """Write ``nevents`` continuous events (:func:`filtergen_events`)
    into ``nfiles`` flat dumps in ``directory``, ``chunk`` made at a time;
    returns (paths, the :func:`filtergen_artifacts` dict)."""
    art = filtergen_artifacts(rng, nevents, length)
    per = -(-nevents // nfiles)
    paths = []
    for i in range(nfiles):
        path = os.path.join(directory, f"flat_{FG_SERIES}_F{i + 1:04d}.bin")
        stop = min((i + 1) * per, nevents)
        for j in range(i * per, stop, chunk):
            codes = filtergen_events(gen, art, j, min(chunk, stop - j),
                                     device, length)
            write_flat_dump(path, codes.cpu().numpy(), append=j > i * per)
        paths.append(path)
    return paths, art


def filtergen_index(paths, length: int = TRIGGER_L,
                    fs: float = FS) -> RawIndex:
    """The raw index of flat int16 filter-generation dumps."""
    return RawIndex.from_flat(
        paths, SHELL_CHANNELS, length, fs, FG_SERIES, dtype=np.int16,
        adc_conversion_factor=SHELL_CAL,
        detector_config={c: {"close_loop_norm": cln}
                         for c, cln in zip(SHELL_CHANNELS, SHELL_CLN)},
        data_type="continuous")


def filter_generation_entry(device=None, directory: str | None = None,
                            nevents: int = FG_EVENTS, seed: int = 0,
                            length: int = TRIGGER_L,
                            nrandoms: int = FG_NRANDOMS, n: int = SHELL_N,
                            pretrig: int = SHELL_PRETRIG, nfiles: int = 4):
    """Return ``(processing, index, artifacts)``: the
    :class:`FilterDataProcessing` of the filter-generation configuration
    over ``nevents`` continuous events of ``length`` samples that it makes
    on ``device`` and writes as ``nfiles`` flat int16 dumps into
    ``directory`` (a new temporary directory by default), and the
    :func:`filtergen_artifacts` of those events. Run it with
    ``processing.process(seed=...)``. ``device=None`` means the GPU."""
    device = _device(device)
    if directory is None:
        directory = tempfile.mkdtemp(prefix="detprocess_filtergen_")
    os.makedirs(directory, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    paths, art = write_filtergen_dumps(directory, gen,
                                       np.random.default_rng(seed), nevents,
                                       nfiles, device, length)
    index = filtergen_index(paths, length)
    proc = FilterDataProcessing(noise_files=index,
                                config=filtergen_config(n, pretrig, nrandoms),
                                verbose=False, device=device)
    return proc, index, art


# the salting chain (examples/salting/saltchecks.py on the trigger shell's
# configuration): salts coincident on the four channels, each channel's
# share at the same multiple of its own trigger resolution
SALT_SIGMAS = (2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 9.0)
SALT_PER_POINT = 72
SALT_EVENTS = 64                  # continuous events of TRIGGER_L samples
SALT_SEPARATION_MSEC = 20.0       # > Nt and the coincidence window
SALT_EDGE_MSEC = 10.0             # > chan1's edge exclusion


def salting_feature_config() -> dict:
    """The feature config of the salting chain: of1x1 no-delay fits of
    the four channels on windows of the trigger templates' geometry."""
    return {"feature": {
        "trace_length_samples": TRIGGER_NT,
        "pretrigger_length_samples": TRIGGER_PRETRIG,
        ",".join(SHELL_CHANNELS): {"of1x1_nodelay": {"run": True}}}}


def salting_truth_table(salts: dict, channel: str = SHELL_CHANNELS[0]):
    """A trigger table of the salts' injected indices, one row a salt (its
    ``channel`` row), as saltchecks.py:125-150 builds it."""
    rows = np.asarray(salts["salt_channel"]).astype(str) == channel
    return {k: np.asarray(salts[k])[rows].astype(np.int64)
            for k in ("trigger_index", "series_number", "event_number",
                      "dump_number")}


def salting_chain_entry(device=None, directory: str | None = None,
                        nevents: int = SALT_EVENTS, seed: int = 0,
                        length: int = TRIGGER_L,
                        nsalt: int = SALT_PER_POINT):
    """Return ``(salting, trigger_shell, feature_shell, index)``: noise-only
    continuous events of the four shell channels (``nevents`` of
    ``length`` samples, written as one flat int16 dump into ``directory``,
    a new temporary directory by default; the injectors match salts by
    (series, event), as the JAX ones do, and a flat dump numbers its
    events from 1, so a second dump of the same series would share them), the
    :class:`Salting` of ``nsalt`` salts at each of :data:`SALT_SIGMAS`
    (``energy_norm_ev_per_amp`` set a channel so that each channel's
    quarter lands at that many of its own resolutions), and both shells
    with its device injector: the trigger shell of
    :func:`trigger_shell_config` and the feature shell of
    :func:`salting_feature_config` on :func:`salting_truth_table`.
    ``device=None`` means the GPU."""
    device = _device(device)
    if directory is None:
        directory = tempfile.mkdtemp(prefix="detprocess_salting_")
    gen = torch.Generator().manual_seed(seed)
    paths, _ = write_trigger_dumps(directory, gen, nevents, 1, device,
                                   length, ncoincident=0, nsingles=0,
                                   saturating=False)
    index = trigger_shell_index(paths, length)
    fd = shell_filter_data(TRIGGER_NT, TRIGGER_PRETRIG)
    share = 1.0 / len(SHELL_CHANNELS)
    salting = Salting(fd, verbose=False)
    salts = salting.generate_salt(
        index, SHELL_CHANNELS, energies=list(SALT_SIGMAS), nsalt=nsalt,
        energy_norm_ev_per_amp={c: share / r for c, r in zip(
            SHELL_CHANNELS, trigger_shell_resolutions())},
        min_separation_msec=SALT_SEPARATION_MSEC,
        edge_exclusion_msec=SALT_EDGE_MSEC, seed=seed)
    per_event = -(-len(SALT_SIGMAS) * nsalt // nevents)
    injector = salting.make_device_injector(
        SHELL_CHANNELS, max_salts_per_event=2 * len(SHELL_CHANNELS)
        * per_event)
    tshell = TriggerProcessing(
        index, trigger_shell_config(), fd, verbose=False, device=device)
    tshell.set_salting(injector)
    fshell = FeatureProcessing(
        index, salting_feature_config(), fd,
        trigger_table=salting_truth_table(salts), verbose=False,
        device=device)
    fshell.set_salting(injector)
    return salting, tshell, fshell, index


# the IV/dIdV sweep (examples/iv_didv/ivsweep_analysis.py and
# tests/test_ivsweep_pipeline.py at a sweep's real size): one channel,
# 32 bias points from the normal branch through the transition to the SC
# branch, each with its noise series and its dIdV series
IV_SERIES = "I1_D20260102_T{:06d}"
IV_RSH = 5e-3                      # shunt (Ω)
IV_RP = 4e-3                       # parasitic resistance (Ω)
IV_RN = 0.30                       # normal resistance (Ω)
IV_TC, IV_TBATH, IV_TLOAD = 0.040, 0.020, 0.030    # K
IV_SGFREQ, IV_SGAMP = 100.0, 2e-8  # square wave (Hz, A)
IV_IOFFSET = -1.3e-6               # SQUID current offset (A)
IV_P0 = 1e-12                      # bias power in the transition (W)
IV_BETA, IV_LOOPGAIN = 2.0, 10.0
IV_L = 4e-7                        # inductance (H)
IV_TAU0 = 1e-3                     # C/G (s)
IV_SQUID = 1e-11                   # SQUID noise (A/√Hz)
IV_DIDV_NOISE = 2e-10              # white noise of the dIdV traces (A)
IV_NORMAL = tuple(np.linspace(400e-6, 260e-6, 8))        # bias (A)
IV_TRANSITION_R0 = tuple(np.linspace(0.25, 0.03, 16))    # Ω
IV_SC = tuple(np.linspace(8e-6, 1e-6, 8))                # bias (A)
IV_NOISE_TRACES, IV_N = 128, 32768
IV_DIDV_TRACES, IV_PERIODS = 32, 8
IV_ADC_HEADROOM = 1.25             # full scale over the largest current


def ivsweep_points(normal=IV_NORMAL, transition_r0=IV_TRANSITION_R0,
                   sc=IV_SC) -> list:
    """The sweep's bias points from the largest bias: dicts of
    ``tes_bias``, ``state`` and the ``models/tesnoise.TESParams`` of the
    working point (normal and SC points have no electro-thermal
    feedback; the transition holds the bias power at :data:`IV_P0`)."""
    rl = IV_RSH + IV_RP
    g = 5.0 * IV_P0 / (IV_TC * (1.0 - (IV_TBATH / IV_TC) ** 5))

    def params(r0, i0, beta, loop, tau0):
        return tesnoise.TESParams(
            r0=r0, rl=rl, beta=beta, l=loop, L=IV_L, tau0=tau0, G=g,
            tc=IV_TC, tload=IV_TLOAD, tb=IV_TBATH, i0=i0,
            squiddc=IV_SQUID)

    points = []
    for ib in normal:
        points.append({"tes_bias": float(ib), "state": "normal",
                       "params": params(IV_RN, ib * IV_RSH / (IV_RN + rl),
                                        0.0, 0.0, 1e-6)})
    for r0 in transition_r0:
        i0 = float(np.sqrt(IV_P0 / r0))
        points.append({"tes_bias": i0 * (r0 + rl) / IV_RSH,
                       "state": "transition",
                       "params": params(float(r0), i0, IV_BETA,
                                        IV_LOOPGAIN, IV_TAU0)})
    for ib in sc:
        points.append({"tes_bias": float(ib), "state": "sc",
                       "params": params(0.0, ib * IV_RSH / rl, 0.0, 0.0,
                                        1e-6)})
    return points


def ivsweep_adc_cal(points) -> float:
    """Amps per ADC code: full scale at :data:`IV_ADC_HEADROOM` times the
    normal branch's largest current."""
    largest = max(abs(p["params"].i0 + IV_IOFFSET) for p in points
                  if p["state"] == "normal")
    return IV_ADC_HEADROOM * largest / 32767.0


def ivsweep_noise(gen: torch.Generator, p, nev: int, n: int, device,
                  fs: float = FS) -> torch.Tensor:
    """Noise traces [nev, n] float64 of working point ``p``: Gaussian
    noise of the (one-sided) ``tesnoise.s_itot`` spectrum, plus i0 and
    the SQUID offset."""
    f = np.fft.fftfreq(n, 1.0 / fs)
    psd = tesnoise.s_itot(p, np.where(f == 0, f[1], f))
    scale = torch.as_tensor(np.sqrt(psd / 2.0 * fs * n), device=device)
    white = torch.fft.fft(torch.randn((nev, n), generator=gen,
                                      dtype=torch.float64, device=device),
                          dim=-1) / np.sqrt(n)
    return (torch.fft.ifft(white * scale, dim=-1).real
            + (p.i0 + IV_IOFFSET))


def ivsweep_didv(gen: torch.Generator, p, nev: int, nper: int, device,
                 fs: float = FS) -> torch.Tensor:
    """dIdV traces [nev, nper·fs/sgfreq] float64: the response of working
    point ``p`` to the square wave of :data:`IV_SGAMP` through the shunt
    (``tesnoise.didv``), white noise of :data:`IV_DIDV_NOISE`, i0 and the
    offset."""
    period = int(round(fs / IV_SGFREQ))
    n = period * nper
    t = np.arange(n)
    square_v = np.where((t % period) < period // 2, 0.5, -0.5) * (
        IV_SGAMP * IV_RSH)
    f = np.fft.fftfreq(n, 1.0 / fs)
    resp = tesnoise.didv(p, np.where(f == 0, f[1], f))
    resp_t = np.real(np.fft.ifft(resp * np.fft.fft(square_v)))
    noise = torch.randn((nev, n), generator=gen, dtype=torch.float64,
                        device=device) * IV_DIDV_NOISE
    return (torch.as_tensor(resp_t, device=device)[None, :] + noise
            + (p.i0 + IV_IOFFSET))


def ivsweep_index(path: str, nb_samples: int, series: str, cal: float,
                  tes_bias: float, data_type: str,
                  fs: float = FS) -> RawIndex:
    """The raw index of one flat int16 sweep dump of channel
    :data:`CHANNEL` (its ``tes_bias`` in the detector config)."""
    return RawIndex.from_flat(
        [path], [CHANNEL], nb_samples, fs, series, dtype=np.int16,
        adc_conversion_factor=cal,
        detector_config={CHANNEL: {"tes_bias": tes_bias,
                                   "close_loop_norm": 1.0}},
        data_type=data_type)


def ivsweep_codes(gen: torch.Generator, device, points, ntraces: int,
                  n: int, ndidv: int, nper: int):
    """Each bias point's noise (``ntraces`` × ``n``) and dIdV (``ndidv``
    × ``nper`` periods) traces, made on ``device`` as int16 codes of
    :func:`ivsweep_adc_cal`: yields (point index, "noise" or "didv",
    series name, codes [E, 1, width] on the host)."""
    cal = ivsweep_adc_cal(points)
    for k, pt in enumerate(points):
        for kind, make in (
                ("noise", lambda: ivsweep_noise(gen, pt["params"], ntraces,
                                                n, device)),
                ("didv", lambda: ivsweep_didv(gen, pt["params"], ndidv,
                                              nper, device))):
            series = IV_SERIES.format((1 if kind == "noise" else 2) * 10000
                                      + k)
            codes = torch.round(make() / cal).clamp(-32768, 32767).to(
                torch.int16)
            yield k, kind, series, codes[:, None, :].cpu().numpy()


def write_ivsweep_dumps(directory: str, gen: torch.Generator, device,
                        points=None, ntraces: int = IV_NOISE_TRACES,
                        n: int = IV_N, ndidv: int = IV_DIDV_TRACES,
                        nper: int = IV_PERIODS) -> list:
    """Write each bias point's noise and dIdV traces
    (:func:`ivsweep_codes`) as one flat dump each in ``directory``;
    returns the bias points (:func:`ivsweep_points` by default) with
    their ``noise_files`` and ``didv_files`` as raw indexes, the input of
    ``IVSweepProcessing.process``."""
    points = ivsweep_points() if points is None else points
    cal = ivsweep_adc_cal(points)
    out = [dict(pt) for pt in points]
    for k, kind, series, codes in ivsweep_codes(gen, device, points,
                                                ntraces, n, ndidv, nper):
        path = os.path.join(directory, f"{kind}_{series}_F0001.bin")
        write_flat_dump(path, codes)
        out[k][f"{kind}_files"] = ivsweep_index(
            path, codes.shape[-1], series, cal, points[k]["tes_bias"],
            "noise" if kind == "noise" else "didv")
    return out


def write_ivsweep_group(directory: str, gen: torch.Generator, device,
                        points=None, ntraces: int = IV_NOISE_TRACES,
                        n: int = IV_N, ndidv: int = IV_DIDV_TRACES,
                        nper: int = IV_PERIODS) -> list:
    """The sweep of :func:`write_ivsweep_dumps` as a flat raw group: each
    point's noise series ``iv_{series}`` and dIdV series
    ``didv_{series}`` (:func:`io.rawdata.write_flat_series`), their
    ``tes_bias`` in the manifests' detector config, where
    ``pipelines/ivsweep.discover_bias_points`` finds them. Returns the
    manifest paths."""
    points = ivsweep_points() if points is None else points
    cal = ivsweep_adc_cal(points)
    manifests = []
    for k, kind, series, codes in ivsweep_codes(gen, device, points,
                                                ntraces, n, ndidv, nper):
        mpath, _ = write_flat_series(
            directory, "iv" if kind == "noise" else "didv", series,
            [codes], [CHANNEL], FS, adc_conversion_factor=cal,
            detector_config={CHANNEL: {
                "tes_bias": points[k]["tes_bias"], "close_loop_norm": 1.0}})
        manifests.append(mpath)
    return manifests


def ivsweep_entry(device=None, directory: str | None = None, seed: int = 0,
                  points=None, ntraces: int = IV_NOISE_TRACES,
                  n: int = IV_N, ndidv: int = IV_DIDV_TRACES,
                  nper: int = IV_PERIODS):
    """Return ``(processing, bias_points)``: the
    ``pipelines/ivsweep.IVSweepProcessing`` on ``device`` and the bias
    points of the sweep that :func:`write_ivsweep_dumps` writes into
    ``directory`` (a new temporary directory by default). Run it with
    :func:`run_ivsweep`. ``device=None`` means the GPU."""
    from detprocess_tpu_torch.pipelines.ivsweep import IVSweepProcessing

    device = _device(device)
    if directory is None:
        directory = tempfile.mkdtemp(prefix="detprocess_ivsweep_")
    os.makedirs(directory, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    bias_points = write_ivsweep_dumps(directory, gen, device, points,
                                      ntraces, n, ndidv, nper)
    return IVSweepProcessing(verbose=False, device=device), bias_points


def ivsweep_template(n: int = IV_N, fs: float = FS) -> np.ndarray:
    """The unit-peak current template of the sweep's energy resolution
    (20 µs rise, 200 µs fall, pretrigger n/2)."""
    return pulse.make_template(fs, n, n // 2, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)


def run_ivsweep(processing, bias_points, poles=(2, 3), timer=None):
    """Process the sweep (module ``pipelines/ivsweep``) and analyse it:
    IBIS, the state-aware dIdV fits (transition points within 5–95 % of
    Rn), the noise model and σ_E of each transition point with
    :func:`ivsweep_template`. Returns ``(table, analysis, noise)``;
    ``timer`` takes the reads and the device work, and the CPU fits by
    step: "ibis", "didv fits", "noise model", "energy resolution"."""
    from contextlib import nullcontext

    from detprocess_tpu_torch.pipelines.ivsweep import IVSweepAnalysis

    def stage(name):
        return timer.stage(name) if timer is not None else nullcontext()

    table = processing.process(CHANNEL, bias_points, sgfreq=IV_SGFREQ,
                               sgamp=IV_SGAMP, rsh=IV_RSH, timer=timer)
    ana = IVSweepAnalysis(verbose=False)
    ana.set_data_from_dataframe(CHANNEL, table, rsh=IV_RSH)
    with stage("ibis"):
        ana.analyze_sweep(CHANNEL)
    with stage("didv fits"):
        ana.analyze_didv(CHANNEL, poles=poles,
                         transition_percent_rn_max=95.0)
    with stage("noise model"):
        noise = ana.analyze_noise(CHANNEL, tc=IV_TC, tbath=IV_TBATH,
                                  tload_guess=IV_TLOAD, poles=min(poles))
    with stage("energy resolution"):
        fs = float(np.asarray(table["fs"])[0])
        n = len(next(v for v in table["psd"] if v is not None))
        ana.calc_energy_resolution(CHANNEL, ivsweep_template(n, fs), fs,
                                   poles=min(poles))
    return table, ana, noise


def didv_filtergen_config(ivsweep_results: dict, poles=(2, 3)) -> dict:
    """The ``didv`` section of a filter-generation config for
    :data:`CHANNEL` (docs/CONFIG.md's didv block): the square wave, the
    shunt, the pole counts and the IV-sweep bias point."""
    return {"didv": {CHANNEL: {
        "sgfreq": IV_SGFREQ, "sgamp": IV_SGAMP, "rshunt": IV_RSH,
        "poles": list(poles), "ivsweep_results": dict(ivsweep_results)}}}


def didv_filtergen_entry(device=None, directory: str | None = None,
                         seed: int = 0, nseries: int = 4, r0: float = 0.1,
                         ndidv: int = IV_DIDV_TRACES,
                         nper: int = IV_PERIODS, poles=(2, 3)):
    """Return ``(processing, series, point)``: the dIdV branch of filter
    generation (``FilterDataProcessing`` with :func:`didv_filtergen_config`)
    over ``nseries`` dIdV series of the sweep's configuration taken at the
    transition point of resistance ``r0`` (flat int16 dumps written into
    ``directory``), with the IV bias point of that point (its true i0, r0
    and the sweep's Rp and Rshunt). ``series`` maps each series name to
    its raw index. Run it with ``processing.proces_didv()``.
    ``device=None`` means the GPU."""
    device = _device(device)
    if directory is None:
        directory = tempfile.mkdtemp(prefix="detprocess_didv_")
    os.makedirs(directory, exist_ok=True)
    point = ivsweep_points(normal=(), transition_r0=(r0,), sc=())[0]
    cal = ivsweep_adc_cal(ivsweep_points())
    gen = torch.Generator(device=device).manual_seed(seed)
    period = int(round(FS / IV_SGFREQ))
    series = {}
    for k in range(nseries):
        name = IV_SERIES.format(30000 + k)
        codes = torch.round(ivsweep_didv(gen, point["params"], ndidv, nper,
                                         device) / cal).clamp(
            -32768, 32767).to(torch.int16)
        path = os.path.join(directory, f"didv_{name}_F0001.bin")
        write_flat_dump(path, codes[:, None, :].cpu().numpy())
        series[name] = ivsweep_index(path, period * nper, name, cal,
                                     point["tes_bias"], "didv")
    proc = FilterDataProcessing(
        didv_files=series,
        config=didv_filtergen_config(ivsweep_results_of(point), poles),
        verbose=False, device=device)
    return proc, series, point


def ivsweep_results_of(point) -> dict:
    """The IV-sweep results of a bias point of :func:`ivsweep_points`:
    its true i0, r0 and p0, the sweep's Rp and Rshunt, and its bias."""
    p = point["params"]
    return {"i0": p.i0, "r0": p.r0, "rp": IV_RP, "rshunt": IV_RSH,
            "ibias": point["tes_bias"], "p0": p.i0 ** 2 * p.r0}


# the command line (python -m detprocess_tpu_torch.cli) over files: the
# filter-generation data as a flat raw group, the setup as JSON, and the
# sweep as a second flat group
CLI_SERIES = "I1_D20260103_T000000"        # the continuous group's series
CLI_OUT_SERIES = "I1_D20260103_T120000"    # the calls' output series


def cli_setup(nrandoms: int = FG_NRANDOMS,
              nsalt: int = SALT_PER_POINT) -> dict:
    """The chain's processing setup (the dict its JSON file holds): the
    noise and template sections of :func:`filtergen_config` at the
    trigger templates' geometry (TRIGGER_NT, TRIGGER_PRETRIG), the
    trigger section of :func:`trigger_shell_config`, the salting of
    :func:`salting_chain_entry` (``nsalt`` salts at each of
    :data:`SALT_SIGMAS`, each channel's quarter at that many of its
    analytic trigger resolutions) and the feature section of
    :func:`salting_feature_config`."""
    share = 1.0 / len(SHELL_CHANNELS)
    return {
        **filtergen_config(TRIGGER_NT, TRIGGER_PRETRIG, nrandoms),
        **trigger_shell_config(),
        "salting": {
            "energies": list(SALT_SIGMAS), "nsalt": int(nsalt),
            "energy_norm_ev_per_amp": {
                c: share / float(r) for c, r in zip(
                    SHELL_CHANNELS, trigger_shell_resolutions())},
            "min_separation_msec": SALT_SEPARATION_MSEC,
            "edge_exclusion_msec": SALT_EDGE_MSEC},
        **salting_feature_config()}


def cli_sweep_setup() -> dict:
    """The sweep's processing setup: its square wave and shunt."""
    return {"didv": {"sgfreq": IV_SGFREQ, "sgamp": IV_SGAMP,
                     "rshunt": IV_RSH}}


class CliChain:
    """The command lines of the chain over the groups that
    :func:`cli_chain_entry` writes: :attr:`a` (filter generation and
    randoms), :meth:`b` (salting with the device injector, trigger and
    features, given call A's filter file) and :attr:`c` (the IV sweep),
    each writing npz into :attr:`out` (or another output base).
    :attr:`artifacts` holds the raw events' pulses and glitches
    (:func:`filtergen_artifacts`)."""

    def __init__(self, raw: str, sweep: str, setup: str, sweep_setup: str,
                 out: str, device: str, seed: int, nrandoms: int,
                 artifacts: dict):
        self.raw, self.sweep, self.out = raw, sweep, out
        self.setup, self.sweep_setup = setup, sweep_setup
        self.device, self.seed, self.nrandoms = device, seed, nrandoms
        self.artifacts = artifacts

    def _common(self, raw, setup, out):
        return ["--raw_path", raw, "--processing_setup", setup,
                "--output_group_path", out, "--output-format", "npz",
                "--output-series-name", CLI_OUT_SERIES, "--device",
                self.device, "--quiet"]

    @property
    def a(self) -> list:
        return self._common(self.raw, self.setup, self.out) + [
            "--calc-filter", "--enable-rand", "--nrandoms",
            str(self.nrandoms), "--seed", str(self.seed)]

    def b(self, filter_file: str, out: str | None = None) -> list:
        return self._common(self.raw, self.setup, out or self.out) + [
            "--filter_file", filter_file, "--enable-salting",
            "--device-salting", "--enable-trig", "--enable-feature",
            "--seed", str(self.seed)]

    @property
    def c(self) -> list:
        return self._common(self.sweep, self.sweep_setup, self.out) + [
            "--enable-ivsweep"]

    def filter_file(self, out: str | None = None) -> str:
        """The filter file that call A wrote."""
        directory = os.path.join(out or self.out, "filterdata")
        files = sorted(os.listdir(directory))
        if len(files) != 1:
            raise RuntimeError(f"expected one filter file in {directory}, "
                               f"found {files}")
        return os.path.join(directory, files[0])


def cli_chain_entry(device=None, directory: str | None = None,
                    nevents: int = FG_EVENTS, seed: int = 0,
                    length: int = TRIGGER_L, nrandoms: int = FG_NRANDOMS,
                    nsalt: int = SALT_PER_POINT, points=None,
                    ntraces: int = IV_NOISE_TRACES, n: int = IV_N,
                    ndidv: int = IV_DIDV_TRACES,
                    nper: int = IV_PERIODS) -> CliChain:
    """Write the chain's inputs into ``directory`` (a new temporary
    directory by default) and return its :class:`CliChain`:

    - ``raw/``: ``nevents`` continuous events of ``length`` samples of
      the filter-generation data (:func:`filtergen_events`: noise, DC
      offsets, a pulse and a glitch a channel and event), made on
      ``device`` and written as one flat series ``cont_{CLI_SERIES}`` of
      one dump (the salt injectors match salts by series and event, and a
      dump numbers its events from 1);
    - ``process.json``: :func:`cli_setup`;
    - ``sweep/`` and ``sweep.json``: the IV/dIdV sweep of
      :func:`write_ivsweep_group` and :func:`cli_sweep_setup`.

    ``device=None`` means the GPU, and the command lines run there."""
    from detprocess_tpu_torch.config.yamlconfig import write_json_setup

    device = _device(device)
    if directory is None:
        directory = tempfile.mkdtemp(prefix="detprocess_cli_")
    os.makedirs(directory, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    art = filtergen_artifacts(np.random.default_rng(seed), nevents, length)
    chunk = 8
    raw = os.path.join(directory, "raw")
    write_flat_series(
        raw, "cont", CLI_SERIES,
        [(filtergen_events(gen, art, j, min(chunk, nevents - j), device,
                           length).cpu().numpy()
          for j in range(0, nevents, chunk))],
        SHELL_CHANNELS, FS, adc_conversion_factor=SHELL_CAL,
        detector_config={c: {"close_loop_norm": cln}
                         for c, cln in zip(SHELL_CHANNELS, SHELL_CLN)})
    sweep = os.path.join(directory, "sweep")
    write_ivsweep_group(sweep, gen, device, points, ntraces, n, ndidv, nper)
    setup = write_json_setup(cli_setup(nrandoms, nsalt),
                             os.path.join(directory, "process.json"))
    sweep_setup = write_json_setup(cli_sweep_setup(),
                                   os.path.join(directory, "sweep.json"))
    return CliChain(raw, sweep, setup, sweep_setup,
                    os.path.join(directory, "out"), str(device), seed,
                    nrandoms, art)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The JAX dryrun of the mesh (``__graft_entry__.dryrun_multichip``
    :93, its body ``_dryrun_body`` :151) on ``n_devices`` virtual shards
    of ``device`` (None: the GPU); raises AssertionError where a section's
    check fails and returns a summary of the sections' counts.

    1. the feature step of :func:`entry`'s template at N = 1024, event-
       sharded (4 events a shard; one :class:`FeatureStep` a device);
    2. the PSD and 3. the two-channel CSD with one psum each;
    4. continuous triggering sharded over events (8192 samples an event,
       one 1e-5 A pulse at sample 4000);
    5. one long trace of 4096 samples a shard split in time, a pulse a
       shard and one across the first boundary;
    6. the trigger shell with ``mesh=`` on n + 1 int16 events (an unequal
       last shard), with a salt an event added by the device injector;
    7. two coincident channels through the shell with ``mesh=`` and a
       coincidence window of 50 samples: one merged row an event.
    """
    import shutil

    device = _device(device)
    mesh = pmesh.Mesh([device] * n_devices)
    fs, n = FS, 1024
    pretrig = n // 2
    batch = 4 * n_devices
    bank, template, _ = build_bank(n, pretrig, fs)
    rng = np.random.default_rng(0)
    traces = torch.as_tensor((rng.standard_normal((batch, n)) * 1e-8
                              + 1e-6 * template[None, :]).astype(np.float32))
    shards = pmesh.shard_batch(mesh, traces)
    summary: dict = {}

    # 1) the feature step, one FeatureStep a device
    steps = {d: FeatureStep(filterbank.bank_to_torch(bank, d, torch.float32),
                            [CHANNEL], fs, pretrig, n) for d in mesh.devices}
    feats = pmesh.unshard(mesh, pmesh.sharded_map(
        mesh, lambda x, step: step(x[:, None, :]))(
        shards, [steps[d] for d in mesh.devices]))
    amps = feats[f"amp_of1x1_unconstrained_{CHANNEL}"]
    assert amps.shape == (batch,) and bool(torch.isfinite(amps).all()), \
        "non-finite amplitudes in the sharded feature step"
    summary["feature_events"] = batch

    # 2) the PSD, 3) the CSD of two channels
    psd = pmesh.sharded_psd(mesh, fs)(shards)
    assert psd.shape == (n,) and bool(torch.isfinite(psd).all()) \
        and bool((psd >= 0).all())
    csd = pmesh.sharded_csd(mesh, fs)(
        [torch.stack([x, 0.5 * x], dim=1) for x in shards])
    assert csd.shape == (2, 2, n) and bool(torch.isfinite(csd).all())

    # 4) continuous triggering sharded over events
    psd_level = 4e-18
    nxm = filterbank.make_ofnxm_bank(
        template, np.full(n, psd_level).astype(complex), fs, pretrig)
    kernel = trigger.make_trigger_kernel(nxm)
    thr = float(trigger.chi2_threshold(5.0, 1))
    sigma = np.sqrt(psd_level * fs)
    l_cont = 8192
    cont = (rng.standard_normal((batch, 1, l_cont)) * sigma).astype(
        np.float32)
    cont[:, 0, 4000 - pretrig:4000 - pretrig + n] += 1e-5 * template
    ts = pmesh.sharded_trigger(mesh, kernel, thr, 125, 32)(
        pmesh.shard_batch(mesh, torch.as_tensor(cont)))
    assert ts.count.shape == (batch,) and bool((ts.count >= 1).all())
    assert bool(((ts.indices[:, 0] - 4000).abs() <= 5).all())
    summary["triggers"] = int(ts.count.sum())

    # 5) one long trace split in time, with the halo exchange
    l_loc = 4096
    l_long = n_devices * l_loc
    xlong = (rng.standard_normal((1, l_long)) * sigma).astype(np.float32)
    inj = [s * l_loc + l_loc // 2 for s in range(n_devices)]
    if n_devices >= 2:
        inj.append(l_loc - n // 4)
    for t0 in inj:
        xlong[0, t0 - pretrig:t0 - pretrig + n] += 2e-5 * template
    lt = pmesh.sharded_longtrace_trigger(mesh, kernel, thr, 125, 16)(
        pmesh.shard_time(mesh, torch.as_tensor(xlong)))
    g_idx, _, _ = pmesh.merge_sharded_triggers(lt.indices, lt.dchi2,
                                               lt.amplitudes)
    for t0 in inj:
        if n < t0 < l_long - n:            # the trace's edges are zeroed
            assert any(abs(int(i) - t0) <= 5 for i in g_idx), t0
    summary["longtrace_triggers"] = len(g_idx)

    # 6) the trigger shell with mesh= on int16 codes, device salting
    nev = n_devices + 1
    conv = 2.0 ** -25 / 2.0                  # adc factor / close_loop_norm
    tmp = tempfile.mkdtemp(prefix="detprocess_dryrun_mesh_")
    try:
        series = "I1_D20260818_T000000"
        cont2 = rng.standard_normal((nev, 1, l_cont)) * sigma
        cont2[:, 0, 4000 - pretrig:4000 - pretrig + n] += 2e-5 * template
        write_flat_series(os.path.join(tmp, "one"), "cont", series,
                          [np.round(cont2 / conv).astype(np.int16)],
                          ["chan1"], fs, adc_conversion_factor=2.0 ** -25,
                          detector_config={"chan1": {"close_loop_norm": 2.0}})
        fd = FilterData(verbose=False)
        for c in ("chan1", "chan2"):
            fd.set_template(c, template, fs,
                            pretrigger_length_samples=pretrig)
            fd.set_psd(c, np.full(n, psd_level), fs)

        def shell(directory, chans):
            cfg = {"trigger": {c: {
                "run": True, "template_tag": "default",
                "threshold_sigma": 8.0, "pileup_window_msec": 0.1}
                for c in chans}}
            index = RawIndex.from_files(sorted(
                os.path.join(directory, f) for f in os.listdir(directory)
                if f.endswith(".bin")))
            return TriggerProcessing(index, cfg, fd, verbose=False,
                                     device=device)

        from detprocess_tpu_torch.io.rawdata import series_to_number
        salting = Salting(fd, verbose=False)
        salting.set_dataframe({
            "series_number": np.full(nev, series_to_number(series)),
            "event_number": np.arange(1, nev + 1),
            "salt_channel": np.array(["chan1"] * nev),
            "salt_amplitude": np.full(nev, 2e-5),
            "salt_template_tag": np.array(["default"] * nev),
            "trigger_index": np.full(nev, 6000),
            "salt_energy_ev": np.full(nev, 50.0)})
        tp = shell(os.path.join(tmp, "one"), ["chan1"])
        tp.set_salting(salting.make_device_injector(["chan1"]))
        table = tp.process(capacity=32, event_batch=nev, mesh=mesh)
        ti, ev = table["trigger_index"], table["event_number"]
        assert len(ti) >= 2 * nev, "the mesh shell missed triggers"
        for e in range(1, nev + 1):
            assert np.any(np.abs(ti[ev == e] - 4000) <= 5), e   # written
            assert np.any(np.abs(ti[ev == e] - 6000) <= 5), e   # salted
        summary["shell_triggers"] = len(ti)

        # 7) two coincident channels over the mesh
        cont3 = rng.standard_normal((nev, 2, l_cont)) * sigma
        cont3[:, 0, 4000 - pretrig:4000 - pretrig + n] += 2e-5 * template
        cont3[:, 1, 4004 - pretrig:4004 - pretrig + n] += 1.5e-5 * template
        write_flat_series(os.path.join(tmp, "two"), "cont",
                          "I1_D20260818_T000100",
                          [np.round(cont3 / conv).astype(np.int16)],
                          ["chan1", "chan2"], fs,
                          adc_conversion_factor=2.0 ** -25,
                          detector_config={c: {"close_loop_norm": 2.0}
                                           for c in ("chan1", "chan2")})
        coinc = shell(os.path.join(tmp, "two"), ["chan1", "chan2"]).process(
            capacity=32, event_batch=nev, mesh=mesh,
            coincident_window_samples=50)
        merged = int(np.sum(np.isfinite(coinc["trigger_index_chan2"].astype(
            float)) & (coinc["trigger_channel"] == "chan1")))
        assert merged == nev, (merged, nev)   # one merged pair an event
        summary["coincidence_merges"] = merged
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return summary
