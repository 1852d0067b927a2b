#!/usr/bin/env python3
"""GPU smoke run of detprocess_tpu_torch: the of1x1 feature step, the
continuous-data trigger step and the FeatureProcessing shell on one card.

    python3 chip_smoke.py [--parent DIR]

Phases (each failure ends the run with a non-zero exit):

a. device: the card's name and power limit (nvidia-smi), require_cuda();
b. build: nvcc compiles the kernels under detprocess_tpu_torch/csrc/
   (set-up time; the compiler's register/spill report is printed, and
   each kernel's registers and spills at each N); it fails on a spill in
   an instance that the main path launches (the stamped ones may spill);
c. kernels: each hand-written kernel against its plain PyTorch twin on
   the card, B = 64 and every N in cuda_fft.SUPPORTED_N (256 … 32768):
   rFFT max|Δ|/max|ref| <= 1e-5; fused no-delay amp rtol 1e-5, χ² rtol
   5e-3 (the χ² sits at the float32 cancellation floor of
   χ²₀ − q²/norm), at S = 1 and, at N = 32768, at S = 9, 11 and 17;
   at S = 1 also the χ² of kernel and twin against the float64 twin;
d. slice: entry() once, then FeatureStep at the benchmark's size
   (N = 32768, pretrigger N/2, 1/f PSD, 8 batches of 8192 events of
   PSD-matched noise plus pulses made on the card from a seeded
   torch.Generator). It checks that both kernels were launched on the main
   path, that the first events agree with the float64 CPU run of the same
   step and with the per-event numpy reference tests/reference_impl.py
   (RefOF1x1, which imports numpy only), and the physics invariants (|amp bias| < 5e-3, |χ²/dof − 1| <
   0.05, t0 within one sample for > 99% of events). It compares each
   kernel with its twin again on the slice's own batch, and prints
   events/s (CUDA events), a per-layer time breakdown, and each kernel's
   time beside its plain twin's at the slice shapes; the rFFT kernel also
   at N = 16384, the entry() length, and with its share of the HBM peak;
   the fused kernel's time and HBM share at B = 8192, N = 16384 and
   32768, and the SM clocks of each kernel's phases at both lengths in
   one launch of its stamped instance. With ``--parent DIR`` (an earlier
   checkout unpacked by ``git archive``) it also times that tree's rFFT
   kernel in turns with this one on the slice's batch: the rFFT entry's
   ``earlier_ms`` in the summary, null without it.
e. trigger: trigger_entry() once on its noise batch, then TriggerStep at
   the trigger_entry() configuration (8 events of
   1,250,000 samples at 1.25 MHz, Nt = 4096, flat PSD 4e-18 A²/Hz,
   window 125, 5σ, capacity 4096, saturation veto on) in base and in
   residual mode, 8 batches each, with 10 pulses of 10 resolution σ per
   event and one that saturates the low-passed trace, injected on the
   card at known indices (seeded torch.Generator). It fails unless every
   pulse is triggered within ±256 samples and 5σ in amplitude (the
   saturating one in the residual pass too, since the veto keeps it from
   the subtraction), the 10σ pulses' median |offset| and mean offset stay
   within the float64 reference's range, the worst pulse's event gives
   the same triggers and offset in the float64 CPU run, event 0 of the
   first batch agrees with the float64 CPU run of the same step (the same
   indices but for triggers whose Δχ² is within 1e-3 of the threshold;
   Δχ² and amplitudes within rtol 1e-4; the same saturation mask; the
   first-pass and residual Δχ² series within 1e-4 of √(|Δχ²|·its
   largest value within one FIR segment) + threshold at every sample),
   and the rFFT kernel ran once a batch for the FIR and
   once more in residual mode for the subtraction's convolution. It
   checks the rFFT kernel against its twin on the path's segments
   (F = 16384 and 32768), and prints Msamples/s (CUDA events; also the
   host clock), the device busy share of one batch (torch.profiler) and
   its largest kernels, per-layer ms (CUDA events around each layer of
   TriggerStep.forward, through its run_layer hook, so host gaps count),
   and the launches of each kernel and of the cuFFT route.
f. lengths outside the kernels' domain: FeatureStep at N = 25000 and
   65536 on 64 events: neither kernel launches, the cuFFT route runs, and
   the first events agree with the float64 CPU step within phase (d)'s
   tolerances.
g. the FeatureProcessing shell (entry.py's 4-channel configuration,
   BASELINE.json config 4): 8192 events of PSD-matched noise plus 1–5 µA
   pulses at known offsets are written as int16 codes into 4 flat dumps
   in a temporary directory (2 GiB, deleted at the end), indexed, and
   processed with process(batch_size=2048, float32, nreaders=4). It fails
   unless rfft and fused_nodelay_of each launch 5 times a batch with the
   cuFFT route at 0, the upload is 2 bytes a sample, every channel meets
   the physics invariants (|amp bias| < 5e-3, |χ²/dof − 1| < 0.05,
   unconstrained t0 within one sample of the injected offset for > 99% of
   events, constrained t0 inside its ±100 µs window), events 0–15 of every
   batch agree with the float64 CPU run of the shell (phase (d)'s
   tolerances; constrained columns as unconstrained, ampres and timeres
   1e-5) and chan1's first events with RefOF1x1. It prints end-to-end
   events/s (host clock, process() call to returned columns; a first call
   that pins its buffers, a second, and a third under torch.profiler for
   the device's busy share), the StageTimer's read/dispatch/drain seconds,
   and the group steps' events/s on one batch already on the card. Then
   trigger-table mode: one flat dump of 8 continuous 4-channel events of
   1,250,000 samples with 160 pulses an event, a table of their indices
   plus 16 rows out of bounds, windows of 4096/1024 with their own filter
   data, batch 512: the same launch and upload checks, exactly the 16 rows
   dropped, the first 16 rows against the float64 CPU run, chan1's
   amplitudes and t0. Both kernels are held against their twins at the
   shell's shapes.

The last line is {"ok": true, "device": {...}}; the line before it is the
{"kernels": [...]} summary, each kernel with its bound (bytes over the HBM
peak or float32 operations over the non-tensor peak, the larger), the
one PyTorch call that computes the same function, where there is one, and
its launches on each path (feature: phase d; trigger: phase e's residual
run; shell: phase g's two process() calls with the counts at 0), whose
sum is ``launches``, and the SM clocks of its phases from phase (d).
Needs one CUDA device; imports no JAX.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from detprocess_tpu_torch import device as dev  # noqa: E402
from detprocess_tpu_torch import entry as tentry  # noqa: E402
from detprocess_tpu_torch.entry import build_bank, entry  # noqa: E402
from detprocess_tpu_torch.ops import _kernels, cuda_fft  # noqa: E402
from detprocess_tpu_torch.ops import fft, filterbank, of1x1  # noqa: E402
from detprocess_tpu_torch.ops import trigger  # noqa: E402
from detprocess_tpu_torch.ops import tracestats  # noqa: E402
from detprocess_tpu_torch.ops.cuda_of import FusedNodelayOF  # noqa: E402
from detprocess_tpu_torch.pipelines.feature_step import (  # noqa: E402
    FeatureStep)
from detprocess_tpu_torch.pipelines.trigger_step import (  # noqa: E402
    TriggerStep)
from detprocess_tpu_torch.io.rawdata import (  # noqa: E402
    RawIndex, RawReader, series_to_number, write_flat_dump)
from detprocess_tpu_torch.ops.adc import adc_convert  # noqa: E402
from detprocess_tpu_torch.pipelines.features import (  # noqa: E402
    FeatureProcessing)
from detprocess_tpu_torch.utils.logging import StageTimer  # noqa: E402

FS = 1.25e6
N = 32768
PRETRIG = N // 2
BATCH = 8192
NBATCH = 8
SEED = 0
CHAN = "chan1"

CHECK_B = 64
RFFT_TOL = 1e-5          # max|Δ| / max|ref|
AMP_RTOL = 1e-5
CHI2_RTOL = 5e-3
TIMING_REPS = 10
RUN_BYTES = 4e9          # a timed run of the small trigger shapes moves this
HBM_PEAK = 3.35e12       # bytes/s, H100 SXM data sheet
F32_PEAK = 67e12         # float32 FLOP/s outside the tensor cores, same
# fused kernel slot counts checked at N = 32768: 9 = 4+4+1, 11 = 4+4+2+1
# and 17 = 4·4+1, so each slot-group size the kernel has is launched
SLOT_CHECKS = (9, 11, 17)

# the slice's first events against the float64 CPU run of the same step:
# float32 on the card vs float64; χ² and lowchi2 carry the f32
# cancellation of χ²₀ − q²/norm and of the residual
REF_EVENTS = 16
LOW_FCUT = 10000.0       # FeatureStep's default lowchi2_fcutoff
REF_RTOL = {"amp": 1e-4, "chi2": 5e-3, "lowchi2": 2e-2, "baseline": 1e-4,
            "integral": 1e-4}

# phase (e): the trigger step
TRIG_BATCHES = 8
TRIG_PULSES = 10         # per event, at TRIG_PULSE_SIGMA resolutions
TRIG_PULSE_SIGMA = 10.0
# index limits from the float64 CPU reference's distribution of 48,000
# 10σ pulses (scripts/trigger_offsets.py --device cpu --dtype float64
# --batches 40, seeds 1 and 2): |offset| median 6, 99 % 32, largest 87
# samples, 11 beyond 64; signed offset mean 0.01, rms 10.1. The slow
# template's Δχ² peak is broad and flat when noise pulls a pulse low (a
# 7.5σ draw peaked 103 samples off, in the reference too), so the tail is
# long. A pulse counts as found within 256 samples, inside the span of its
# own above-threshold group; the worst pulse is checked against the
# float64 run, and the median and mean over all pulses catch a shift of
# the alignment far below that limit.
TRIG_INDEX_TOL = 256
TRIG_MEDIAN_TOL = 9.0
TRIG_MEAN_TOL = 2.0      # 5× the rms over √640
TRIG_AMP_TOL = 5.0       # resolutions
# one pulse an event that the saturation veto flags (1.5× its level; the
# low-pass keeps the template's peak)
TRIG_SAT_PULSE = 1.5 * tentry.TRIGGER_SAT_RESOLUTIONS
TRIG_NEAR_THRESHOLD = 1e-3   # relative: such triggers may differ
TRIG_RTOL = 1e-4         # Δχ² and amplitudes against the float64 CPU run
# phase (f): lengths outside the kernels' domain
OFF_KERNEL_N = (25000, 65536)
OFF_KERNEL_B = 64
# phase (g): the FeatureProcessing shell from files
SHELL_EVENTS = 8192
SHELL_FILES = 4
SHELL_BATCH = 2048
SHELL_READERS = 4
SHELL_SPECTRAL = 5       # spectral compound channels: 4 + their sum
SHELL_TRIG_N, SHELL_TRIG_PRE = 4096, 1024
SHELL_TRIG_PULSES = 160  # a continuous event: > 0.5·L/N windows, read whole
SHELL_TRIG_BATCH = 512
# χ²₀ has no cancellation; the resolutions are functions of the bank
SHELL_RTOL = {**REF_RTOL, "chi2nopulse": 5e-3, "maximum": 1e-4,
              "minimum": 1e-4, "ampres": 1e-5, "timeres": 1e-5}

KERNEL_INFO = {
    "rfft": {"source": "detprocess_tpu_torch/csrc/rfft.cu",
             "replaces": "detprocess_tpu/ops/pallas_fft.py:95"},
    "fused_nodelay_of": {
        "source": "detprocess_tpu_torch/csrc/fused_nodelay_of.cu",
        "replaces": "detprocess_tpu/ops/pallas_of.py:181"},
}


def log(msg=""):
    print(msg, flush=True)


def rel_err(got, ref):
    """Elementwise |got − ref| / |ref|, maximum (float64)."""
    got = got.double()
    ref = ref.double()
    return float(((got - ref).abs() / ref.abs()).max())


def make_traces(n, batch, device, gen):
    """White noise (1e-8) plus pulses of 1–3 µA at the template position
    and the bank of the 1/f PSD, as in the JAX package's kernel tests."""
    bank, template, _ = build_bank(n, n // 2, FS)
    tmpl = torch.as_tensor(template, dtype=torch.float32, device=device)
    noise = torch.randn((batch, n), generator=gen, device=device) * 1e-8
    amps = torch.empty(batch, device=device).uniform_(1e-6, 3e-6,
                                                      generator=gen)
    return bank, noise + amps[:, None] * tmpl[None, :]


def phase_a():
    device = dev.require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[device.index]
    log(card)
    log(f"[a] device {device}: {torch.cuda.get_device_name(device)}; count "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    return device, card


# each kernel's CUDA function template, as its instances are named in the
# -Xptxas -v report
KERNEL_FUNCTIONS = {"rfft": "rfft_kernel",
                    "fused_nodelay_of": "fused_nodelay_kernel"}


def phase_b():
    t = time.perf_counter()
    path = _kernels.build()
    _kernels.lib()
    log(f"[b] built {os.path.basename(path)} in "
        f"{time.perf_counter() - t:.1f} s")
    for line in _kernels.build_log().splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill",
                                   "error", "warning")):
            log(f"    {line.strip()}")
    regs = {}
    for name, function in KERNEL_FUNCTIONS.items():
        regs[name] = kernel_registers(_kernels.build_log(), function)
        for (log2m, stamp), (nreg, st, ld) in sorted(regs[name].items()):
            log(f"[b] {name} N={2 << log2m}{' (stamped)' if stamp else ''}: "
                f"{nreg} registers, {st} bytes spill stores, {ld} bytes "
                "spill loads")
        main_path = {k: v for k, v in regs[name].items() if not k[1]}
        if len(main_path) != len(cuda_fft.SUPPORTED_N):
            raise RuntimeError(f"{name}: the ptxas report lists "
                               f"{len(main_path)} main-path instances")
        spills = {2 << k[0]: v[1:] for k, v in main_path.items() if any(v[1:])}
        if spills:
            raise RuntimeError(f"{name} spills in its main-path instances "
                               f"(N: store and load bytes): {spills}")
    return regs


def kernel_registers(build_log, function):
    """{(log2 M, stamped): (registers, spill store bytes, spill load
    bytes)} of the instances of the kernel template ``function``, from the
    -Xptxas -v report."""
    pattern = function + r"ILi(\d+)ELb([01])E"

    def instance(line):
        m = re.search(pattern, line)
        return (int(m.group(1)), m.group(2) == "1") if m else None

    out = {}
    entry = props = None
    for line in build_log.splitlines():
        if "Compiling entry" in line:
            entry = instance(line)
        elif "Function properties for" in line:
            props = instance(line)
        elif props is not None and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[props] = [None, int(st), int(ld)]
        elif entry is not None and "Used" in line and entry in out:
            out[entry][0] = int(re.search(r"Used (\d+) registers",
                                          line).group(1))
    return {k: tuple(v) for k, v in out.items()}


def compare_kernels(x, fused, errs, phase):
    """Each kernel's wrapper against its plain twin on the traces ``x``
    [B, N] on the card; raise past the tolerances, keep the worst errors
    in ``errs`` ({name: [max abs, max rel]})."""
    n, batch = x.shape[-1], x.shape[0]
    got = cuda_fft.rfft_kernel(x)
    ref = cuda_fft.rfft_plain(x)
    torch.cuda.synchronize(x.device)
    dmax = float((got - ref).abs().max())
    rel = dmax / float(ref.abs().max())
    errs["rfft"][0] = max(errs["rfft"][0], dmax)
    errs["rfft"][1] = max(errs["rfft"][1], rel)
    log(f"[{phase}] rfft N={n} B={batch}: max|Δ| {dmax:.3e}, "
        f"max|Δ|/max|ref| {rel:.3e} (tol {RFFT_TOL:g})")
    if not rel <= RFFT_TOL:
        raise RuntimeError(f"rfft kernel disagrees at N={n}, B={batch}: "
                           f"{rel:.3e}")
    del got, ref
    compare_fused(x, fused, errs, phase)


def compare_fused(x, fused, errs, phase):
    """The fused kernel against its plain twin on ``x``, every slot."""
    n, batch = x.shape[-1], x.shape[0]
    amp_k, chi2_k = fused.kernel(x)
    amp_p, chi2_p = fused.plain(x)
    torch.cuda.synchronize(x.device)
    amp_rel = rel_err(amp_k, amp_p)
    chi2_rel = rel_err(chi2_k, chi2_p)
    amp_abs = float((amp_k.double() - amp_p.double()).abs().max())
    errs["fused_nodelay_of"][0] = max(errs["fused_nodelay_of"][0], amp_abs)
    errs["fused_nodelay_of"][1] = max(errs["fused_nodelay_of"][1], amp_rel)
    log(f"[{phase}] fused_nodelay_of N={n} B={batch} S={fused.nslots}: amp "
        f"max|Δ| {amp_abs:.3e}, rel {amp_rel:.3e} (tol {AMP_RTOL:g}); χ² "
        f"rel {chi2_rel:.3e} (tol {CHI2_RTOL:g})")
    if not (amp_rel <= AMP_RTOL and chi2_rel <= CHI2_RTOL):
        raise RuntimeError(f"fused no-delay kernel disagrees at N={n}, "
                           f"B={batch}, S={fused.nslots}")


def log_chi2_floor(x, fused, fused64):
    """The χ² of the kernel and of its float32 plain twin, each against
    the float64 plain twin on the same traces: the float32 cancellation
    floor of χ²₀ − q²/norm that CHI2_RTOL allows for."""
    _, chi2_k = fused.kernel(x)
    _, chi2_p = fused.plain(x)
    _, chi2_d = fused64.plain(x.double())
    torch.cuda.synchronize(x.device)
    log(f"[c] fused_nodelay_of N={x.shape[-1]}: χ² rel against float64: "
        f"kernel {rel_err(chi2_k, chi2_d):.3e}, plain "
        f"{rel_err(chi2_p, chi2_d):.3e}")


def phase_c(device, ns=cuda_fft.SUPPORTED_N, batch=CHECK_B):
    gen = torch.Generator(device=device).manual_seed(SEED)
    errs = {"rfft": [0.0, 0.0], "fused_nodelay_of": [0.0, 0.0]}
    for n in ns:
        bank, x = make_traces(n, batch, device, gen)
        fused = FusedNodelayOF.from_bank(
            filterbank.bank_to_torch(bank, device, torch.float32))
        compare_kernels(x, fused, errs, "c")
        log_chi2_floor(x, fused, FusedNodelayOF.from_bank(
            filterbank.bank_to_torch(bank, device, torch.float64)))
    # more slots than one group: the same bank row in every slot
    # but with slot-dependent scales, so that a slot mixed up shows
    tb = filterbank.bank_to_torch(bank, device, torch.float32)
    for nslots in SLOT_CHECKS:
        scale = torch.arange(1, nslots + 1, device=device,
                             dtype=torch.float32)
        many = FusedNodelayOF(tb["phi_h"][[0] * nslots] * scale[:, None],
                              tb["denom_inv_h"][[0] * nslots]
                              * scale[:, None], tb["bin_w"],
                              tb["norm"][[0] * nslots] * scale ** 2)
        compare_fused(x, many, errs, "c")
    return errs


def synth_batch(gen, half_scale, tmpl, batch, n):
    """PSD-matched noise (E|ñ_k|² = N·fs·J_k) plus pulses of 1–5 µA at the
    template position (t0 = 0), made on the card."""
    nh = n // 2 + 1
    z = torch.randn((batch, 2, nh), generator=gen, device=tmpl.device)
    nf = torch.complex(z[:, 0], z[:, 1]) * half_scale
    nf[:, 0] = 0.0
    nf[:, -1] = z[:, 0, -1] * half_scale[-1] * np.sqrt(2.0)
    noise = torch.fft.irfft(nf, n=n)
    amps = torch.empty(batch, device=tmpl.device).uniform_(1e-6, 5e-6,
                                                           generator=gen)
    return noise + amps[:, None] * tmpl[None, :], amps


def layer_times(step, raw):
    """Device time of each layer of one FeatureStep batch (CUDA events)."""
    ms = {}
    with dev.CudaTimer() as t:
        traces = torch.einsum("cr,brn->bcn", step.mix, raw)
    ms["mix"] = t.ms
    tr = traces[:, 0, :].contiguous()
    with dev.CudaTimer() as t:
        vr = fft.rfft(tr)[:, None, :]
    ms["rfft kernel"] = t.ms
    with dev.CudaTimer() as t:
        amp, _ = step.nodelay[0](tr)
    ms["fused no-delay kernel"] = t.ms
    with dev.CudaTimer() as t:
        of1x1._residual_chi2_half(vr, amp, torch.zeros_like(amp),
                                  step.s_fft_h, step.denom_inv_h,
                                  step.bin_w, step.low_mask_h, step.n)
    ms["no-delay lowchi2"] = t.ms
    with dev.CudaTimer() as t:
        of1x1.of1x1_withdelay_half(vr, step.phi_h, step.norm,
                                   step.denom_inv_h, step.s_fft_h,
                                   step.bin_w, step.pretrigger, step.fs,
                                   low_mask_h=step.low_mask_h, n=step.n)
    ms["delay scan"] = t.ms
    with dev.CudaTimer() as t:
        tracestats.baseline(tr)
        tracestats.integral(tr, step.fs)
    ms["trace stats"] = t.ms
    return ms


def cpu_step_reference(raw, bank, n=N):
    """The first events through the same step in float64 on the CPU."""
    ref_step = FeatureStep(
        filterbank.bank_to_torch(bank, "cpu", torch.float64), [CHAN], FS,
        n // 2, n)
    return ref_step(raw[:REF_EVENTS].double().cpu())


def loop_reference(raw, template, psd):
    """The first events through tests/reference_impl.RefOF1x1: a per-event
    float64 numpy optimal filter that shares no code with the port."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from reference_impl import RefOF1x1
    ref = RefOF1x1(template, psd, FS, PRETRIG)
    cols = {}
    for x in raw[:REF_EVENTS, 0].double().cpu().numpy():
        fits = {"nodelay": ref.fit_nodelay(x, lowchi2_fcutoff=LOW_FCUT),
                "unconstrained": ref.fit_withdelay(x,
                                                   lowchi2_fcutoff=LOW_FCUT)}
        names = {"nodelay": ("amp", "chi2", "lowchi2"),
                 "unconstrained": ("amp", "t0", "chi2", "lowchi2")}
        for algo, vals in fits.items():
            for name, v in zip(names[algo], vals):
                cols.setdefault(f"{name}_of1x1_{algo}_{CHAN}", []).append(v)
    return {k: torch.tensor(v, dtype=torch.float64) for k, v in cols.items()}


def check_reference(out, raw, ref, what, phase="d"):
    """The slice's first events against the float64 reference columns
    ``ref``, within float32 tolerances (t0 within one sample)."""
    scale = float(raw[:REF_EVENTS].abs().mean())
    worst = {}
    for key, r in ref.items():
        g = out[key][:REF_EVENTS].double().cpu()
        if key.startswith("t0_"):
            err = float((g - r).abs().max()) * FS
            ok = err <= 1.0 + 1e-6
            worst[key] = f"{err:.3g} samples"
        else:
            kind = key.split("_")[0]
            atol = 1e-6 * scale / FS if kind == "integral" else (
                1e-6 * scale if kind == "baseline" else 0.0)
            err = float(((g - r).abs() / (r.abs() + atol / REF_RTOL[kind]))
                        .max())
            ok = err <= REF_RTOL[kind]
            worst[key] = f"{err:.3e} (tol {REF_RTOL[kind]:g})"
        if not ok:
            raise RuntimeError(f"{key} disagrees with {what}: "
                               f"{worst[key]}")
    log(f"[{phase}] first {REF_EVENTS} events vs {what}: "
        + "; ".join(f"{k} {v}" for k, v in worst.items()))


def time_pair(fn_kernel, fn_plain, reps=TIMING_REPS):
    """Mean device ms per call of kernel and plain twin, timed in turns
    plain, kernel, kernel, plain."""
    fn_kernel()
    fn_plain()
    times = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = fn_kernel if which == "kernel" else fn_plain
        with dev.CudaTimer() as t:
            for _ in range(reps):
                fn()
        times[which].append(t.ms / reps)
    return (float(np.mean(times["kernel"])), float(np.mean(times["plain"])))


def log_rfft_time(n, k_ms, p_ms, card):
    """The rFFT kernel's and cuFFT's time at B = BATCH, with their share
    of the HBM peak (4·N bytes in, 8·(N/2 + 1) out per trace)."""
    share = {name: BATCH * (4 * n + 8 * (n // 2 + 1)) / (ms * 1e-3)
             / HBM_PEAK for name, ms in (("kernel", k_ms), ("cuFFT", p_ms))}
    log(f"[d] rfft at B={BATCH}, N={n}: kernel {k_ms:.4f} ms "
        f"({100 * share['kernel']:.1f}% of HBM peak), cuFFT {p_ms:.4f} ms "
        f"({100 * share['cuFFT']:.1f}%) (on {card})")


def bound(name, n, batch, nslots=1):
    """(ms, "bytes" or "operations"): the least time of one call on
    ``batch`` traces of length ``n``, the larger of its bytes (each input
    read once, each output written once) over the HBM peak and its float32
    operations over the non-tensor peak. Operations: 5·M·log2 M for the
    packed M = N/2-point complex FFT, 10 a bin for the untangle; the fused
    kernel adds |X|² (3) and 6 a bin and slot for its two sums."""
    m = n // 2
    ops = batch * (5 * m * np.log2(m) + 10 * m)
    if name == "rfft":
        nbytes = batch * (4 * n + 8 * (m + 1))
    else:
        nbytes = batch * (4 * n + 16 * nslots) + 12 * nslots * (m + 1)
        ops += batch * (m + 1) * (3 + 6 * nslots)
    t_bytes, t_ops = nbytes / HBM_PEAK, ops / F32_PEAK
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def log_fused_time(n, k_ms, p_ms, card):
    """The fused kernel's and its plain twin's time at B = BATCH, with the
    kernel's share of the HBM peak (4·N bytes read per trace)."""
    share = BATCH * 4 * n / (k_ms * 1e-3) / HBM_PEAK
    b_ms, _ = bound("fused_nodelay_of", n, BATCH)
    log(f"[d] fused_nodelay_of at B={BATCH}, N={n}: kernel {k_ms:.4f} ms "
        f"({100 * share:.1f}% of HBM peak; bound {b_ms:.4f} ms), plain "
        f"{p_ms:.4f} ms (on {card})")


FUSED_PHASES = ("load", "FFT passes", "untangle and sums", "reduction")


def log_phase_clocks(name, phases, stamps, n, card):
    """Mean SM clocks per trace of a kernel's phases ``phases``, from the
    stamps [B, len(phases)] of one launch of its stamped instance."""
    mean = stamps.double().mean(dim=0).tolist()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    total = sum(mean)
    log(f"[d] {name} phase clocks, N={n}, B={stamps.shape[0]}, mean SM "
        "clocks per trace: "
        + "; ".join(f"{k} {v:.0f} ({100 * v / total:.1f}%)"
                    for k, v in zip(phases, mean))
        + f"; total {total:.0f} (SM clock after the run: {smi}; on {card})")
    return dict(zip(phases, mean))


def phase_d(device, card, errs, regs, parent_fft=None):
    # the package's entry point on the card (N = 16384, 16 events)
    small, (x,) = entry(device)
    cols = small(x)
    for key, v in cols.items():
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"entry(): column {key} is not finite")
    log(f"[d] entry(): {len(cols)} finite feature columns for "
        f"{x.shape[0]} events of N={x.shape[-1]}")

    bank, template, psd = build_bank(N, PRETRIG, FS)
    step = FeatureStep(filterbank.bank_to_torch(bank, device, torch.float32),
                       [CHAN], FS, PRETRIG, N)
    gen = torch.Generator(device=device).manual_seed(SEED)
    tmpl = torch.as_tensor(template, dtype=torch.float32, device=device)
    psd_half = torch.as_tensor(bank.psd[0][:N // 2 + 1], dtype=torch.float32,
                               device=device)
    half_scale = torch.sqrt(psd_half * FS * N / 2.0)
    batches = [synth_batch(gen, half_scale, tmpl, BATCH, N)
               for _ in range(NBATCH)]
    raws = [tr[:, None, :] for tr, _ in batches]

    step(raws[0])                                   # warm-up
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)

    _kernels.reset_launch_counts()
    with dev.CudaTimer() as t:
        outs = [step(raw) for raw in raws]
    step_ms = t.ms
    launches = _kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
    eps = BATCH * NBATCH / (step_ms / 1e3)
    log(f"[d] slice: {eps:.1f} events/s on {card} (N={N}, B={BATCH} x "
        f"{NBATCH}, {step_ms:.3f} ms device time, CUDA events); peak "
        f"memory {peak_gib:.2f} GiB")
    log(f"[d] launches on the main path: {launches}")
    for name in _kernels.KERNELS:
        if launches[name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the "
                               "main path")

    for key, v in outs[0].items():
        if v.shape != (BATCH,) or not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"column {key}: shape {tuple(v.shape)} or "
                               "non-finite values")
    check_reference(outs[0], raws[0], cpu_step_reference(raws[0], bank),
                    "the float64 CPU run of the same step")
    check_reference(outs[0], raws[0], loop_reference(raws[0], template, psd),
                    "the float64 per-event reference (RefOF1x1)")

    sigma_amp = float(bank.resolution[0])
    amp_key = f"amp_of1x1_unconstrained_{CHAN}"
    amps_rec = [o[amp_key].double().cpu().numpy() for o in outs]
    truths = [a.double().cpu().numpy() for _, a in batches]
    err = np.abs(amps_rec[0] - truths[0])
    if not np.all(err < max(1e-7, 8 * sigma_amp)):
        raise RuntimeError(f"amplitude recovery failed: max error "
                           f"{err.max():.3e} (sigma_amp {sigma_amp:.3e})")
    rel = np.concatenate([(r - t) / t for r, t in zip(amps_rec, truths)])
    scatter = float(np.std(np.concatenate(
        [r - t for r, t in zip(amps_rec, truths)])) / sigma_amp)
    chi2 = np.concatenate([o[f"chi2_of1x1_unconstrained_{CHAN}"]
                           .double().cpu().numpy() for o in outs])
    chi2_dof = float(np.mean(chi2) / (N - 2))
    t0s = np.concatenate([o[f"t0_of1x1_unconstrained_{CHAN}"]
                          .double().cpu().numpy() for o in outs])
    # t0 = whole samples / fs in float32: round back to samples before
    # comparing, so that one sample does not read as 1.0000001
    t0_within_1 = float(np.mean(np.rint(np.abs(t0s) * FS) <= 1.0))
    physics = {"amp_bias": float(np.mean(rel)), "amp_scatter_sigma": scatter,
               "chi2_dof": chi2_dof, "t0_within_1": t0_within_1}
    physics["pass"] = bool(abs(physics["amp_bias"]) < 5e-3
                           and abs(chi2_dof - 1.0) < 0.05
                           and t0_within_1 > 0.99)
    log(f"[d] physics: {json.dumps(physics)}")
    if not physics["pass"]:
        raise RuntimeError("physics invariants failed")

    layers = layer_times(step, raws[0])
    total = sum(layers.values())
    log(f"[d] layers of one batch (B={BATCH}, CUDA events, on {card}): "
        + "; ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
                    for k, v in layers.items()))

    # the kernels against their twins on the main path's own input
    tr = raws[0][:, 0, :].contiguous()
    fused = step.nodelay[0]
    compare_kernels(tr, fused, errs, "d")
    timings = {
        "rfft": time_pair(lambda: cuda_fft.rfft_kernel(tr),
                          lambda: cuda_fft.rfft_plain(tr)),
        "fused_nodelay_of": time_pair(lambda: fused.kernel(tr),
                                      lambda: fused.plain(tr)),
    }
    for name, (k_ms, p_ms) in timings.items():
        log(f"[d] {name} at B={BATCH}, N={N}: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms (on {card})")
    log_rfft_time(N, *timings["rfft"], card)
    log_fused_time(N, *timings["fused_nodelay_of"], card)
    x = torch.randn((BATCH, N // 2), generator=gen, device=device)
    log_rfft_time(N // 2, *time_pair(lambda: cuda_fft.rfft_kernel(x),
                                     lambda: cuda_fft.rfft_plain(x)), card)
    half = FusedNodelayOF.from_bank(filterbank.bank_to_torch(
        build_bank(N // 2, N // 4, FS)[0], device, torch.float32))
    log_fused_time(N // 2, *time_pair(lambda: half.kernel(x),
                                      lambda: half.plain(x)), card)
    for name in _kernels.KERNELS:
        for log2m in (13, 14):
            nreg, st, ld = regs[name][(log2m, False)]
            log(f"[d] {name} N={2 << log2m}: {nreg} registers, {st} bytes "
                f"spill stores, {ld} bytes spill loads (ptxas)")
    clocks = {"rfft": {}, "fused_nodelay_of": {}}
    for n, xx, fz in ((N // 2, x, half), (N, tr, fused)):
        clocks["rfft"][n] = log_phase_clocks(
            "rfft", cuda_fft.PHASES, cuda_fft.rfft_phase_clocks(xx), n, card)
        clocks["fused_nodelay_of"][n] = log_phase_clocks(
            "fused_nodelay_of", FUSED_PHASES, fz.phase_clocks(xx), n, card)
    if parent_fft is not None:
        # the earlier form beside this one, in turns, on the slice's batch
        earlier, now = time_pair(lambda: parent_fft.rfft_kernel(tr),
                                 lambda: cuda_fft.rfft_kernel(tr))
        log(f"[d] rfft at B={BATCH}, N={N}: earlier form "
            f"({parent_fft.__file__}) {earlier:.4f} ms, this form {now:.4f} "
            f"ms, in turns (on {card})")
        timings["rfft_earlier"] = earlier
    return launches, timings, clocks


class TriggerBatch(NamedTuple):
    x: torch.Tensor            # [E, 1, L]
    idx: torch.Tensor          # [E, TRIG_PULSES] injected pulse indices
    amp: float                 # their amplitude
    sat_idx: torch.Tensor      # [E, 1] the saturating pulse's index
    sat_amp: float             # its amplitude


def trigger_batch(gen, kernel, tmpl, device):
    """One trigger batch made on the card: white noise of the
    configuration's PSD, TRIG_PULSES pulses per event of TRIG_PULSE_SIGMA
    resolutions, one in each L/TRIG_PULSES slot at a random index at least
    F + 2·Nt from the slot's edges, and one pulse of TRIG_SAT_PULSE
    resolutions, which saturates the low-passed trace, on a random inner
    slot boundary. So every pulse is clear of the trace edges and of the
    others' responses, and no 10σ pulse shares an FIR segment (F samples)
    with the saturating one, whose float32 rounding would swamp it."""
    e, l, nt = tentry.TRIGGER_EVENTS, tentry.TRIGGER_L, kernel.nt
    x = torch.randn((e, l), generator=gen, device=device) * np.sqrt(
        tentry.TRIGGER_PSD * FS)
    slot = l // TRIG_PULSES
    edge = kernel.fft_size + 2 * nt
    offs = torch.randint(edge, slot - edge, (e, TRIG_PULSES), generator=gen,
                         device=device)
    idx = torch.arange(TRIG_PULSES, device=device) * slot + offs
    sat_idx = torch.randint(1, TRIG_PULSES, (e, 1), generator=gen,
                            device=device) * slot
    res = float(kernel.resolution[0])
    amp, sat_amp = TRIG_PULSE_SIGMA * res, TRIG_SAT_PULSE * res
    every = torch.cat([idx, sat_idx], dim=-1)
    scale = torch.full(every.shape, amp, device=device)
    scale[:, -1] = sat_amp
    cols = ((every - kernel.pretrigger)[..., None]
            + torch.arange(nt, device=device)).reshape(e, -1)
    x.scatter_add_(-1, cols, (scale[..., None] * tmpl).reshape(e, -1))
    return TriggerBatch(x[:, None, :], idx, amp, sat_idx, sat_amp)


def pulse_errors(ts, idx, amp, sigma):
    """(|index offset| [E, P], signed offset, amplitude error in
    resolutions) of the trigger nearest each pulse at ``idx`` [E, P] of
    amplitude ``amp``; the offset is int64's max where an event has no
    trigger."""
    got_i = ts.indices[:, None, :]                       # [E, 1, K]
    near = (got_i - idx[..., None]).abs()                # [E, P, K]
    near = torch.where(got_i >= 0, near, torch.iinfo(near.dtype).max)
    dist, slot = near.min(dim=-1)
    signed = ts.indices.gather(-1, slot) - idx
    got_a = ts.amplitudes[:, 0, :].gather(-1, slot)
    return dist, signed, ((got_a - amp).abs() / sigma).double()


def check_pulses(dist, a_err, what):
    worst_i, worst_a = int(dist.max()), float(a_err.max())
    if worst_i > TRIG_INDEX_TOL or worst_a > TRIG_AMP_TOL:
        raise RuntimeError(f"{what}: injected pulse not recovered (worst "
                           f"index offset {worst_i}, amplitude error "
                           f"{worst_a:.3f} σ)")


def check_offsets(dist, signed, what):
    """The 10σ pulses' offsets as a whole: the median |offset| and the
    mean signed offset within their limits (a shift of the time alignment
    moves them long before the worst pulse passes TRIG_INDEX_TOL)."""
    med = float(dist.double().median())
    mean = float(signed.double().mean())
    q = torch.quantile(dist.double(), torch.tensor(
        [0.9, 0.99], dtype=torch.float64, device=dist.device))
    log(f"[e] {what}: |index offset| of {dist.numel()} {TRIG_PULSE_SIGMA:g}σ"
        f" pulses: median {med:g}, 90% {float(q[0]):g}, 99% {float(q[1]):g},"
        f" max {int(dist.max())} samples; mean signed offset {mean:.4f}")
    if med > TRIG_MEDIAN_TOL or abs(mean) > TRIG_MEAN_TOL:
        raise RuntimeError(f"{what}: offsets shifted (median {med:g} > "
                           f"{TRIG_MEDIAN_TOL} or |mean| {abs(mean):.4f} > "
                           f"{TRIG_MEAN_TOL})")


def compare_trigger_sets(got, ref, threshold, what):
    """One event's trigger set from the card against the float64 CPU run:
    the same indices except for triggers whose Δχ² is within
    TRIG_NEAR_THRESHOLD of the threshold; Δχ² and amplitudes of the common
    triggers within TRIG_RTOL. Returns (common, max rel Δχ², max rel
    amplitude, indices in only one of the two)."""
    gi = got.indices[:int(got.count)]
    ri = ref.indices[:int(ref.count)]
    for mine, other, d, side in ((gi, ri, got.dchi2, "card"),
                                 (ri, gi, ref.dchi2, "CPU")):
        for k in np.flatnonzero(~np.isin(mine, other)):
            if abs(float(d[k]) - threshold) > TRIG_NEAR_THRESHOLD * threshold:
                raise RuntimeError(
                    f"{what}: trigger at {int(mine[k])} (Δχ² {float(d[k]):.6g})"
                    f" only in the {side} run")
    common, gk, rk = np.intersect1d(gi, ri, return_indices=True)
    d_rel = a_rel = 0.0
    if len(common):
        gd, rd = got.dchi2[gk].astype(np.float64), ref.dchi2[rk]
        ga = got.amplitudes[:, gk].astype(np.float64)
        ra = ref.amplitudes[:, rk]
        d_rel = float(np.max(np.abs(gd - rd) / np.abs(rd)))
        a_rel = float(np.max(np.abs(ga - ra) / np.abs(ra)))
    if not (d_rel <= TRIG_RTOL and a_rel <= TRIG_RTOL):
        raise RuntimeError(f"{what}: Δχ² rel {d_rel:.3e} or amplitude rel "
                           f"{a_rel:.3e} above {TRIG_RTOL:g}")
    return len(common), d_rel, a_rel, np.setxor1d(gi, ri)


def compare_series(got, ref, first, fft_size, threshold, skip, what):
    """A Δχ² series of one event [L] from the card against the float64 CPU
    run: |got − ref| ≤ TRIG_RTOL·(√(|Δχ²|·D) + threshold) at every sample
    outside ``skip``, Δχ² the first-pass series ``first`` of the CPU run
    and D its largest |value| within one FIR segment (± ``fft_size``).
    That is how float32 rounding grows: Δχ² = q², and the error of q from
    the segment's transforms follows the largest |q| the segment holds.
    Returns the largest ratio of the error to that bound."""
    mag = first.abs()
    bound = torch.sqrt(mag * trigger._dilate(mag, fft_size)) + threshold
    err = (got.double() - ref).abs() / bound
    worst = float(err[~skip].max())
    if not worst <= TRIG_RTOL:
        k = int(torch.where(skip, 0.0, err).argmax())
        raise RuntimeError(f"{what}: sample {k} off by {worst:.3e} of its "
                           f"bound (tol {TRIG_RTOL:g}): card "
                           f"{float(got[k]):.6g}, CPU {float(ref[k]):.6g}")
    return worst
def keep_layers(store):
    """A ``run_layer`` hook for TriggerStep that keeps each layer's result
    under its name."""
    def run(name, fn, *args):
        store[name] = fn(*args)
        return store[name]
    return run


def trigger_layer_times(step, x):
    """Each layer of one TriggerStep batch, through the step's own
    ``run_layer`` hook: {layer: (CUDA-event ms, device ms)}. The CUDA
    events bracket each layer with the card synchronised between layers,
    so they include the host's enqueue time; the device ms are the layer's
    kernels, copies and fills in a second, profiled run (torch.profiler,
    summed under the layer's record_function range)."""
    def timed(times):
        def run(name, fn, *args):
            with torch.profiler.record_function(name), dev.CudaTimer() as t:
                out = fn(*args)
            times[name] = t.ms
            return out
        return run

    event_ms = {}
    step(x, run_layer=timed(event_ms))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(x, run_layer=timed({}))
        torch.cuda.synchronize(x.device)
    device_ms = dict.fromkeys(event_ms, 0.0)
    for e in prof.events():
        if (e.name in device_ms
                and e.device_type == torch.autograd.DeviceType.CPU):
            device_ms[e.name] += e.device_time_total / 1e3
    return {k: (event_ms[k], device_ms[k]) for k in event_ms}


def device_busy(step, x, device):
    """One batch of ``step`` under torch.profiler: (device busy ms, the
    sum of the device time of every kernel, copy and fill; the kernels
    with the most device time, [(name, ms)])."""
    step(x)
    torch.cuda.synchronize(device)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(x)
        torch.cuda.synchronize(device)
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in dev_events) / 1e3
    by_name = {}
    for e in dev_events:
        by_name[e.name[:70]] = (by_name.get(e.name[:70], 0.0)
                                + e.device_time_total / 1e3)
    return busy, sorted(by_name.items(), key=lambda kv: -kv[1])[:8]


def run_trigger(step, batches, device):
    """The main path: ``step`` over every batch with the counts set to 0
    just before; returns (outputs, device ms, host ms, launches, library
    calls)."""
    step(batches[0].x)                                # warm-up
    torch.cuda.synchronize(device)
    _kernels.reset_launch_counts()
    t_host = time.perf_counter()
    with dev.CudaTimer() as t:
        outs = [step(b.x) for b in batches]
    ms = t.ms
    host_ms = 1e3 * (time.perf_counter() - t_host)
    return (outs, ms, host_ms, _kernels.launch_counts(),
            _kernels.library_counts())


def check_recovery(mode, outs, batches, sigma):
    """Every injected pulse of every batch found (the saturating one in
    both passes: the veto keeps it from the subtraction); returns the 10σ
    pulses' (|offset|, signed offset) [batches, E, P]."""
    dists, signs, a_errs, sat_errs = [], [], [], []
    for (ts, ts2), b in zip(outs, batches):
        d, s, a = pulse_errors(ts, b.idx, b.amp, sigma)
        check_pulses(d, a, f"trigger {mode}")
        dists.append(d)
        signs.append(s)
        a_errs.append(a)
        for p, t in ((1, ts), (2, ts2)):
            if t is not None:
                d, _, a = pulse_errors(t, b.sat_idx, b.sat_amp, sigma)
                check_pulses(d, a, f"trigger {mode} pass {p}, the "
                             "saturating pulse")
                sat_errs.append((int(d.max()), float(a.max())))
    log(f"[e] {mode}: all {len(batches) * b.idx.numel()} injected "
        f"{TRIG_PULSE_SIGMA:g}σ pulses triggered within ±{TRIG_INDEX_TOL} "
        f"samples (worst amplitude error "
        f"{max(float(a.max()) for a in a_errs):.3f} σ); "
        f"the {TRIG_SAT_PULSE:g}σ saturating pulse of each event found in "
        f"{'both passes' if mode == 'residual' else 'the first pass'} (worst "
        f"offset {max(e[0] for e in sat_errs)}, amplitude error "
        f"{max(e[1] for e in sat_errs):.3f} σ); first-pass triggers per "
        f"batch {[int(ts.count.sum()) for ts, _ in outs]}")
    return torch.stack(dists), torch.stack(signs)


def check_worst_pulse(dists, step, batches, args, sat, sigma):
    """The 10σ pulse with the largest offset, its event run again on the
    CPU in float64: the same triggers, and the same offset."""
    bi, ei, pi = np.unravel_index(int(dists.argmax()), tuple(dists.shape))
    b = batches[bi]
    k64, _, _ = tentry.build_trigger(real_dtype=np.float64)
    ref_step = TriggerStep(k64, None, *args, sat_amps=sat, device="cpu",
                           dtype=torch.float64)
    ref, _ = ref_step(b.x[ei:ei + 1].double().cpu())
    got, _ = step(b.x)
    what = f"the worst pulse (batch {bi}, event {ei}, pulse {pi})"
    n, _, _, _ = compare_trigger_sets(trigger.event_set(got, ei),
                                      trigger.event_set(ref, 0),
                                      step.threshold, what)
    idx = b.idx[ei:ei + 1].cpu()
    _, s_ref, _ = pulse_errors(ref, idx, b.amp, sigma)
    _, s_got, _ = pulse_errors(got, b.idx, b.amp, sigma)
    card_off, ref_off = int(s_got[ei, pi]), int(s_ref[0, pi])
    log(f"[e] {what}, injected at {int(idx[0, pi])}: card offset {card_off},"
        f" float64 CPU offset {ref_off} samples; event {ei}: {n} common "
        "triggers with the CPU run")
    if card_off != ref_off:
        raise RuntimeError(f"{what}: card offset {card_off}, float64 CPU "
                           f"offset {ref_off}")


def check_event0(steps, results, batches, args, sat):
    """Event 0 of the first batch against the float64 CPU run of the
    residual step: trigger sets of both passes (both modes), the
    saturation mask, and the first-pass and residual Δχ² series."""
    k64, b64, _ = tentry.build_trigger(real_dtype=np.float64)
    ref_step = TriggerStep(k64, b64, *args, run_residual=True, sat_amps=sat,
                           device="cpu", dtype=torch.float64)
    ref_layers, card_layers = {}, {}
    refs = ref_step(batches[0].x[:1].double().cpu(),
                    run_layer=keep_layers(ref_layers))
    steps["residual"](batches[0].x, run_layer=keep_layers(card_layers))
    thr = steps["residual"].threshold
    only_one = []
    for mode, step in steps.items():
        for p, (got, ref) in enumerate(zip(results[mode][0][0], refs)):
            if got is None:
                continue
            n, d_rel, a_rel, diff = compare_trigger_sets(
                trigger.event_set(got, 0), trigger.event_set(ref, 0), thr,
                f"trigger {mode} pass {p + 1}")
            only_one.extend(diff.tolist())
            log(f"[e] {mode} pass {p + 1}, event 0 vs the float64 CPU run: "
                f"{n} common triggers, Δχ² rel {d_rel:.3e}, amplitude rel "
                f"{a_rel:.3e} (tol {TRIG_RTOL:g})")

    l = tentry.TRIGGER_L
    mask_got = card_layers["LPF + saturation"][0].cpu()
    mask_ref = ref_layers["LPF + saturation"][0]
    flips = int((mask_got != mask_ref).sum())
    sat0 = int(batches[0].sat_idx[0, 0])
    log(f"[e] saturation mask, event 0: {int(mask_ref.sum())} samples "
        f"flagged by the float64 CPU run, {flips} differ on the card; the "
        f"saturating pulse at {sat0} flagged: {bool(mask_got[sat0])}")
    if flips or not bool(mask_got[sat0]):
        raise RuntimeError("saturation mask of event 0 differs from the "
                           "float64 CPU run or misses the saturating pulse")

    skip = torch.zeros(l, dtype=torch.bool)
    seg = 2 * tentry.TRIGGER_NT
    for i in only_one:
        skip[max(i - seg, 0): i + seg] = True
    first = ref_layers["Δχ²"][0].flatten()[:l]
    for name, what in (("Δχ²", "first-pass Δχ²"),
                       ("residual convolution", "residual Δχ²")):
        got = card_layers[name][0].flatten()[:l].cpu()
        ref = ref_layers[name][0].flatten()[:l]
        worst = compare_series(got, ref, first, k64.fft_size, thr, skip,
                               what)
        log(f"[e] {what} series, event 0 vs the float64 CPU run: largest "
            f"error {worst:.3e} of √(|Δχ²|·segment max) + threshold (tol "
            f"{TRIG_RTOL:g}; {int(skip.sum())} samples near triggers of one "
            "run only skipped)")


def phase_e(device, card, errs):
    # the package's trigger entry point on the card (residual mode, noise)
    entry_step, (x,) = tentry.trigger_entry(device)
    ts, ts2 = entry_step(x)
    for name, t in (("first", ts), ("residual", ts2)):
        if not bool(torch.isfinite(t.dchi2).all() & torch.isfinite(
                t.amplitudes).all()):
            raise RuntimeError(f"trigger_entry(): {name} pass not finite")
    log(f"[e] trigger_entry(): {tuple(x.shape)} noise, "
        f"{int(ts.count.sum())} + {int(ts2.count.sum())} triggers, "
        f"capacity {ts.indices.shape[-1]}")
    del entry_step, x, ts, ts2

    kernel, basis, template = tentry.build_trigger()
    sat = [tentry.TRIGGER_SAT_RESOLUTIONS * float(kernel.resolution[0])]
    args = (tentry.TRIGGER_SIGMA, tentry.TRIGGER_WINDOW)
    steps = {mode: TriggerStep(kernel, basis, *args,
                               run_residual=(mode == "residual"),
                               sat_amps=sat, device=device)
             for mode in ("base", "residual")}
    sigma = float(kernel.resolution[0])
    gen = torch.Generator(device=device).manual_seed(SEED)
    tmpl = torch.as_tensor(template, dtype=torch.float32, device=device)
    batches = [trigger_batch(gen, kernel, tmpl, device)
               for _ in range(TRIG_BATCHES)]
    nsamples = TRIG_BATCHES * tentry.TRIGGER_EVENTS * tentry.TRIGGER_L
    expect = {"base": {"rfft": 1, "cufft_rfft": 0},
              "residual": {"rfft": 2, "cufft_rfft": 1}}
    results = {}
    torch.cuda.reset_peak_memory_stats(device)
    for mode, step in steps.items():
        outs, ms, host_ms, launches, library = run_trigger(step, batches,
                                                           device)
        log(f"[e] trigger {mode}: {nsamples / (ms * 1e3):.1f} Msamples/s "
            f"on {card} ({TRIG_BATCHES} batches of {tentry.TRIGGER_EVENTS} "
            f"x {tentry.TRIGGER_L} samples, {ms:.3f} ms device time, CUDA "
            f"events; host clock {host_ms:.3f} ms, "
            f"{nsamples / (host_ms * 1e3):.1f} Msamples/s)")
        log(f"[e] {mode} launches on the path: {launches}; library route: "
            f"{library}")
        want = {"rfft": expect[mode]["rfft"] * TRIG_BATCHES,
                "fused_nodelay_of": 0,
                "cufft_rfft": expect[mode]["cufft_rfft"] * TRIG_BATCHES}
        if {**launches, **library} != want:
            raise RuntimeError(f"trigger {mode}: launches {launches}, "
                               f"library {library}, expected {want}")
        dists, signs = check_recovery(mode, outs, batches, sigma)
        check_offsets(dists, signs, mode)
        if mode == "residual":
            log(f"[e] residual-pass triggers per batch "
                f"{[int(ts2.count.sum()) for _, ts2 in outs]}")
        else:
            check_worst_pulse(dists, step, batches, args, sat, sigma)
        busy, top = device_busy(step, batches[0].x, device)
        log(f"[e] {mode}: device busy {busy:.3f} ms of {ms / TRIG_BATCHES:.3f}"
            f" ms a batch ({100 * (1 - busy * TRIG_BATCHES / ms):.1f}% idle; "
            "torch.profiler, one batch); most device time: "
            + "; ".join(f"{k} {v:.3f} ms" for k, v in top))
        results[mode] = (outs, ms, launches, library)
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    log(f"[e] peak memory {peak:.2f} GiB")

    check_event0(steps, results, batches, args, sat)

    layers = trigger_layer_times(steps["residual"], batches[0].x)
    total = max(sum(v[1] for v in layers.values()), 1e-9)
    log(f"[e] layers of one residual batch ({tentry.TRIGGER_EVENTS} x "
        f"{tentry.TRIGGER_L}, on {card}), CUDA-event ms / device ms "
        "(share of device ms): "
        + "; ".join(f"{k} {ev:.3f} / {dv:.3f} ms ({100 * dv / total:.1f}%)"
                    for k, (ev, dv) in layers.items()))

    # the rFFT kernel against its twin on the path's own segments
    kernel_d, basis_d = steps["residual"].device_kernels()
    segs = {"FIR": trigger.fir_segments(batches[0].x, kernel_d)
            .reshape(-1, kernel_d.fft_size)}
    ts0 = results["residual"][0][0][0]
    spikes_len = segs["FIR"].shape[0] // tentry.TRIGGER_EVENTS
    # unit spikes at the first-pass triggers, on the subtraction's axis
    seg_len = 2 * kernel.nt - 1
    spikes = torch.zeros((tentry.TRIGGER_EVENTS, 1,
                          spikes_len * kernel_d.block + seg_len),
                         device=device)
    spikes[:, 0].scatter_(-1, ts0.indices.clamp(min=0) + seg_len, 1.0)
    segs["basis"] = trigger.fir_segments(spikes, basis_d.fir).reshape(
        -1, basis_d.fir.fft_size)
    timings = {}
    for what, seg in segs.items():
        got = cuda_fft.rfft_kernel(seg)
        ref = cuda_fft.rfft_plain(seg)
        torch.cuda.synchronize(device)
        dmax = float((got - ref).abs().max())
        rel = dmax / float(ref.abs().max())
        log(f"[e] rfft on the {what} segments [{seg.shape[0]}, "
            f"{seg.shape[1]}]: max|Δ| {dmax:.3e}, max|Δ|/max|ref| {rel:.3e} "
            f"(tol {RFFT_TOL:g})")
        if not rel <= RFFT_TOL:
            raise RuntimeError(f"rfft kernel disagrees on the trigger {what}"
                               f" segments: {rel:.3e}")
        errs["rfft"][0] = max(errs["rfft"][0], dmax)
        errs["rfft"][1] = max(errs["rfft"][1], rel)
        row_bytes = 4 * seg.shape[1] + 8 * (seg.shape[1] // 2 + 1)
        k_ms, p_ms = time_pair(lambda: cuda_fft.rfft_kernel(seg),
                               lambda: cuda_fft.rfft_plain(seg),
                               max(TIMING_REPS, round(
                                   RUN_BYTES / (seg.shape[0] * row_bytes))))
        b_ms, b_by = bound("rfft", seg.shape[1], seg.shape[0])
        log(f"[e] rfft on the {what} segments: kernel {k_ms:.4f} ms, cuFFT "
            f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) (on {card})")
        timings[what] = {"rows": seg.shape[0], "n": seg.shape[1],
                         "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms}
    return results["residual"][2], timings


def phase_f(device, card):
    gen = torch.Generator(device=device).manual_seed(SEED)
    for n in OFF_KERNEL_N:
        bank, template, _ = build_bank(n, n // 2, FS)
        step = FeatureStep(filterbank.bank_to_torch(bank, device,
                                                    torch.float32),
                           [CHAN], FS, n // 2, n)
        tmpl = torch.as_tensor(template, dtype=torch.float32, device=device)
        psd_half = torch.as_tensor(bank.psd[0][:n // 2 + 1],
                                   dtype=torch.float32, device=device)
        raw = synth_batch(gen, torch.sqrt(psd_half * FS * n / 2.0), tmpl,
                          OFF_KERNEL_B, n)[0][:, None, :]
        _kernels.reset_launch_counts()
        out = step(raw)
        torch.cuda.synchronize(device)
        launches, library = _kernels.launch_counts(), _kernels.library_counts()
        log(f"[f] FeatureStep N={n} B={OFF_KERNEL_B}: launches {launches}, "
            f"library route {library} (on {card})")
        if any(launches.values()) or library["cufft_rfft"] != 1:
            raise RuntimeError(f"N={n}: expected no kernel launch and one "
                               f"cuFFT call, got {launches}, {library}")
        for key, v in out.items():
            if v.shape != (OFF_KERNEL_B,) or not bool(torch.isfinite(v).all()):
                raise RuntimeError(f"N={n}: column {key} not finite or of "
                                   f"shape {tuple(v.shape)}")
        check_reference(out, raw, cpu_step_reference(raw, bank, n),
                        f"the float64 CPU run of the same step (N={n})", "f")


def compare_shell(got, ref, rows, what):
    """Rows ``rows`` of the card's table ``got`` against the float64 CPU
    table ``ref`` (one row each), within SHELL_RTOL (t0 within one
    sample; sums over a window also within 1e-6 of the column's largest
    |value|)."""
    worst = {}
    for key, r in ref.items():
        kind = key.split("_")[0]
        if kind not in SHELL_RTOL and kind != "t0":
            continue
        g = np.asarray(got[key], np.float64)[rows]
        r = np.asarray(r, np.float64)
        if kind == "t0":
            err = float(np.abs(g - r).max()) * FS
            ok = err <= 1.0 + 1e-6
            worst[kind] = max(worst.get(kind, 0.0), err)
        else:
            atol = (1e-6 * float(np.abs(r).max()) if kind in (
                "baseline", "integral", "maximum", "minimum") else 0.0)
            err = float((np.abs(g - r) / (np.abs(r) + atol / SHELL_RTOL[kind]
                                          + 1e-300)).max())
            ok = err <= SHELL_RTOL[kind]
            worst[kind] = max(worst.get(kind, 0.0), err)
        if not ok:
            raise RuntimeError(f"{what}: {key} off by {err:.3e} (tol "
                               f"{SHELL_RTOL.get(kind, 1.0):g})")
    log(f"[g] {what}: worst by kind " + "; ".join(
        f"{k} {v:.3e}" for k, v in sorted(worst.items())))


def device_intervals(prof):
    """(union of device busy intervals, kernel sum, copy sum), each in ms,
    of a torch.profiler run: kernels and copies on different streams
    overlap, so the union is the device's busy time."""
    spans, kern, copy = [], 0.0, 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        if e.name.startswith("Memcpy"):
            copy += e.device_time_total / 1e3
        else:
            kern += e.device_time_total / 1e3
    busy, end = 0.0, -np.inf
    for a, b in sorted(spans):              # µs
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, kern, copy


def run_shell(shell, what, card, **kw):
    """One process() call with a StageTimer: (table, seconds, timer
    report)."""
    timer = StageTimer()
    t = time.perf_counter()
    table = shell.process(dtype=np.float32, timer=timer, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    stages = {k: round(v["seconds"], 4)
              for k, v in timer.report(log=False).items()}
    n = shell.stats["events"]
    log(f"[g] {what}: {n} events in {sec:.4f} s, {n / sec:.1f} events/s "
        f"end to end (host clock, process() call to returned columns); "
        f"host stages {stages} s; on {card}")
    return table, sec, stages


def shell_physics(table, amps, shifts):
    """Per channel: amplitude bias, χ²/dof, unconstrained t0 within one
    sample of the injected offset, constrained t0 inside its window."""
    ev = ((table["dump_number"] - 1) * (SHELL_EVENTS // SHELL_FILES)
          + table["event_number"] - 1)
    half = int(tentry.SHELL_WINDOW_USEC * 1e-6 * FS)
    out = {}
    for c, chan in enumerate(tentry.SHELL_CHANNELS):
        truth = amps[ev, c]
        amp = table[f"amp_of1x1_unconstrained_{chan}"]
        chi2 = table[f"chi2_of1x1_unconstrained_{chan}"]
        t0 = np.rint(table[f"t0_of1x1_unconstrained_{chan}"] * FS)
        t0c = np.rint(table[f"t0_of1x1_constrained_{chan}"] * FS)
        out[chan] = {
            "amp_bias": float(np.mean((amp - truth) / truth)),
            "chi2_dof": float(np.mean(chi2) / (tentry.SHELL_N - 2)),
            "t0_within_1": float(np.mean(np.abs(t0 - shifts[ev]) <= 1)),
            "t0c_in_window": bool(np.all(np.abs(t0c) <= half))}
        p = out[chan]
        p["pass"] = bool(abs(p["amp_bias"]) < 5e-3
                         and abs(p["chi2_dof"] - 1.0) < 0.05
                         and p["t0_within_1"] > 0.99 and p["t0c_in_window"])
    log(f"[g] physics: {json.dumps(out)}")
    if not all(p["pass"] for p in out.values()):
        raise RuntimeError("shell physics invariants failed")


def check_shell_launches(launches, library, nbatch, what):
    want = {"rfft": SHELL_SPECTRAL * nbatch,
            "fused_nodelay_of": SHELL_SPECTRAL * nbatch, "cufft_rfft": 0}
    log(f"[g] {what} launches: {launches}, library route {library} "
        f"({nbatch} batches)")
    if {**launches, **library} != want:
        raise RuntimeError(f"{what}: launches {launches}, library "
                           f"{library}, expected {want}")


def trigger_stream(gen, device, directory):
    """One flat dump of 8 continuous 4-channel events of 1,250,000 int16
    samples: noise of each channel's PSD and SHELL_TRIG_PULSES pulses of
    1–5 µA an event at known indices (pretrigger 1024 of the 4096-sample
    templates). Returns (path, trigger table dict, injected amps)."""
    e, l = tentry.TRIGGER_EVENTS, tentry.TRIGGER_L
    c = len(tentry.SHELL_CHANNELS)
    nh = l // 2 + 1
    scale = torch.as_tensor(np.sqrt(tentry.shell_psds(l, FS)[:, :nh] * FS
                                    * l / 2.0), dtype=torch.float32,
                            device=device)
    tmpl = torch.as_tensor(tentry.shell_templates(SHELL_TRIG_N,
                                                  SHELL_TRIG_PRE, FS),
                           dtype=torch.float32, device=device)
    conv = torch.as_tensor(tentry.shell_conv(), dtype=torch.float32,
                           device=device)
    slot = l // SHELL_TRIG_PULSES
    path = os.path.join(directory, "trigger_stream.bin")
    idx_all, amp_all = [], []
    for ev in range(e):
        z = torch.randn((c, 2, nh), generator=gen, device=device)
        nf = torch.complex(z[:, 0], z[:, 1]) * scale
        nf[:, 0] = 0.0
        x = torch.fft.irfft(nf, n=l)
        offs = torch.randint(SHELL_TRIG_PRE + 100,
                             slot - (SHELL_TRIG_N - SHELL_TRIG_PRE) - 100,
                             (SHELL_TRIG_PULSES,), generator=gen,
                             device=device)
        idx = torch.arange(SHELL_TRIG_PULSES, device=device) * slot + offs
        amp = torch.empty((SHELL_TRIG_PULSES, c), device=device).uniform_(
            1e-6, 5e-6, generator=gen)
        cols = ((idx - SHELL_TRIG_PRE)[:, None]
                + torch.arange(SHELL_TRIG_N, device=device)).reshape(-1)
        for ch in range(c):
            x[ch].index_add_(0, cols, (amp[:, ch, None] * tmpl[ch]).reshape(
                -1))
        codes = torch.round(x / conv[:, None]).to(torch.int16)
        write_flat_dump(path, codes[None].cpu().numpy(), append=ev > 0)
        idx_all.append(idx.cpu().numpy())
        amp_all.append(amp.cpu().numpy())
    # the table: each event's pulses in time order, with one window
    # before the trace start and one past its end, which are dropped
    rows = {"event_number": [], "trigger_index": [], "trigger_amplitude": []}
    for ev in range(e):
        for ti, a in ([(SHELL_TRIG_PRE - 1, 0.0)]
                      + list(zip(idx_all[ev], amp_all[ev][:, 0]))
                      + [(l - 10, 0.0)]):
            rows["event_number"].append(ev + 1)
            rows["trigger_index"].append(int(ti))
            rows["trigger_amplitude"].append(float(a))
    nrow = len(rows["event_number"])
    table = {"series_number": np.full(nrow, series_to_number(
                 tentry.SHELL_SERIES), np.int64),
             "dump_number": np.ones(nrow, np.int64),
             "event_number": np.asarray(rows["event_number"], np.int64),
             "trigger_index": np.asarray(rows["trigger_index"], np.int64),
             "trigger_time": np.asarray(rows["trigger_index"]) / FS,
             "trigger_amplitude": np.asarray(rows["trigger_amplitude"]),
             "trigger_type": np.full(nrow, 4, np.int64),
             "trigger_channel": np.array(["chan1"] * nrow)}
    return path, table, np.concatenate(amp_all)


def phase_g(device, card, errs):
    """The FeatureProcessing shell from flat int16 files, full-trace and
    trigger-table mode; returns the kernels' launches on its path."""
    tmp = tempfile.mkdtemp(prefix="detprocess_smoke_")
    try:
        return _phase_g(device, card, errs, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phase_g(device, card, errs, tmp):
    gen = torch.Generator(device=device).manual_seed(SEED)
    t = time.perf_counter()
    paths, amps, shifts = tentry.write_shell_dumps(
        tmp, gen, SHELL_EVENTS, SHELL_FILES, device)
    nbytes = sum(os.path.getsize(p) for p in paths)
    log(f"[g] wrote {SHELL_EVENTS} events, {nbytes / 2**30:.3f} GiB of int16"
        f" codes, in {SHELL_FILES} flat dumps in "
        f"{time.perf_counter() - t:.1f} s (set-up, not timed)")
    index = tentry.shell_index(paths)
    shell = FeatureProcessing(index, tentry.shell_config(),
                              tentry.shell_filter_data(), verbose=False,
                              device=device)
    kw = dict(batch_size=SHELL_BATCH, nreaders=SHELL_READERS)
    nbatch = -(-SHELL_EVENTS // SHELL_BATCH)

    _kernels.reset_launch_counts()
    table, _, _ = run_shell(shell, "full-trace mode, first call", card, **kw)
    launches = _kernels.launch_counts()
    check_shell_launches(launches, _kernels.library_counts(), nbatch,
                         "full-trace mode")
    st = shell.stats
    log(f"[g] upload: {st['upload_bytes']} bytes for "
        f"{st['upload_samples']} samples "
        f"({st['upload_bytes'] / st['upload_samples']:g} bytes a sample)")
    want_samples = SHELL_EVENTS * len(tentry.SHELL_CHANNELS) * tentry.SHELL_N
    if (st["upload_samples"] != want_samples
            or st["upload_bytes"] != 2 * want_samples):
        raise RuntimeError(f"upload not int16: {st}")
    for key, v in table.items():
        if len(v) != SHELL_EVENTS:
            raise RuntimeError(f"column {key}: {len(v)} rows, not "
                               f"{SHELL_EVENTS}")
        if key.split("_")[0] in SHELL_RTOL and not np.isfinite(v).all():
            raise RuntimeError(f"column {key} is not finite")
    shell_physics(table, amps, shifts)

    # events 0–15 of every batch against the float64 CPU run
    pos = np.concatenate([np.arange(b * SHELL_BATCH,
                                    b * SHELL_BATCH + REF_EVENTS)
                          for b in range(nbatch)])
    rows = index.order[pos]
    ref_shell = FeatureProcessing(index.subset(rows), tentry.shell_config(),
                                  tentry.shell_filter_data(), verbose=False,
                                  device="cpu")
    ref = ref_shell.process(batch_size=len(rows), dtype=np.float64)
    for key in ("event_number", "dump_number"):
        if not np.array_equal(ref[key], table[key][pos]):
            raise RuntimeError(f"CPU and card rows differ in {key}")
    compare_shell(table, ref, pos, f"full-trace mode, events 0-"
                  f"{REF_EVENTS - 1} of each of {nbatch} batches vs the "
                  "float64 CPU run of the shell")
    # chan1 of the first events against the per-event numpy reference
    reader = RawReader(index)
    raw = torch.as_tensor(np.stack([reader.read_row(int(r), ["chan1"])[0]
                                    for r in index.order[:REF_EVENTS]]))
    reader.close()
    template = tentry.shell_templates()[0]
    psd = tentry.shell_psds()[0]
    out = {k: torch.as_tensor(v) for k, v in table.items()
           if k.endswith("_chan1")}
    check_reference(out, raw, loop_reference(raw, template, psd),
                    "the float64 per-event reference (RefOF1x1)", "g")

    _, warm_s, _ = run_shell(shell, "full-trace mode, second call", card,
                             **kw)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, prof_s, _ = run_shell(shell, "full-trace mode, under "
                                 "torch.profiler", card, **kw)
    busy, kern, copy = device_intervals(prof)
    share = busy / (1e3 * prof_s)
    log(f"[g] device busy {busy:.3f} ms of the profiled {1e3 * prof_s:.3f} "
        f"ms call ({100 * share:.1f}% busy, {100 * (1 - share):.1f}% idle; "
        f"union of device intervals); kernels {kern:.3f} ms, copies "
        f"{copy:.3f} ms; on {card}")

    # the group steps alone on one batch already on the card
    block = SHELL_BATCH * len(tentry.SHELL_CHANNELS) * tentry.SHELL_N
    codes = torch.as_tensor(np.fromfile(paths[0], np.int16, block).reshape(
        SHELL_BATCH, len(tentry.SHELL_CHANNELS), tentry.SHELL_N)).to(device)
    conv = torch.as_tensor(tentry.shell_conv(), dtype=torch.float32,
                           device=device).expand(SHELL_BATCH, -1)
    x = adc_convert(codes, conv)
    steps = shell.group_steps()
    for step in steps:
        step(x)
    with dev.CudaTimer() as tm:
        for _ in range(3):
            for step in steps:
                step(x)
    step_ms = tm.ms / 3
    log(f"[g] group steps alone: {step_ms:.3f} ms a batch of {SHELL_BATCH}, "
        f"{SHELL_BATCH / (step_ms / 1e3):.1f} events/s (CUDA events) against"
        f" {SHELL_EVENTS / warm_s:.1f} events/s of the shell; on {card}")
    # the kernels against their twins at the shell's shapes
    full_step = steps[0]
    slot = next(s.slot for s in full_step.specs if s.base == "of1x1_nodelay")
    compare_kernels(x[:, 0].contiguous(), full_step.nodelay[str(slot)], errs,
                    "g")
    del codes, x

    # trigger-table mode
    path, ttable, _ = trigger_stream(gen, device, tmp)
    tindex = RawIndex.from_flat(
        [path], tentry.SHELL_CHANNELS, tentry.TRIGGER_L, FS,
        tentry.SHELL_SERIES, dtype=np.int16,
        adc_conversion_factor=tentry.SHELL_CAL,
        detector_config={c: {"close_loop_norm": cln} for c, cln in zip(
            tentry.SHELL_CHANNELS, tentry.SHELL_CLN)})
    cfg = tentry.shell_config(SHELL_TRIG_N, SHELL_TRIG_PRE)
    fd = tentry.shell_filter_data(SHELL_TRIG_N, SHELL_TRIG_PRE)
    tshell = FeatureProcessing(tindex, cfg, fd, trigger_table=ttable,
                               verbose=False, device=device)
    _kernels.reset_launch_counts()
    tkw = dict(batch_size=SHELL_TRIG_BATCH, nreaders=SHELL_READERS)
    ttab, _, _ = run_shell(tshell, "trigger-table mode", card, **tkw)
    tlaunch = _kernels.launch_counts()
    nkept = len(ttab["event_number"])
    check_shell_launches(tlaunch, _kernels.library_counts(),
                         -(-nkept // SHELL_TRIG_BATCH), "trigger-table mode")
    ndrop = 2 * tentry.TRIGGER_EVENTS
    log(f"[g] trigger-table mode: {nkept} rows kept, "
        f"{tshell.stats['dropped']} dropped (out of bounds: {ndrop})")
    if tshell.stats["dropped"] != ndrop or nkept != len(
            ttable["event_number"]) - ndrop:
        raise RuntimeError("trigger-table mode dropped the wrong rows")
    if tshell.stats["upload_bytes"] != 2 * tshell.stats["upload_samples"]:
        raise RuntimeError("trigger-table mode: upload not int16")
    kept = np.flatnonzero((ttable["trigger_index"] >= SHELL_TRIG_PRE) & (
        ttable["trigger_index"] - SHELL_TRIG_PRE + SHELL_TRIG_N
        <= tentry.TRIGGER_L))
    tref = FeatureProcessing(tindex, cfg, fd, trigger_table=ttable,
                             verbose=False, device="cpu").process(
        nevents=int(kept[REF_EVENTS - 1]) + 1, batch_size=REF_EVENTS,
        dtype=np.float64)
    compare_shell(ttab, tref, np.arange(REF_EVENTS), f"trigger-table mode, "
                  f"the first {REF_EVENTS} rows vs the float64 CPU run")
    bias = np.mean((ttab["amp_of1x1_unconstrained_chan1"]
                    - ttab["trigger_amplitude"]) / ttab["trigger_amplitude"])
    t0_ok = np.mean(np.abs(np.rint(ttab["t0_of1x1_unconstrained_chan1"]
                                   * FS)) <= 1)
    log(f"[g] trigger-table mode, chan1: amplitude bias {bias:.3e}, t0 "
        f"within one sample {t0_ok:.4f}")
    if not (abs(bias) < 5e-3 and t0_ok > 0.99):
        raise RuntimeError("trigger-table mode: amplitudes or t0 off")
    # the kernels against their twins at the trigger windows' shape
    tstep = tshell.group_steps()[0]
    tslot = next(s.slot for s in tstep.specs if s.base == "of1x1_nodelay")
    treader = RawReader(tindex)
    win = torch.as_tensor(np.stack([
        treader.read_single_event(int(e), trace_window=(
            int(i) - SHELL_TRIG_PRE, SHELL_TRIG_N), channels=["chan1"],
            dtype=np.float32)[0][0]
        for e, i in zip(ttable["event_number"][kept[:SHELL_TRIG_BATCH]],
                        ttable["trigger_index"][kept[:SHELL_TRIG_BATCH]])]),
        device=device)
    treader.close()
    compare_kernels(win, tstep.nodelay[str(tslot)], errs, "g")
    return {k: launches[k] + tlaunch[k] for k in launches}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=os.path.abspath, default=None,
                    help="an earlier checkout (git archive) whose rFFT "
                    "kernel phase (d) times beside this one (earlier_ms)")
    args = ap.parse_args(argv)
    device, card = phase_a()
    parent_fft = None
    if args.parent is not None:
        sys.path.insert(0, os.path.join(ROOT, "scripts"))
        from torch_fused_ab import import_tree
        parent_fft = import_tree(args.parent, "ops.cuda_fft")
        parent_fft._kernels.build()
    regs = phase_b()
    errs = phase_c(device)
    launches, timings, clocks = phase_d(device, card, errs, regs, parent_fft)
    trig_launches, trig_timings = phase_e(device, card, errs)
    phase_f(device, card)
    shell_launches = phase_g(device, card, errs)
    kernels = []
    for name in _kernels.KERNELS:
        b_ms, b_by = bound(name, N, BATCH)
        per_path = {"feature": launches[name], "trigger": trig_launches[name],
                    "shell": shell_launches[name]}
        rfft = name == "rfft"
        kernels.append({
            "name": name, "route": "cuda",
            "source": KERNEL_INFO[name]["source"],
            "replaces": KERNEL_INFO[name]["replaces"],
            "launches": sum(per_path.values()),
            "launches_per_path": per_path,
            "max_abs_err": errs[name][0],
            "max_rel_err": errs[name][1],
            "ms": timings[name][0],
            "plain_ms": timings[name][1],
            "bound_ms": b_ms, "bound_by": b_by,
            # the rFFT's plain twin is the one PyTorch call torch.fft.rfft
            # (cuFFT); no single call computes the fused sums
            "library_ms": timings[name][1] if rfft else None,
            "phase_clocks": clocks[name],
            # the earlier form's time in the same call (--parent), else null
            **({"earlier_ms": timings.get("rfft_earlier"),
                "trigger_path": trig_timings} if rfft else {})})
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
