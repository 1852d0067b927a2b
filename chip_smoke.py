#!/usr/bin/env python3
"""GPU smoke run of detprocess_tpu_torch: the of1x1 feature step on one card.

    python3 chip_smoke.py

Phases (each failure ends the run with a non-zero exit):

a. device: the card's name and power limit (nvidia-smi), require_cuda();
b. build: nvcc compiles the kernels under detprocess_tpu_torch/csrc/
   (set-up time; the compiler's register/spill report is printed);
c. kernels: each hand-written kernel against its plain PyTorch twin on
   the card, B = 64 and N in {1024, 16384, 32768}:
   rFFT max|Δ|/max|ref| <= 1e-5; fused no-delay amp rtol 1e-5, χ² rtol
   5e-3 (the χ² sits at the float32 cancellation floor of
   χ²₀ − q²/norm);
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
   time beside its plain twin's at the slice shapes.

The last line is {"ok": true, "device": {...}}; the line before it is the
{"kernels": [...]} summary. Needs one CUDA device; imports no JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from detprocess_tpu_torch import device as dev  # noqa: E402
from detprocess_tpu_torch.entry import build_bank, entry  # noqa: E402
from detprocess_tpu_torch.ops import _kernels, cuda_fft  # noqa: E402
from detprocess_tpu_torch.ops import fft, filterbank, of1x1  # noqa: E402
from detprocess_tpu_torch.ops import tracestats  # noqa: E402
from detprocess_tpu_torch.ops.cuda_of import FusedNodelayOF  # noqa: E402
from detprocess_tpu_torch.pipelines.feature_step import (  # noqa: E402
    FeatureStep)

FS = 1.25e6
N = 32768
PRETRIG = N // 2
BATCH = 8192
NBATCH = 8
SEED = 0
CHAN = "chan1"

CHECK_NS = (1024, 16384, 32768)
CHECK_B = 64
RFFT_TOL = 1e-5          # max|Δ| / max|ref|
AMP_RTOL = 1e-5
CHI2_RTOL = 5e-3
TIMING_REPS = 10

# the slice's first events against the float64 CPU run of the same step:
# float32 on the card vs float64; χ² and lowchi2 carry the f32
# cancellation of χ²₀ − q²/norm and of the residual
REF_EVENTS = 16
LOW_FCUT = 10000.0       # FeatureStep's default lowchi2_fcutoff
REF_RTOL = {"amp": 1e-4, "chi2": 5e-3, "lowchi2": 2e-2, "baseline": 1e-4,
            "integral": 1e-4}

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

    amp_k, chi2_k = fused.kernel(x)
    amp_p, chi2_p = fused.plain(x)
    torch.cuda.synchronize(x.device)
    amp_rel = rel_err(amp_k, amp_p)
    chi2_rel = rel_err(chi2_k, chi2_p)
    amp_abs = float((amp_k.double() - amp_p.double()).abs().max())
    errs["fused_nodelay_of"][0] = max(errs["fused_nodelay_of"][0], amp_abs)
    errs["fused_nodelay_of"][1] = max(errs["fused_nodelay_of"][1], amp_rel)
    log(f"[{phase}] fused_nodelay_of N={n} B={batch}: amp max|Δ| "
        f"{amp_abs:.3e}, rel {amp_rel:.3e} (tol {AMP_RTOL:g}); χ² rel "
        f"{chi2_rel:.3e} (tol {CHI2_RTOL:g})")
    if not (amp_rel <= AMP_RTOL and chi2_rel <= CHI2_RTOL):
        raise RuntimeError(f"fused no-delay kernel disagrees at N={n}, "
                           f"B={batch}")


def phase_c(device, ns=CHECK_NS, batch=CHECK_B):
    gen = torch.Generator(device=device).manual_seed(SEED)
    errs = {"rfft": [0.0, 0.0], "fused_nodelay_of": [0.0, 0.0]}
    for n in ns:
        bank, x = make_traces(n, batch, device, gen)
        fused = FusedNodelayOF.from_bank(
            filterbank.bank_to_torch(bank, device, torch.float32))
        compare_kernels(x, fused, errs, "c")
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


def cpu_step_reference(raw, bank):
    """The first events through the same step in float64 on the CPU."""
    ref_step = FeatureStep(
        filterbank.bank_to_torch(bank, "cpu", torch.float64), [CHAN], FS,
        PRETRIG, N)
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


def check_reference(out, raw, ref, what):
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
    log(f"[d] first {REF_EVENTS} events vs {what}: "
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


def phase_d(device, card, errs):
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
    return launches, timings


def main():
    device, card = phase_a()
    phase_b()
    errs = phase_c(device)
    launches, timings = phase_d(device, card, errs)
    kernels = [{"name": name, "route": "cuda",
                "source": KERNEL_INFO[name]["source"],
                "replaces": KERNEL_INFO[name]["replaces"],
                "launches": launches[name],
                "max_abs_err": errs[name][0],
                "max_rel_err": errs[name][1],
                "ms": timings[name][0],
                "plain_ms": timings[name][1]}
               for name in _kernels.KERNELS]
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
