#!/usr/bin/env python3
"""GPU smoke run of detprocess_tpu_torch: the of1x1 feature step, the
continuous-data trigger step, the FeatureProcessing shell, the
TriggerProcessing shell chained into it, every feature algorithm
through FeatureProcessing, filter generation chained into it, salting
through both shells, the dynamic and sub-tile trigger modes, the
IV/dIdV sweep with the dIdV branch of filter generation, and the
command line over files, on one card.

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
h. the TriggerProcessing shell (entry.py's trigger configuration, the
   trigger half of BASELINE.json config 5): 64 continuous events of the 4
   shell channels × 1,250,000 int16 samples (610 MiB in 4 flat dumps in a
   temporary directory, deleted at the end), each with 40 coincident 10σ
   pulses (channel offsets within ±20 samples), 2 single 10σ pulses on
   chan2–chan4, and on chan1 two pulses of 1–5 µA and one of 8 µA above
   its saturation level; processed with process(event_batch=8,
   capacity=4096, nreaders=4) in float32 three times (the third under
   torch.profiler). It fails unless the rFFT kernel launches 5 times a
   batch (4 FIR segment transforms and chan1's residual convolution) and
   the cuFFT route once (chan1's low-pass), the upload is 2 bytes a
   sample, every pulse is found in its channel's columns within ±256
   samples and 5σ, each coincident group ends as one row (or, where a
   channel triggered once more inside the window, as no more rows than
   such extra triggers allow), chan1's pulses above the saturation level
   are found by both passes of its step, and event 1 agrees with the
   shell's float64 CPU run (phase (e)'s tolerances). It prints continuous
   events/s and Msamples/s (host clock), the StageTimer's read, dispatch,
   drain and dump seconds and the device's busy share, and holds the rFFT
   kernel against its twin on the path's FIR and residual segments. Then
   the chain: the card's table into FeatureProcessing in trigger-table
   mode (windows of 4096/1024, shell_config(4096, 1024)): 5 launches a
   batch of each kernel, cuFFT 0, every row kept, chan1's large pulses'
   amplitude bias below 5e-3 and t0 within one sample for > 99 %; both
   kernels against their twins on its windows.
i. every feature algorithm (entry.feature_coverage_entry, the
   configuration of docs/CONFIG.md:38-75 on the 4 shell channels at
   N = 32768): 2048 events made on the card (int16 codes, 512 MiB, 2 flat
   dumps in a temporary directory, deleted at the end) with, on chan1, a
   scintillation pulse and an evaporation pulse 40–400 samples later, on
   chan2 the shared pulse's part and a line at the bin nearest 25 kHz, on
   chan3 and chan4 two-pole pulses of known rise and fall times; chan1's
   and chan2's noise correlated as their CSD says. process(batch_size=
   1024, nreaders=4) in float32 three times (the third under
   torch.profiler). It fails unless the rFFT kernel launches 4 times a
   batch (one a channel, shared by every spec) and the fused kernel once
   (chan1's of1x1_nodelay), cuFFT 0; the upload is 2 bytes a sample; all
   34 feature columns are finite; of1x2x2 and ofnxmx2 recover both
   amplitudes (mean relative error < 5e-3) and Δt (within 3 samples for
   > 99 %, mean error < 0.25 samples); ofnxm's shared amplitude is
   unbiased against its noiseless float64 fit (< 5e-3); psd_peaks finds
   the line within a bin in every event; phase's circular spread is below
   2e-3 rad and its mean within 1e-3 rad of the injected phase; rftau's
   median rise and fall times are within 15 % and 5 % of the injected
   ones; events 0–15 of each batch agree with the float64 CPU run of the
   shell, family by family (the joint fits where both chose the same
   delays, on at least 95 % of the events; rftau's times within the
   float64 run's spread). It prints rows/s of the second call, the busy
   share, each spec's layer in CUDA-event and device ms on one batch, and
   holds both kernels against their twins on the path's batch.
j. filter generation (entry.filter_generation_entry, docs/CONFIG.md's
   noise and template sections at 2048 randoms of N = 32768 on the 4
   shell channels): 64 continuous events of 1,250,000 int16 samples (610
   MiB, 4 flat dumps in a temporary directory, deleted at the end) made on
   the card, each channel's noise from its shell PSD (chan1's and chan2's
   correlated as coverage_csd says), a DC offset a channel, one 1–2 µA
   pulse and one glitch a channel and event. FilterDataProcessing.
   process() three times (counted, timed with a StageTimer, under
   torch.profiler). It fails unless the rFFT kernel launches 4 times a call
   (one a channel for all windows; the CSD reuses the PSDs' spectra),
   fused 0 and cuFFT 0; the upload is 2 bytes a sample; the card's cut
   masks equal the float64 CPU cuts on the same windows but for traces
   within 1e-4 of a cut edge, each named; the PSDs, the CSD (of
   √(C_ii·C_jj)) and the offsets agree with the float64 CPU run on the
   same kept windows within 1e-4; each PSD and the chan1|chan2 CSD agree
   with the spectra the noise was drawn from on bins 100 … N/2 − 1 (band
   mean of the pulls (est/truth − 1)·√K times √bins below 5, their rms
   within 0.05 of 1); every window that holds an injected pulse (onset at
   least 256 samples before its end) or glitch is cut in that channel;
   the templates are the analytic ones within 1e-6. It holds the rFFT
   kernel against its twin on the phase's windows and times it beside
   cuFFT at [2048, 32768], prints the stages' host seconds, the passes and
   kept counts of the cuts, the busy share, peak device memory and the
   phase's time, then feeds the generated filter data (in memory) to
   FeatureProcessing on 2048 of (g)'s events (without the compound
   channel, which filter generation does not make): 4 launches of each
   kernel, cuFFT 0, and (g)'s physics gate on every channel.
k. salting (entry.salting_chain_entry, examples/salting/saltchecks.py on
   (h)'s configuration): 64 noise-only continuous events of (h)'s four
   channels × 1,250,000 int16 samples (610 MiB, one flat dump in a
   temporary directory, deleted at the end) and 504 salts coincident on
   the four channels, 72 at each of 2, 3, 4, 5, 6, 7 and 9 σ of each
   channel's trigger resolution. TriggerProcessing three ways, each twice
   (first call counted, second timed): with the device injector (also a
   third call under torch.profiler), with the host injector, unsalted. It
   fails unless each run launches (h)'s kernels (rFFT 5, cuFFT 1 a
   batch); the device and unsalted runs upload 2 bytes a sample and the
   host run twice that; the device and host runs find the same
   (channel, event, index) triggers but for those whose Δχ² lies within
   1e-4 of the threshold (counted), Δχ² and amplitudes within 1e-5;
   salt_efficiency of chan1's salts against chan1's triggers (saltchecks'
   match window) matches ε(A) = Φc(n − A/σ) + Φc(n + A/σ) with |pull| < 5
   where A is more than 0.75 σ from n = 5; the unsalted run triggers at
   no more than 2 of the salts' indices. Then FeatureProcessing with the
   device injector on a table of the injected indices (4096/1024, the
   of1x1 no-delay fit of each channel; first call counted, second timed):
   rFFT and fused 4 a batch, cuFFT 0, every row kept, 2 bytes a sample,
   and in every bin from 6.5 σ up each channel's amplitude unbiased
   within max(4·its error, 2 %) with a scatter of 0.6–1.4 σ. It prints
   events/s of every second call, the busy share, the device injection's
   CUDA-event ms on one batch of each shell and its share of that batch,
   and holds both kernels against their twins at the path's shapes.
l. the trigger modes (h)'s configuration does not use: 64 continuous
   events written as for (h) plus, on chan2, 8 pairs an event of 20σ
   pulses 1050 samples apart, whose above-threshold spans lie further
   apart than (h)'s 125-sample window and closer than the dynamic one.
   The shell runs once with (h)'s static windows, then twice (the first
   call counted, the second timed) with each mode: dynamic windows on all
   four channels (entry.trigger_shell_window_fn: 125 samples up to a
   group maximum of Δχ² 150, 2000 above; the default pre-merge), and
   pileup windows of 6, 1, 0 and 3 samples (tiles of 4, 2, 1 and 4) on 16
   events with capacity 32768 and no coincidence merge, since at window 0
   every above-threshold sample is a row. It fails unless each mode
   launches (h)'s kernels (rFFT 5, cuFFT 1, fused 0 a batch), every
   injected 10σ pulse is found as (h) finds it, every pair gives two
   triggers within 400 samples of its pulses with the static windows,
   one with the dynamic ones and at least two with the sub-tile ones,
   event 1 agrees with the float64 CPU run of the same configuration
   (phase (e)'s tolerances), the shell prints no warning (trigger or
   candidate capacity), the dynamic walk reads the host once a merge, and
   shift_templates_to_match_chi2 on the card (chan1's template and two
   copies rolled by 37 and −101 samples) gives the float64 CPU run's
   shifts. It prints events/s of each second call, the walk's steps and
   host reads, the busy share of a third dynamic call under
   torch.profiler, chan1's dynamic merges beside (h)'s tiled ones on one
   batch (CUDA-event and device ms), the phase's seconds, and holds the
   rFFT kernel against its twin on the path's FIR segments.
m. the IV/dIdV sweep (entry.ivsweep_entry and entry.run_ivsweep, the
   configuration of examples/iv_didv/ivsweep_analysis.py at a sweep's
   size): 32 bias points of chan1 (8 normal, 16 in the transition with R0
   from 0.25 to 0.03 Ω at loop gain 10 and β 2, 8 SC), each 128 noise
   traces of 32768 samples and 32 dIdV traces of 8 periods of the 100 Hz
   square wave, made on the card and written as int16 codes (about 450
   MiB in 64 flat dumps in a temporary directory, deleted at the end);
   one channel where a detector records four. IVSweepProcessing on the
   card (reads; the upload, cuts, float32 PSD through the rFFT kernel,
   float64 offsets and lock-in on the card), then on the CPU in float64
   IBIS, the state-aware 1/2/3-pole dIdV fits, the noise model and σ_E.
   It fails unless the rFFT kernel launches once a bias point (32) with
   cuFFT and the fused kernel at 0; the state tags are the truth's; Rn,
   Rp and every transition R0 are within 5 %, β within 0.5 and the loop
   gain within 30 % on at least 12 transition points, σ_E finite and
   positive on every one; and the same sweep processed and analysed on
   the CPU in float64 gives the same tags, IBIS within 1e-6, offsets,
   average traces and dIdV data within 1e-9, PSD bins k ≥ 1 within
   IV_PSD_RTOL (the float32 kernel on traces whose DC level is hundreds
   of σ of their noise), and the fits' identified parameters and costs
   within 1e-6 (at 3 poles A and τ₂: the one-block working points leave
   C → 0 and τ₃ free). Then the dIdV branch of filter generation on 4
   dIdV series at one operating point (entry.didv_filtergen_entry; no
   counted route may run), its didv_results_* against the CPU run within
   1e-6, β and l near truth, and FilterBuilder on one series against the
   filter file's row. It prints the sweep's seconds (reads, device work,
   CPU fits), the CPU run's, the card's busy share of process(), and the
   rFFT kernel beside torch.fft.rfft on a bias point's [128, 32768] batch,
   held against its twin there.
n. the command line (python -m detprocess_tpu_torch.cli) over files
   (entry.cli_chain_entry): (j)'s 64 continuous events written as one
   flat series with its JSON manifest (610 MiB), the JSON setup of filter
   generation at Nt = 4096, (h)'s trigger, (k)'s salting and its feature
   fit, and (m)'s 32-point sweep as a flat group, in a temporary
   directory deleted at the end. Call A (--calc-filter --enable-rand
   --nrandoms 2048 --output-format npz), call B (--filter_file A's npz
   --enable-salting --device-salting --enable-trig --enable-feature) and
   call C (--enable-ivsweep) through cli.main, counted; then B again as
   a subprocess into a second output base. It fails unless every call
   returns 0; the files carry the JAX names (rand_, salting_,
   threshtrig_, feature_ prefixes, the given series, _F0001…); the
   launches are A: rFFT 4; B: rFFT 5 a trigger batch and 4 a feature
   batch, fused 4 a feature batch, cuFFT 1 a trigger batch; C: rFFT 32;
   and nothing else; each table equals the API run of the same work on
   the same files, setup, seed and device (the same rows, integer and
   string columns exactly, float columns within 1e-6), and the
   subprocess's tables the in-process ones; A's PSDs and CSD agree with
   FilterDataProcessing.process within (j)'s 1e-4 and its templates are
   the analytic ones; C's sweep table agrees with IVSweepProcessing's
   within (m)'s tolerances; the salts clear of the data's own pulses and
   glitches pass (k)'s efficiency and energy-scale checks; both kernels
   agree with their twins on B's shapes. It prints each call's host
   seconds beside the API run's, and the subprocess's wall time.

The last line is {"ok": true, "device": {...}}; the line before it is the
{"kernels": [...]} summary, each kernel with its bound (bytes over the HBM
peak or float32 operations over the non-tensor peak, the larger), the
one PyTorch call that computes the same function, where there is one, and
its launches on each path (feature: phase d; trigger: phase e's residual
run; shell: phase g's two process() calls with the counts at 0;
trigger_shell: phase h's first process() call; chain: its table through
FeatureProcessing; coverage: phase i's first process() call; filtergen:
phase j's first process() call; filtergen_chain: its filter data through
FeatureProcessing; salting_trigger, salting_trigger_host,
salting_trigger_unsalted: phase k's first calls of the trigger shell with
the device injector, the host injector and none; salting_feature: its
first call of the salted feature shell; trigger_shell_dynamic,
trigger_shell_subtile: phase l's first calls of each mode; ivsweep:
phase m's sweep, filtergen_didv: its dIdV branch of filter generation;
cli_a, cli_b, cli_c: phase n's three command-line calls), whose sum is
``launches``, and the SM clocks of its phases from phase (d).
Needs one CUDA device; imports no JAX.
"""

import argparse
import contextlib
import io
import json
import math
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
from detprocess_tpu_torch.ops import autocuts, spectral  # noqa: E402
from detprocess_tpu_torch.pipelines.randoms import Randoms  # noqa: E402
from detprocess_tpu_torch.pipelines.salting import (  # noqa: E402
    salt_efficiency)
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
from detprocess_tpu_torch.pipelines.feature_group import (  # noqa: E402
    GroupStep)
from detprocess_tpu_torch.io.upload import BufferRing, Uploader  # noqa: E402
from detprocess_tpu_torch.pipelines import triggers  # noqa: E402
from detprocess_tpu_torch.pipelines.triggers import (  # noqa: E402
    TriggerProcessing)
from detprocess_tpu_torch.utils.logging import StageTimer  # noqa: E402
from detprocess_tpu_torch.io.upload import (  # noqa: E402
    channel_to_device, read_channel)
from detprocess_tpu_torch.models.didv import DIDVFit  # noqa: E402
from detprocess_tpu_torch.pipelines.filtergen import (  # noqa: E402
    FilterDataProcessing)
from detprocess_tpu_torch.pipelines.ivsweep import (  # noqa: E402
    IVSweepProcessing)
from detprocess_tpu_torch.pipelines.template import FilterBuilder  # noqa: E402
from detprocess_tpu_torch import cli  # noqa: E402
from detprocess_tpu_torch.config.yamlconfig import load_yaml  # noqa: E402
from detprocess_tpu_torch.io import tables as table_io  # noqa: E402
from detprocess_tpu_torch.io.filterdata import FilterData  # noqa: E402
from detprocess_tpu_torch.pipelines.ivsweep import (  # noqa: E402
    discover_bias_points)
from detprocess_tpu_torch.pipelines.salting import Salting  # noqa: E402

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

# phase (h): the TriggerProcessing shell from files, then the chain
TSHELL_EVENTS = 64
TSHELL_FILES = 4
TSHELL_BATCH = 8
TSHELL_READERS = 4
TSHELL_CAPACITY = 4096
CHAIN_BATCH = 512

# phase (i): every feature algorithm through FeatureProcessing
COV_EVENTS = 2048
COV_FILES = 2
COV_BATCH = 1024
COV_SPECTRAL = 4         # chan1 … chan4, each read through its spectrum
COV_FUSED = 1            # chan1's of1x1_nodelay
COV_COLUMNS = 34         # feature columns of the configuration
COV_NOISELESS = 128      # events whose noiseless NxM fit is ofnxm's truth
# the card (float32) against the float64 CPU run: the joint fits'
# amplitudes where both chose the same delays, and the share of events
# where they did not
# (float32 against float64 on the CPU, 512 events: amplitudes where the
# delays agree 3.4e-7, delays differing on 0.2 % of the events)
COV_RTOL = {"amp": 1e-4, "chi2": 5e-3, "lowchi2": 2e-2, "psd": 1e-4,
            "phase": 1e-3, "amplitud": 1e-2, "chisq": 5e-2}
COV_DELAY_MISMATCH = 0.05
# rftau's rise and fall times against the float64 run's spread over the
# same events (its noise): the largest difference within the spread, the
# median within 1 % of it (float32 against float64 on the CPU, 512
# events: largest 0.46, median 8e-5 of the spread; the LM steps accepted
# near the optimum differ)
COV_RFTAU_SPREAD = 1.0
COV_RFTAU_MEDIAN = 0.01
# physics
COV_BIAS = 5e-3          # joint fits' and ofnxm's mean relative amplitude
# Δt of the joint fits: the evaporation pulse's timing spreads over ±2
# samples in float64 too (1-3 µA; 512 events on the CPU: 71 % exact, 27 %
# one sample off, 1.4 % two)
COV_DT_TOL = 3           # samples, for > 99 % of the events
COV_DT_MEAN = 0.25       # samples, the mean error
COV_PHASE_STD = 2e-3     # rad, circular spread of the line's phase (4e-4)
COV_PHASE_MEAN = 1e-3    # rad, its mean from the injected phase
COV_RISE_SHARE = 0.15    # rftau median rise within this share of truth
COV_FALL_SHARE = 0.05    # and fall (the 50 kHz RC filter slows the rise:
                         # 21.9 for 20 and 36.3 for 35 samples in float64)

# phase (j): filter generation (entry.filter_generation_entry)
FG_EVENTS = tentry.FG_EVENTS     # continuous events of FG_LENGTH samples
FG_FILES = 4
FG_LENGTH = tentry.TRIGGER_L
FG_NRANDOMS = tentry.FG_NRANDOMS
FG_N, FG_PRETRIG = tentry.SHELL_N, tentry.SHELL_PRETRIG
FG_SPECTRAL = 4          # rFFT launches a process() call: one a channel
FG_RTOL = 1e-4           # PSD, CSD (of √(C_ii·C_jj)) and offsets vs float64
FG_EDGE_TOL = 1e-4       # a trace this close (relative) to a cut edge may
                         # fall on the other side in float32
FG_BAND_LO = 100         # truth band from this bin (3.8 kHz at N = 32768):
                         # the 1/f leakage of the boxcar window sits below
FG_PULL_MEAN = 5.0       # |band mean of the pulls| · √bins below this
FG_PULL_RMS = 0.05       # the pulls' rms within this of 1
FG_HOLD = 256            # a pulse "held" by a window: onset ≥ this many
                         # samples before the window's end
FG_TEMPLATE_TOL = 1e-6
FG_CHAIN_EVENTS = 2048   # (g)'s events for the chained FeatureProcessing
FG_CHAIN_BATCH = 2048
# phase (k): salting (entry.salting_chain_entry, (h)'s configuration on
# noise only, 504 salts coincident on the four channels)
SALT_EVENTS = tentry.SALT_EVENTS
SALT_LENGTH = tentry.TRIGGER_L
SALT_PER_POINT = tentry.SALT_PER_POINT
SALT_FEATURE_BATCH = 512
SALT_AMP_RTOL = 1e-5     # device against host injector: Δχ² and amplitudes
SALT_NEAR_THRESHOLD = 1e-4   # a trigger in one run only: Δχ² this close
SALT_MAX_PULL = 5.0      # efficiency against the closed form (saltchecks)
SALT_PULL_SKIP = 0.75    # … away from the threshold, in σ
SALT_RECOVERY_MIN = 6.5  # energy recovery checked from this many σ
SALT_SCATTER = (0.6, 1.4)
SALT_BIAS_FLOOR = 0.02
# phase (l): the trigger modes on (h)'s configuration
MODES_EVENTS = 64
MODES_PAIRS = 8           # pulse pairs on chan2 an event
MODES_PAIR_HALF = 400     # a pair's triggers: within this of its pulses
                          # (their main lobes reach ±301 samples)
MODES_SUB_EVENTS = 16     # window 0: each above-threshold sample is a row
MODES_SUB_CAPACITY = 32768
MODES_ALIGN_SHIFTS = (37, -101)

# phase (m): the sweep of entry.ivsweep_points at its full size
IV_NTRACES = tentry.IV_NOISE_TRACES   # noise traces a bias point
IV_N = tentry.IV_N                    # their length
IV_NDIDV = tentry.IV_DIDV_TRACES      # dIdV traces a bias point
IV_PERIODS = tentry.IV_PERIODS        # their square-wave periods
IV_DATA_RTOL = 1e-9      # offsets, average traces, dIdV data vs float64
IV_IBIS_RTOL = 1e-6
IV_FIT_RTOL = 1e-6       # fits' identified parameters and costs
IV_PSD_RTOL = 2e-3       # PSD bins k >= 1, float32 kernel vs float64: 2.5x
                         # the worst bin measured on an H100 (8.0e-4,
                         # PERF.md §6)
IV_MIN_GOOD = 12         # transition points with β and l near truth
FGD_SERIES = 4           # dIdV series of the filter-generation run

CLI_EVENTS = tentry.FG_EVENTS      # (j)'s continuous events, one flat dump
CLI_LENGTH = tentry.TRIGGER_L
CLI_NRANDOMS = tentry.FG_NRANDOMS
CLI_NSALT = tentry.SALT_PER_POINT  # (k)'s salts at each amplitude
CLI_BATCH = 256                    # the command line's --batch-size
CLI_FLOAT_RTOL = 1e-6    # command line against the API run: float columns
CLI_SUBPROCESS_TIMEOUT = 600

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


def compare_kernels(x, fused, errs, phase, amp_scale="event"):
    """Each kernel's wrapper against its plain twin on the traces ``x``
    [B, N] on the card; raise past the tolerances, keep the worst errors
    in ``errs`` ({name: [max abs, max rel]}). ``amp_scale``: the fused
    amplitudes' error relative to each event's (``"event"``) or to the
    batch's largest (``"batch"``, for batches of noise windows, whose
    amplitudes sit near 0)."""
    compare_rfft(x, errs, phase)
    compare_fused(x, fused, errs, phase, amp_scale)


def compare_rfft(x, errs, phase):
    """The rFFT kernel against its plain twin on ``x`` [B, N]."""
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


def compare_fused(x, fused, errs, phase, amp_scale="event"):
    """The fused kernel against its plain twin on ``x``, every slot."""
    n, batch = x.shape[-1], x.shape[0]
    amp_k, chi2_k = fused.kernel(x)
    amp_p, chi2_p = fused.plain(x)
    torch.cuda.synchronize(x.device)
    amp_rel = (rel_err(amp_k, amp_p) if amp_scale == "event" else float(
        (amp_k.double() - amp_p.double()).abs().max()
        / amp_p.double().abs().max()))
    chi2_rel = rel_err(chi2_k, chi2_p)
    amp_abs = float((amp_k.double() - amp_p.double()).abs().max())
    errs["fused_nodelay_of"][0] = max(errs["fused_nodelay_of"][0], amp_abs)
    errs["fused_nodelay_of"][1] = max(errs["fused_nodelay_of"][1], amp_rel)
    log(f"[{phase}] fused_nodelay_of N={n} B={batch} S={fused.nslots}: amp "
        f"max|Δ| {amp_abs:.3e}, rel {amp_rel:.3e} ({amp_scale} scale; tol "
        f"{AMP_RTOL:g}); χ² "
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
    """Each layer of one TriggerStep or GroupStep batch, through the
    step's own ``run_layer`` hook: ({layer: (CUDA-event ms, device ms)},
    device ms of work the profiler ties to no layer). The CUDA events
    bracket each layer with the card synchronised between layers, so they
    include the host's enqueue time; the device ms are the layer's
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
    # each kernel, copy and fill goes to the layer whose range holds the
    # op that launched it or, for the hand-written kernels (launched
    # through ctypes, by no op), the CUDA runtime call that launched it
    cpu = torch.autograd.DeviceType.CPU
    raw = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == cpu]
    ranges = sorted((e.start_ns(), e.end_ns(), e.name()) for e in raw
                    if e.name() in event_ms)
    ops = {e.correlation_id(): e.start_ns() for e in raw
           if e.linked_correlation_id() == 0 and not e.name().startswith("cu")}
    calls = {e.correlation_id(): e.start_ns() for e in raw
             if e.name().startswith("cu")}
    device_ms = dict.fromkeys(event_ms, 0.0)
    total = 0.0
    for _, _, dur, linked, own in device_events(prof):
        total += dur / 1e6
        t = ops.get(linked) if linked else calls.get(own)
        layer = next((name for a, b, name in ranges
                      if t is not None and a <= t <= b), None)
        if layer is not None:
            device_ms[layer] += dur / 1e6
    untied = max(0.0, total - sum(device_ms.values()))
    return {k: (event_ms[k], device_ms[k]) for k in event_ms}, untied


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

    layers, untied = trigger_layer_times(steps["residual"], batches[0].x)
    total = max(sum(v[1] for v in layers.values()), 1e-9)
    log(f"[e] layers of one residual batch ({tentry.TRIGGER_EVENTS} x "
        f"{tentry.TRIGGER_L}, on {card}), CUDA-event ms / device ms "
        "(share of device ms): "
        + "; ".join(f"{k} {ev:.3f} / {dv:.3f} ms ({100 * dv / total:.1f}%)"
                    for k, (ev, dv) in layers.items())
        + f"; not tied to a layer {untied:.3f} device ms")

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


def device_events(prof):
    """Every kernel, copy and fill of a torch.profiler run as (name, start
    ns, duration ns, correlation id of the op that launched it, its own
    correlation id), read from the profiler's raw results:
    ``prof.events()`` first builds a tree of every op, tens of seconds for
    a call of 10^5 small ops."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.duration_ns(),
             e.linked_correlation_id(), e.correlation_id())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.is_user_annotation()]


def device_intervals(prof):
    """(union of device busy intervals, kernel sum, copy sum), each in ms,
    of a torch.profiler run: kernels and copies on different streams
    overlap, so the union is the device's busy time."""
    spans, kern, copy = [], 0.0, 0.0
    for name, start, dur, _, _ in device_events(prof):
        spans.append((start, start + dur))
        if name.startswith("Memcpy"):
            copy += dur / 1e6
        else:
            kern += dur / 1e6
    busy, end = 0, -1
    for a, b in sorted(spans):              # ns
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6, kern, copy


def run_shell(shell, what, card, phase="g", **kw):
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
    log(f"[{phase}] {what}: {n} events in {sec:.4f} s, {n / sec:.1f} events/s "
        f"end to end (host clock, process() call to returned columns); "
        f"host stages {stages} s; on {card}")
    return table, sec, stages


def shell_physics(table, amps, shifts, phase="g", n=tentry.SHELL_N,
                  per_file=SHELL_EVENTS // SHELL_FILES):
    """Per channel: amplitude bias, χ²/dof, unconstrained t0 within one
    sample of the injected offset, constrained t0 inside its window."""
    ev = (table["dump_number"] - 1) * per_file + table["event_number"] - 1
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
            "chi2_dof": float(np.mean(chi2) / (n - 2)),
            "t0_within_1": float(np.mean(np.abs(t0 - shifts[ev]) <= 1)),
            "t0c_in_window": bool(np.all(np.abs(t0c) <= half))}
        p = out[chan]
        p["pass"] = bool(abs(p["amp_bias"]) < 5e-3
                         and abs(p["chi2_dof"] - 1.0) < 0.05
                         and p["t0_within_1"] > 0.99 and p["t0c_in_window"])
    log(f"[{phase}] physics: {json.dumps(out)}")
    if not all(p["pass"] for p in out.values()):
        raise RuntimeError("shell physics invariants failed")


def check_shell_launches(launches, library, nbatch, what, phase="g"):
    want = {"rfft": SHELL_SPECTRAL * nbatch,
            "fused_nodelay_of": SHELL_SPECTRAL * nbatch, "cufft_rfft": 0}
    log(f"[{phase}] {what} launches: {launches}, library route {library} "
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


def event_of(table, per_file):
    """Each row's event, numbered 0 … in file order (dump, then event)."""
    return ((np.asarray(table["dump_number"]) - 1) * per_file
            + np.asarray(table["event_number"]) - 1)


def tshell_expected(pulses, res):
    """{channel: (indices [E, P], amplitudes [E, P])} of every injected
    pulse, by the channel that carries it."""
    out = {}
    for c, chan in enumerate(tentry.SHELL_CHANNELS):
        at = [pulses["coincident"][:, :, c]]
        amp = [np.full(at[0].shape, tentry.TSHELL_PULSE_SIGMA * res[c])]
        if c == 0:
            at += [pulses["big"], pulses["sat"][:, None]]
            amp += [pulses["big_amp"], np.full((len(pulses["sat"]), 1),
                                               tentry.TSHELL_SAT_PULSE)]
        else:
            at.append(pulses["single"][:, c - 1])
            amp.append(np.full(at[-1].shape, tentry.TSHELL_PULSE_SIGMA
                               * res[c]))
        out[chan] = (np.concatenate(at, axis=1), np.concatenate(amp, axis=1))
    return out


def tshell_found(table, pulses, res, per_file, what="trigger shell"):
    """Every injected pulse but the pairs in its channel's suffixed columns
    (merged rows carry the other channels there) within TRIG_INDEX_TOL
    samples and TRIG_AMP_TOL resolutions: (worst index offset, worst
    amplitude error in resolutions)."""
    ev = event_of(table, per_file)
    nev = pulses["coincident"].shape[0]
    worst_i, worst_a = 0, 0.0
    for c, (chan, (at, amp)) in enumerate(tshell_expected(pulses,
                                                          res).items()):
        idx_col = np.asarray(table[f"trigger_index_{chan}"], np.float64)
        amp_col = np.asarray(table[f"trigger_amplitude_{chan}"], np.float64)
        for e in range(nev):
            rows = np.flatnonzero(ev == e)
            got_i, got_a = idx_col[rows], amp_col[rows]
            for t, a in zip(at[e], amp[e]):
                d = np.abs(got_i - t)
                if np.all(np.isnan(d)):
                    raise RuntimeError(f"{what}: no {chan} trigger in event "
                                       f"{e}")
                k = int(np.nanargmin(d))
                worst_i = max(worst_i, d[k])
                worst_a = max(worst_a, abs(got_a[k] - a) / res[c])
    if worst_i > TRIG_INDEX_TOL or worst_a > TRIG_AMP_TOL:
        raise RuntimeError(f"{what}: injected pulse not recovered (worst "
                           f"index offset {worst_i:g}, amplitude error "
                           f"{worst_a:.3f} σ)")
    return worst_i, worst_a


def check_tshell_pulses(table, pulses, res, per_file):
    """Every injected pulse found (:func:`tshell_found`); each coincident
    group's rows: the group's four triggers on one row, or, where a
    channel triggered once more inside the coincidence window, on no more
    rows than such extra triggers allow (the reference's greedy split of a
    window holding a channel twice). Returns the share of groups that
    ended as one row."""
    worst_i, worst_a = tshell_found(table, pulses, res, per_file)
    ev = event_of(table, per_file)
    nev = pulses["coincident"].shape[0]
    base = np.asarray(table["trigger_index"])
    idx_cols = np.stack([np.asarray(table[f"trigger_index_{c}"], np.float64)
                         for c in tentry.SHELL_CHANNELS])
    # rows whose index lies within two coincidence windows of the group
    window = 2 * int(tentry.TSHELL_COINCIDENT_MSEC * 1e-3 * FS)
    one_row = 0
    for e in range(nev):
        for group in pulses["coincident"][e]:
            t = float(np.mean(group))
            rows = np.flatnonzero((ev == e) & (np.abs(base - t) <= window))
            trig = int(np.isfinite(idx_cols[:, rows]).sum())
            if trig < len(group) or len(rows) > 1 + trig - len(group):
                raise RuntimeError(
                    f"trigger shell: the coincident group at {t:.0f} of "
                    f"event {e} ended as {len(rows)} rows holding {trig} "
                    "triggers")
            one_row += len(rows) == 1
    share = one_row / pulses["coincident"][:, :, 0].size
    log(f"[h] every injected pulse found in its channel's columns (worst "
        f"index offset {worst_i:g} samples, amplitude error {worst_a:.3f} σ);"
        f" {one_row} of {pulses['coincident'][:, :, 0].size} coincident "
        f"groups one row ({100 * share:.2f}%), the others split by an extra "
        "trigger of one channel inside the window")
    return share


def compare_tshell_event(got, ref, threshold, what, phase="h"):
    """One event's rows of the card's trigger table against the float64
    CPU run: the same (channel, index) triggers in every channel's columns
    but for those whose Δχ² is within TRIG_NEAR_THRESHOLD of the
    threshold; on the rows whose primary trigger both have, the same
    suffixed indices and Δχ² and amplitudes within TRIG_RTOL."""
    def triggers(t):
        out = {}
        for chan in tentry.SHELL_CHANNELS:
            i = np.asarray(t[f"trigger_index_{chan}"], np.float64)
            d = np.asarray(t[f"trigger_delta_chi2_{chan}"], np.float64)
            for ii, dd in zip(i[np.isfinite(i)], d[np.isfinite(i)]):
                out[(chan, int(ii))] = dd
        return out
    tg, tr = triggers(got), triggers(ref)
    for mine, other, side in ((tg, tr, "card"), (tr, tg, "CPU")):
        for key in set(mine) - set(other):
            if abs(mine[key] - threshold) > TRIG_NEAR_THRESHOLD * threshold:
                raise RuntimeError(f"{what}: trigger {key} (Δχ² "
                                   f"{mine[key]:.6g}) only in the {side} run")
    gk = {(c, int(i)): r for r, (c, i) in enumerate(zip(
        got["trigger_channel"], got["trigger_index"]))}
    pairs = [(gk[(c, int(i))], r) for r, (c, i) in enumerate(zip(
        ref["trigger_channel"], ref["trigger_index"])) if (c, int(i)) in gk]
    g_rows = np.array([p[0] for p in pairs])
    r_rows = np.array([p[1] for p in pairs])
    worst = 0.0
    for col, r in ref.items():
        if not col.startswith("trigger_") or col == "trigger_prod_id":
            continue
        gv, rv = np.asarray(got[col])[g_rows], np.asarray(r)[r_rows]
        if "delta_chi2" in col or "amplitude" in col:
            gv, rv = gv.astype(np.float64), rv.astype(np.float64)
            if not np.array_equal(np.isnan(gv), np.isnan(rv)):
                raise RuntimeError(f"{what}: {col} present on other rows")
            ok = ~np.isnan(rv)
            rel = float(np.max(np.abs(gv[ok] - rv[ok]) / np.abs(rv[ok]),
                               initial=0.0))
            worst = max(worst, rel)
            if not rel <= TRIG_RTOL:
                raise RuntimeError(f"{what}: {col} rel {rel:.3e} above "
                                   f"{TRIG_RTOL:g}")
        elif col.startswith("trigger_index") or col == "trigger_channel":
            same = [a == b or (a != a and b != b) for a, b in zip(gv, rv)]
            if not all(same):
                raise RuntimeError(f"{what}: {col} differs")
    log(f"[{phase}] {what}: {len(ref['trigger_index'])} rows in the CPU run, "
        f"{len(got['trigger_index'])} on the card, {len(pairs)} matched; "
        f"{len(set(tg) ^ set(tr))} triggers near the threshold in one run "
        f"only; Δχ² and amplitudes within {worst:.3e} (tol {TRIG_RTOL:g})")


def run_tshell(shell, what, card, phase="h", **kw):
    """One TriggerProcessing.process() call with a StageTimer: (table,
    seconds, stages)."""
    timer = StageTimer()
    t = time.perf_counter()
    table = shell.process(timer=timer, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    stages = {k: round(v["seconds"], 4)
              for k, v in timer.report(log=False).items()}
    nev = shell.stats["events"]
    msps = nev * tentry.TRIGGER_L / sec / 1e6
    nchan = len(tentry.SHELL_CHANNELS)
    log(f"[{phase}] {what}: {nev} continuous events in {sec:.4f} s, "
        f"{nev / sec:.3f} events/s, {msps:.3f} Msamples/s a channel, "
        f"{nchan * msps:.3f} Msamples/s over all {nchan} channels (host "
        f"clock, process() call to returned table); "
        f"{len(table.get('trigger_index', ()))} rows; host stages {stages} "
        f"s; on {card}")
    return table, sec, stages


def tshell_batch_parts(shell, index, device, card, merge_window):
    """Host ms of each part of one batch of the shell's process() loop,
    done by hand on its first batch with the card synchronised after each
    part (so a part's device work counts where it was enqueued): the fill
    of the pinned buffer, upload and conversion, each channel's step, the
    packing and its copy, the host sets and the drain. Second of two
    rounds."""
    reader = RawReader(index)
    rows = index.order[:TSHELL_BATCH]
    evs = [reader.read_row(int(r), dtype=None, adctoamp=False)
           for r in rows]
    reader.close()
    conv = np.stack([a["adc_conv"] for _, a in evs]).astype(np.float32)
    ring = BufferRing(1, (TSHELL_BATCH,) + evs[0][0].shape,
                      evs[0][0].dtype, pin=torch.device(device).type == "cuda")
    uploader = Uploader(device)
    steps = shell.trigger_steps(TSHELL_CAPACITY)
    host_t, host_a = ring.acquire()
    gather = [torch.as_tensor(tc.chan_indices, device=device)
              for tc in shell.channels]
    admins = [a for _, a in evs]
    for _ in range(2):
        ms = {}

        def part(name, fn):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize(device)
            ms[name] = 1e3 * (time.perf_counter() - t0)
            return out

        def fill():
            for i, (tr, _) in enumerate(evs):
                host_a[i] = tr
        part("fill pinned buffer", fill)
        x, _ = part("upload + convert", lambda: uploader.upload(host_t, conv))
        sets = {}
        for tc, step, g in zip(shell.channels, steps, gather):
            sets[tc.name] = part(f"step {tc.name}",
                                 lambda: step(x.index_select(1, g)))
        packed = part("pack + copy", lambda: triggers._pack_sets(
            sets, torch.float32))
        hsets = part("host sets", lambda: triggers._sets_to_host(packed))
        part("drain", lambda: triggers.drain_batch(
            shell.channels, hsets, admins, tentry.TRIGGER_L, FS,
            triggers.DrainState(), merge_window))
    ring.close()
    total = sum(ms.values())
    log(f"[h] one batch by hand ({TSHELL_BATCH} events; host ms, the card "
        "synchronised after each part): " + "; ".join(
            f"{k} {v:.3f} ({100 * v / total:.1f}%)" for k, v in ms.items())
        + f"; total {total:.3f} ms; on {card}")
    return ms


def phase_h(device, card, errs):
    """The TriggerProcessing shell from flat int16 continuous files, then
    its table through FeatureProcessing; returns each path's launches."""
    tmp = tempfile.mkdtemp(prefix="detprocess_smoke_trigger_")
    try:
        return _phase_h(device, card, errs, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phase_h(device, card, errs, tmp):
    t = time.perf_counter()
    paths, pulses = tentry.write_trigger_dumps(
        tmp, torch.Generator().manual_seed(SEED), TSHELL_EVENTS,
        TSHELL_FILES, device)
    nbytes = sum(os.path.getsize(p) for p in paths)
    log(f"[h] wrote {TSHELL_EVENTS} continuous events of "
        f"{len(tentry.SHELL_CHANNELS)} x {tentry.TRIGGER_L} int16 samples, "
        f"{nbytes / 2**20:.1f} MiB, in {TSHELL_FILES} flat dumps in "
        f"{time.perf_counter() - t:.1f} s (set-up, not timed)")
    per_file = TSHELL_EVENTS // TSHELL_FILES
    index = tentry.trigger_shell_index(paths)
    config = tentry.trigger_shell_config()
    fd = tentry.shell_filter_data(tentry.TRIGGER_NT, tentry.TRIGGER_PRETRIG)
    shell = TriggerProcessing(index, config, fd, verbose=False, device=device)
    kw = dict(event_batch=TSHELL_BATCH, capacity=TSHELL_CAPACITY,
              nreaders=TSHELL_READERS)
    nbatch = TSHELL_EVENTS // TSHELL_BATCH
    res = tentry.trigger_shell_resolutions()

    _kernels.reset_launch_counts()
    table, _, _ = run_tshell(shell, "first call", card, **kw)
    launches = _kernels.launch_counts()
    library = _kernels.library_counts()
    want = {"rfft": (len(tentry.SHELL_CHANNELS) + 1) * nbatch,
            "fused_nodelay_of": 0, "cufft_rfft": nbatch}
    log(f"[h] launches: {launches}, library route {library} ({nbatch} "
        "batches; 4 FIR segment transforms and chan1's residual convolution"
        " a batch, chan1's low-pass through cuFFT)")
    if {**launches, **library} != want:
        raise RuntimeError(f"trigger shell: launches {launches}, library "
                           f"{library}, expected {want}")
    st = shell.stats
    want_samples = TSHELL_EVENTS * len(tentry.SHELL_CHANNELS) * tentry.TRIGGER_L
    log(f"[h] upload: {st['upload_bytes']} bytes for {st['upload_samples']} "
        f"samples ({st['upload_bytes'] / st['upload_samples']:g} bytes a "
        "sample)")
    if (st["upload_samples"] != want_samples
            or st["upload_bytes"] != 2 * want_samples):
        raise RuntimeError(f"trigger shell upload not int16: {st}")
    nrow = len(table["trigger_index"])
    for key, v in table.items():
        if len(v) != nrow:
            raise RuntimeError(f"trigger table column {key}: {len(v)} rows")
    for key in ("trigger_delta_chi2", "trigger_amplitude"):
        if not np.isfinite(np.asarray(table[key], np.float64)).all():
            raise RuntimeError(f"trigger table column {key} not finite")
    check_tshell_pulses(table, pulses, res, per_file)

    # chan1's step on the first batch: its large pulses, vetoed from the
    # subtraction, found by the residual pass too
    reader = RawReader(index)
    rows = index.order[:TSHELL_BATCH]
    raw = np.stack([reader.read_row(int(r), dtype=None, adctoamp=False)[0]
                    for r in rows])
    reader.close()
    conv = torch.as_tensor(np.stack([f.conv for f in (
        index.files[int(index.file[r])] for r in rows)]), device=device)
    x = adc_convert(torch.as_tensor(raw, device=device), conv)
    step1 = shell.trigger_steps()[0]
    ts, ts2 = step1(x[:, :1])
    sat_idx = torch.as_tensor(np.concatenate(
        [pulses["big"][:TSHELL_BATCH], pulses["sat"][:TSHELL_BATCH, None]],
        axis=1), device=device)
    for p, t_ in ((1, ts), (2, ts2)):
        d, _, _ = pulse_errors(t_, sat_idx, 0.0, 1.0)
        if int(d.max()) > TRIG_INDEX_TOL:
            raise RuntimeError(f"trigger shell: a vetoed chan1 pulse missing"
                               f" from pass {p} (offset {int(d.max())})")
    log(f"[h] chan1's pulses above its saturation level (two of 1-5 µA and "
        f"one of {tentry.TSHELL_SAT_PULSE:g} A an event) found in both "
        f"passes of the first batch; residual-pass triggers "
        f"{int(ts2.count.sum())} against {int(ts.count.sum())} first-pass")

    # event 1 against the float64 CPU run of the shell
    ref = TriggerProcessing(index.subset(index.order[:1]), config, fd,
                            verbose=False, device="cpu").process(
        event_batch=1, capacity=TSHELL_CAPACITY, dtype=np.float64)
    mine = np.flatnonzero(event_of(table, per_file) == 0)
    got = {k: np.asarray(v)[mine] for k, v in table.items()}
    compare_tshell_event(got, ref, shell.channels[0].chi2_threshold,
                         "event 1 vs the float64 CPU run of the shell")

    _, warm_s, _ = run_tshell(shell, "second call", card, **kw)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, prof_s, _ = run_tshell(shell, "third call, under torch.profiler",
                                  card, **kw)
    busy, kern, copy = device_intervals(prof)
    share = busy / (1e3 * prof_s)
    tshell_batch_parts(shell, index, device, card, int(
        tentry.TSHELL_COINCIDENT_MSEC * FS / 1000))
    log(f"[h] device busy {busy:.3f} ms of the profiled {1e3 * prof_s:.3f} "
        f"ms call ({100 * share:.1f}% busy, {100 * (1 - share):.1f}% idle; "
        f"union of device intervals); kernels {kern:.3f} ms, copies "
        f"{copy:.3f} ms; on {card}")

    # the rFFT kernel against its twin at this path's shapes
    kernel_d, basis_d = step1.device_kernels()
    segs = {"FIR": trigger.fir_segments(x[:, :1], kernel_d).reshape(
        -1, kernel_d.fft_size)}
    spikes = torch.zeros((TSHELL_BATCH, 1, tentry.TRIGGER_L
                          + 2 * tentry.TRIGGER_NT - 1), device=device)
    spikes[:, 0].scatter_(-1, ts.indices.clamp(min=0)
                          + 2 * tentry.TRIGGER_NT - 1, 1.0)
    segs["residual basis"] = trigger.fir_segments(spikes, basis_d.fir).reshape(
        -1, basis_d.fir.fft_size)
    for what, seg in segs.items():
        got_f = cuda_fft.rfft_kernel(seg)
        ref_f = cuda_fft.rfft_plain(seg)
        torch.cuda.synchronize(device)
        dmax = float((got_f - ref_f).abs().max())
        rel = dmax / float(ref_f.abs().max())
        log(f"[h] rfft on the {what} segments [{seg.shape[0]}, "
            f"{seg.shape[1]}]: max|Δ| {dmax:.3e}, max|Δ|/max|ref| {rel:.3e} "
            f"(tol {RFFT_TOL:g})")
        if not rel <= RFFT_TOL:
            raise RuntimeError(f"rfft kernel disagrees on the trigger shell's"
                               f" {what} segments: {rel:.3e}")
        errs["rfft"][0] = max(errs["rfft"][0], dmax)
        errs["rfft"][1] = max(errs["rfft"][1], rel)
    del x, spikes, segs

    # the chain: the card's trigger table into FeatureProcessing
    cfg = tentry.shell_config(tentry.TRIGGER_NT, tentry.TRIGGER_PRETRIG)
    fshell = FeatureProcessing(index, cfg, fd, trigger_table=table,
                               verbose=False, device=device)
    _kernels.reset_launch_counts()
    feats, _, _ = run_shell(fshell, "chain: the trigger table in trigger-"
                            "table mode", card, "h", batch_size=CHAIN_BATCH,
                            nreaders=TSHELL_READERS)
    chain = _kernels.launch_counts()
    nkept = len(feats["event_number"])
    check_shell_launches(chain, _kernels.library_counts(),
                         -(-nkept // CHAIN_BATCH), "chain", "h")
    if nkept != nrow or fshell.stats["dropped"]:
        raise RuntimeError(f"chain: {nkept} of {nrow} trigger rows kept")
    fev = event_of(feats, per_file)
    amp_col = feats["amp_of1x1_unconstrained_chan1"]
    t0_col = np.rint(feats["t0_of1x1_unconstrained_chan1"] * FS)
    rel, t0_ok = [], []
    for e in range(TSHELL_EVENTS):
        for t_, a in zip(list(pulses["big"][e]) + [pulses["sat"][e]],
                         list(pulses["big_amp"][e])
                         + [tentry.TSHELL_SAT_PULSE]):
            r = np.flatnonzero((fev == e) & (np.abs(
                feats["trigger_index"] - t_) <= TRIG_INDEX_TOL))
            if len(r) != 1:
                raise RuntimeError(f"chain: {len(r)} rows at chan1's pulse "
                                   f"{t_} of event {e}")
            rel.append((amp_col[r[0]] - a) / a)
            t0_ok.append(abs(t0_col[r[0]] - (t_ - feats["trigger_index"][
                r[0]])) <= 1)
    bias, within = float(np.mean(rel)), float(np.mean(t0_ok))
    at10, _ = tshell_expected(pulses, res)["chan1"]
    small = []
    for e in range(TSHELL_EVENTS):
        for t_ in at10[e, :pulses["coincident"].shape[1]]:
            r = np.flatnonzero((fev == e) & (np.abs(
                feats["trigger_index"] - t_) <= TRIG_INDEX_TOL))
            small.extend(amp_col[r] / res[0] - tentry.TSHELL_PULSE_SIGMA)
    log(f"[h] chain, chan1's {len(rel)} large pulses: amplitude bias "
        f"{bias:.3e}, t0 within one sample {within:.4f}; its 10σ coincident "
        f"pulses: of1x1 amplitude error mean {np.mean(small):.3f} σ, rms "
        f"{np.std(small):.3f} σ over {len(small)} windows")
    if not (abs(bias) < 5e-3 and within > 0.99):
        raise RuntimeError("chain: chan1's amplitudes or t0 off")
    fstep = fshell.group_steps()[0]
    slot = next(s.slot for s in fstep.specs if s.base == "of1x1_nodelay")
    treader = RawReader(index)
    win = torch.as_tensor(np.stack([
        treader.read_row(int(index.lookup[(int(d) - 1, int(e))]), ["chan1"],
                         (int(i) - tentry.TRIGGER_PRETRIG, tentry.TRIGGER_NT),
                         dtype=np.float32)[0][0]
        for d, e, i in zip(table["dump_number"][:CHAIN_BATCH],
                           table["event_number"][:CHAIN_BATCH],
                           table["trigger_index"][:CHAIN_BATCH])]),
        device=device)
    treader.close()
    # most windows hold a 10σ pulse of another channel, or none: chan1's
    # amplitudes there sit near 0, so their error is taken against the
    # batch's largest
    compare_kernels(win, fstep.nodelay[str(slot)], errs, "h", "batch")
    return {"trigger_shell": launches, "chain": chain}


def coverage_truth_rows(table):
    """Each row's event, numbered 0 … in file order."""
    return event_of(table, COV_EVENTS // COV_FILES)


def coverage_physics(table, truth, n=tentry.SHELL_N,
                     pretrig=tentry.SHELL_PRETRIG):
    """The injected values recovered on all events: the joint fits'
    amplitudes and Δt, the line's frequency and phase, rftau's rise and
    fall times."""
    ev = coverage_truth_rows(table)
    out = {}
    for name, a1, a2, dt in (
            ("of1x2x2", "scintillation_amp_of1x2x2_chan1",
             "evaporation_amp_of1x2x2_chan1", "time_diff_of1x2x2_chan1"),
            ("ofnxmx2", "amp1_ofnxmx2_chan1", "amp2_ofnxmx2_chan1",
             "delta_t_ofnxmx2_chan1")):
        s, e = truth["scint"][ev], truth["evap"][ev]
        dt_err = np.rint(table[dt] * FS) - truth["delay"][ev]
        p = {"scint_bias": float(np.mean((table[a1] - s) / s)),
             "evap_bias": float(np.mean((table[a2] - e) / e)),
             "scint_rms": float(np.std((table[a1] - s) / s)),
             "evap_rms": float(np.std((table[a2] - e) / e)),
             "dt_exact": float(np.mean(dt_err == 0)),
             "dt_within_tol": float(np.mean(np.abs(dt_err) <= COV_DT_TOL)),
             "dt_mean": float(dt_err.mean())}
        p["pass"] = bool(abs(p["scint_bias"]) < COV_BIAS
                         and abs(p["evap_bias"]) < COV_BIAS
                         and p["dt_within_tol"] > 0.99
                         and abs(p["dt_mean"]) < COV_DT_MEAN)
        out[name] = p
    fline = tentry.coverage_line_freq(n, FS)
    f1 = table["psd_peaks_10000_50000_freq_1_chan2"]
    out["psd_peaks"] = {"line_within_a_bin": float(np.mean(
        np.abs(f1 - fline) <= FS / n))}
    out["psd_peaks"]["pass"] = out["psd_peaks"]["line_within_a_bin"] == 1.0
    ph = table["phase_10000_50000_phase_1_chan2"]
    z = np.mean(np.exp(1j * ph))
    k0 = round(fline * n / FS)
    want = tentry.COV_LINE_PHASE - np.pi / 2 + 2 * np.pi * k0 * pretrig / n
    off = float(np.angle(z * np.exp(-1j * want)))
    out["phase"] = {"circular_std": float(np.sqrt(-2 * np.log(abs(z)))),
                    "mean_off": off}
    out["phase"]["pass"] = bool(out["phase"]["circular_std"] < COV_PHASE_STD
                                and abs(off) < COV_PHASE_MEAN)
    for j, chan in enumerate(("chan3", "chan4")):
        rise, fall = tentry.COV_RFTAU[j]
        r = float(np.median(table[f"risetime_rftau_{chan}"]))
        f = float(np.median(table[f"falltime_rftau_{chan}"]))
        out[f"rftau_{chan}"] = {"rise_median": r, "fall_median": f,
                                "rise_true": rise, "fall_true": fall}
        out[f"rftau_{chan}"]["pass"] = bool(
            abs(r / rise - 1) < COV_RISE_SHARE
            and abs(f / fall - 1) < COV_FALL_SHARE)
    log(f"[i] physics: {json.dumps(out)}")
    if not all(p["pass"] for p in out.values()):
        raise RuntimeError("coverage physics failed")


def coverage_noiseless_nxm(shell, table, truth, n=tentry.SHELL_N,
                           pretrig=tentry.SHELL_PRETRIG):
    """ofnxm's shared amplitude against its float64 fit of the same events
    without noise (the evaporation pulse that the shared template does not
    model is in both), on the first COV_NOISELESS events: no bias beyond
    COV_BIAS."""
    count = min(COV_NOISELESS, len(table["event_number"]))
    ev = coverage_truth_rows(table)[:count]
    tm = tentry.coverage_templates(n, pretrig, FS)
    idx = np.arange(n)

    def rolled(tmpl, by):
        return tmpl[(idx[None, :] - by[:, None]) % n]

    sh, dl = truth["shift"][ev], truth["delay"][ev]
    raw = np.zeros((len(ev), len(tentry.SHELL_CHANNELS), n))
    raw[:, 0] = (truth["scint"][ev, None] * rolled(tm["scint"], sh)
                 + truth["evap"][ev, None] * rolled(tm["evap"], sh + dl))
    raw[:, 1] = (truth["scint"][ev, None] * rolled(tm["shared"][1], sh)
                 + tentry.COV_LINE_AMP * np.sin(
                     2 * np.pi * tentry.coverage_line_freq(n, FS) * idx / FS
                     + tentry.COV_LINE_PHASE))
    group = shell.plan.groups[0]
    step = GroupStep(group, FS, (n, pretrig), "cpu", torch.float64)
    keep = ("mix", "rfft", "ofnxm:chan1|chan2")
    ref = step(torch.as_tensor(raw), run_layer=lambda name, fn, *a: (
        fn(*a) if name in keep else {}))
    col = "shared_ofnxm_constrained_chan1|chan2"
    a0 = ref[col].numpy()
    rel = (table[col][:count] - a0) / a0
    vs_truth = (table[col][:count] - truth["scint"][ev]) / truth["scint"][ev]
    bias = float(rel.mean())
    log(f"[i] ofnxm: shared amplitude against its noiseless float64 fit on "
        f"{count} events: mean {bias:.3e}, rms {rel.std():.3e} (limit "
        f"{COV_BIAS:g}); against the injected amplitude mean "
        f"{vs_truth.mean():.3e} (the unmodelled evaporation pulse)")
    if not abs(bias) < COV_BIAS:
        raise RuntimeError(f"ofnxm amplitude biased: {bias:.3e}")


def compare_coverage(got, ref, rows, what, n=tentry.SHELL_N):
    """Rows ``rows`` of the card's table against the float64 CPU table
    ``ref``, family by family (COV_RTOL): the joint fits where both chose
    the same delays (the share where they did not within
    COV_DELAY_MISMATCH), the PSD peaks where both found the same bin,
    rftau's times against the float64 run's spread (COV_RFTAU_SPREAD,
    COV_RFTAU_MEDIAN)."""
    g = {k: np.asarray(v, np.float64)[rows] for k, v in got.items()
         if k in ref and np.asarray(ref[k]).dtype.kind == "f"}
    r = {k: np.asarray(ref[k], np.float64) for k in g}
    worst, notes = {}, {}

    def check(key, family, mask=None, tol=None, absolute=None):
        a, b = g[key], r[key]
        if mask is not None:
            a, b = a[mask], b[mask]
        if absolute is not None:
            err = float(np.abs(a - b).max(initial=0.0))
            lim = absolute
        else:
            err = float((np.abs(a - b) / np.abs(b)).max(initial=0.0))
            lim = COV_RTOL[family] if tol is None else tol
        worst[family] = max(worst.get(family, 0.0), err / lim)
        if not err <= lim:
            raise RuntimeError(f"{what}: {key} off by {err:.3e} (limit "
                               f"{lim:g})")

    for dt, amps in (("time_diff_of1x2x2_chan1",
                      ("scintillation_amp_of1x2x2_chan1",
                       "evaporation_amp_of1x2x2_chan1")),
                     ("delta_t_ofnxmx2_chan1",
                      ("amp1_ofnxmx2_chan1", "amp2_ofnxmx2_chan1",
                       "chi2_ofnxmx2_chan1"))):
        same = np.rint(g[dt] * FS) == np.rint(r[dt] * FS)
        notes[dt] = float(1 - same.mean())
        if notes[dt] > COV_DELAY_MISMATCH:
            raise RuntimeError(f"{what}: {dt} differs on {notes[dt]:.3f} of "
                               "the events")
        for key in amps:
            check(key, key.split("_")[0] if key.startswith("chi2")
                  else "amp", same)
    for key in g:
        if key.startswith(("amp_of1x1", "chi2_of1x1", "lowchi2_of1x1",
                           "shared_", "chi2_ofnxm_")):
            check(key, key.split("_")[0] if not key.startswith("shared")
                  else "amp")
        elif key.startswith("t0_"):
            check(key, "t0", absolute=1.0 / FS + 1e-12)
        elif key.startswith("psd_amp") or key.endswith("dc_amp_chan2"):
            check(key, "psd")
    def same_bin(f):                        # float32 and float64 freqs
        return np.rint(g[f] * n / FS) == np.rint(r[f] * n / FS)

    for i in (1, 2, 3):
        f = f"psd_peaks_10000_50000_freq_{i}_chan2"
        same = same_bin(f)
        notes[f] = float(1 - same.mean())
        check(f"psd_peaks_10000_50000_amp_{i}_chan2", "psd", same)
    if not same_bin("phase_10000_50000_freq_1_chan2").all():
        raise RuntimeError(f"{what}: the line's bin differs")
    d = np.angle(np.exp(1j * (g["phase_10000_50000_phase_1_chan2"]
                              - r["phase_10000_50000_phase_1_chan2"])))
    err = float(np.abs(d).max())
    worst["phase"] = err / COV_RTOL["phase"]
    if not err <= COV_RTOL["phase"]:
        raise RuntimeError(f"{what}: phase off by {err:.3e} rad")
    for chan in ("chan3", "chan4"):
        for kind in ("risetime", "falltime"):
            key = f"{kind}_rftau_{chan}"
            spread = float(np.std(r[key]))
            check(key, kind, absolute=COV_RFTAU_SPREAD * spread)
            med = float(np.median(np.abs(g[key] - r[key])))
            if not med <= COV_RFTAU_MEDIAN * spread:
                raise RuntimeError(f"{what}: {key} median difference "
                                   f"{med:.3e}, spread {spread:.3e}")
        check(f"amplitud_rftau_{chan}", "amplitud")
        check(f"chisq_rftau_{chan}", "chisq")
    log(f"[i] {what}: worst error over its limit by family " + "; ".join(
        f"{k} {v:.3f}" for k, v in sorted(worst.items()))
        + "; share of events where the choices differ " + "; ".join(
        f"{k} {v:.4f}" for k, v in sorted(notes.items())))


def phase_i(device, card, errs):
    """Every feature algorithm through FeatureProcessing from flat int16
    files (entry.feature_coverage_entry); returns the kernels' launches
    on its path."""
    tmp = tempfile.mkdtemp(prefix="detprocess_smoke_cov_")
    try:
        return _phase_i(device, card, errs, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phase_i(device, card, errs, tmp):
    t = time.perf_counter()
    shell, index, truth = tentry.feature_coverage_entry(
        device, tmp, nevents=COV_EVENTS, seed=SEED, nfiles=COV_FILES)
    paths = index.paths
    nbytes = sum(os.path.getsize(p) for p in paths)
    log(f"[i] wrote {COV_EVENTS} events, {nbytes / 2**30:.3f} GiB of int16 "
        f"codes, in {COV_FILES} flat dumps in {time.perf_counter() - t:.1f} "
        "s (set-up, not timed)")
    kw = dict(batch_size=COV_BATCH, nreaders=SHELL_READERS)
    nbatch = -(-COV_EVENTS // COV_BATCH)

    _kernels.reset_launch_counts()
    table, _, _ = run_shell(shell, "coverage, first call", card, phase="i",
                            **kw)
    launches, library = _kernels.launch_counts(), _kernels.library_counts()
    want = {"rfft": COV_SPECTRAL * nbatch,
            "fused_nodelay_of": COV_FUSED * nbatch, "cufft_rfft": 0}
    log(f"[i] launches: {launches}, library route {library} ({nbatch} "
        f"batches; expected {want})")
    if {**launches, **library} != want:
        raise RuntimeError(f"coverage launches {launches}, library "
                           f"{library}, expected {want}")
    st = shell.stats
    want_samples = COV_EVENTS * len(tentry.SHELL_CHANNELS) * tentry.SHELL_N
    if (st["upload_samples"] != want_samples
            or st["upload_bytes"] != 2 * want_samples):
        raise RuntimeError(f"coverage upload not int16: {st}")
    feats = [k for k in table if k.endswith(
        ("_chan1", "_chan2", "_chan3", "_chan4", "|chan2"))]
    if len(feats) != COV_COLUMNS:
        raise RuntimeError(f"{len(feats)} feature columns, not "
                           f"{COV_COLUMNS}: {sorted(feats)}")
    for key in feats:
        v = table[key]
        if len(v) != COV_EVENTS or not np.isfinite(v).all():
            raise RuntimeError(f"column {key}: {len(v)} rows or not finite")
    coverage_physics(table, truth)
    coverage_noiseless_nxm(shell, table, truth)

    # events 0–15 of every batch against the float64 CPU run
    pos = np.concatenate([np.arange(b * COV_BATCH, b * COV_BATCH + REF_EVENTS)
                          for b in range(nbatch)])
    rows = index.order[pos]
    t = time.perf_counter()
    ref = FeatureProcessing(index.subset(rows), tentry.coverage_config(),
                            tentry.coverage_filter_data(), verbose=False,
                            device="cpu").process(batch_size=len(rows),
                                                  dtype=np.float64)
    log(f"[i] the float64 CPU run of {len(rows)} events: "
        f"{time.perf_counter() - t:.1f} s")
    for key in ("event_number", "dump_number"):
        if not np.array_equal(ref[key], table[key][pos]):
            raise RuntimeError(f"CPU and card rows differ in {key}")
    compare_coverage(table, ref, pos, f"events 0-{REF_EVENTS - 1} of each "
                     f"of {nbatch} batches vs the float64 CPU run")

    _, warm_s, _ = run_shell(shell, "coverage, second call", card,
                             phase="i", **kw)
    log(f"[i] second call: {COV_EVENTS / warm_s:.1f} rows/s (host clock, "
        f"process() call to returned columns); on {card}")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, prof_s, _ = run_shell(shell, "coverage, under torch.profiler",
                                 card, phase="i", **kw)
    busy, kern, copy = device_intervals(prof)
    share = busy / (1e3 * prof_s)
    log(f"[i] device busy {busy:.3f} ms of the profiled {1e3 * prof_s:.3f} "
        f"ms call ({100 * share:.1f}% busy, {100 * (1 - share):.1f}% idle; "
        f"union of device intervals); kernels {kern:.3f} ms, copies "
        f"{copy:.3f} ms; on {card}")

    # each spec's layer on one batch already on the card
    block = COV_BATCH * len(tentry.SHELL_CHANNELS) * tentry.SHELL_N
    codes = torch.as_tensor(np.fromfile(paths[0], np.int16, block).reshape(
        COV_BATCH, len(tentry.SHELL_CHANNELS), tentry.SHELL_N)).to(device)
    conv = torch.as_tensor(tentry.shell_conv(), dtype=torch.float32,
                           device=device).expand(COV_BATCH, -1)
    x = adc_convert(codes, conv)
    (step,) = shell.group_steps()
    step(x)
    layers, untied = trigger_layer_times(step, x)
    total = sum(v[0] for v in layers.values())
    log(f"[i] layers of one batch of {COV_BATCH} (CUDA-event ms with the "
        f"card synchronised between layers, device ms, device share): "
        + "; ".join(f"{k} {v[0]:.3f} / {v[1]:.3f} / "
                    f"{100 * v[1] / v[0]:.1f}%" for k, v in layers.items())
        + f"; sum {total:.3f} ms, {COV_BATCH / (total / 1e3):.1f} events/s; "
        f"not tied to a layer {untied:.3f} device ms; peak memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB; on "
        f"{card}")
    # the joint scan's least time: u1 and u2 read once an event, and for
    # every (d1, Δ) two FMAs and a compare (5 operations)
    (key,) = [k for k in step.of1x2]
    nd, n = len(step.of1x2[key][1].deltas), tentry.SHELL_N
    ops, nbytes = 5.0 * COV_BATCH * n * nd, 2.0 * COV_BATCH * n * 4
    b_ms = 1e3 * max(ops / F32_PEAK, nbytes / HBM_PEAK)
    scan_ms = layers[f"of1x2x2:{key[1]}"][1]
    log(f"[i] of1x2x2 joint scan over {nd} Δ: bound {b_ms:.4f} ms "
        f"({ops:.4g} operations at {F32_PEAK:g}/s, {nbytes:.4g} bytes at "
        f"{HBM_PEAK:g} B/s), device {scan_ms:.3f} ms, "
        f"{scan_ms / b_ms:.1f}x the bound; on {card}")
    slot = next(s.slot for s in step.specs if s.base == "of1x1_nodelay")
    compare_kernels(x[:, 0].contiguous(), step.nodelay[str(slot)], errs, "i")
    del codes, x
    return launches

def fg_edge_margins(metric_stack, stages, nsigma=2.5):
    """[4, C, B]: each trace's distance from its metric's cut edge, over
    nsigma·std of that metric's kept traces (float64)."""
    out = []
    for metric, mask in zip(metric_stack, stages):
        m = mask.to(metric.dtype)
        cnt = m.sum(dim=-1, keepdim=True)
        mean = (metric * m).sum(dim=-1, keepdim=True) / cnt
        std = torch.sqrt(((metric - mean) ** 2 * m).sum(dim=-1, keepdim=True)
                         / cnt)
        out.append(((metric - mean).abs() - nsigma * std).abs()
                   / (nsigma * std))
    return torch.stack(out)


def fg_compare_masks(card, ref, metrics64, stages64):
    """The card's keep-masks [C, B] against the float64 CPU ones: every
    trace that differs must lie within FG_EDGE_TOL of a cut edge; each is
    named."""
    diff = torch.nonzero(card.cpu() != ref).tolist()
    margins = fg_edge_margins(metrics64, stages64)
    for c, b in diff:
        j = int(margins[:, c, b].argmin())
        m = float(margins[j, c, b])
        log(f"[j] cut mask differs: {tentry.SHELL_CHANNELS[c]}, window {b} "
            f"({autocuts.METRICS[j]} within {m:.3e} of its edge; "
            f"{'kept' if bool(ref[c, b]) else 'cut'} in float64)")
        if not m <= FG_EDGE_TOL:
            raise RuntimeError(f"cut masks differ beyond float32 rounding: "
                               f"{tentry.SHELL_CHANNELS[c]}, window {b}, "
                               f"margin {m:.3e}")
    log(f"[j] cut masks: {len(diff)} of {ref.numel()} (channel, window) "
        f"entries differ from the float64 CPU cuts (limit: within "
        f"{FG_EDGE_TOL:g} of an edge)")


def fg_pulls(est, truth, k, lo, hi):
    """Band pulls (est/truth − 1)·√k over bins [lo, hi): (|mean|·√bins,
    rms)."""
    z = (est[lo:hi] / truth[lo:hi] - 1.0) * np.sqrt(k)
    return float(abs(z.mean()) * np.sqrt(len(z))), float(np.sqrt(
        np.mean(z ** 2)))


def fg_check_truth(fd, chans, n):
    """Each PSD and the chan1|chan2 CSD against the spectra the noise was
    drawn from, within their statistical error on bins [FG_BAND_LO, N/2)."""
    truth = tentry.filtergen_csd(n, FS)
    lo, hi = FG_BAND_LO, n // 2
    out = {}
    for c, chan in enumerate(chans):
        psd, _, md = fd.get_psd(chan, return_metadata=True)
        mean, rms = fg_pulls(np.asarray(psd, np.float64), truth[c, c].real,
                             md["nb_randoms"], lo, hi)
        out[chan] = {"pull_mean_sqrt_bins": mean, "pull_rms": rms}
    csd, _, md = fd.get_csd("|".join(chans), return_metadata=True)
    k = md["nb_randoms"]
    z = ((csd[0, 1, lo:hi] - truth[0, 1, lo:hi])
         * np.sqrt(k / (truth[0, 0, lo:hi].real * truth[1, 1, lo:hi].real)))
    out["chan1|chan2"] = {
        "pull_mean_sqrt_bins": float(abs(z.mean()) * np.sqrt(len(z))),
        "pull_rms": float(np.sqrt(np.mean(np.abs(z) ** 2)))}
    log(f"[j] against the spectra the noise was drawn from, bins {lo}-"
        f"{hi - 1} ({lo * FS / n:.0f} Hz up): {json.dumps(out)} (limits: "
        f"|mean|·√bins < {FG_PULL_MEAN:g}, |rms − 1| < {FG_PULL_RMS:g})")
    for name, p in out.items():
        if not (p["pull_mean_sqrt_bins"] < FG_PULL_MEAN
                and abs(p["pull_rms"] - 1.0) < FG_PULL_RMS):
            raise RuntimeError(f"{name}: the estimate disagrees with the "
                               f"spectrum the noise was drawn from: {p}")


def fg_check_artifacts(table, kept_rows, masks, art, per_file, n, pretrig):
    """Every window that holds an injected pulse (onset at least FG_HOLD
    samples before its end) or glitch is cut in that channel."""
    ev = ((table["dump_number"][kept_rows] - 1) * per_file
          + table["event_number"][kept_rows] - 1)
    start = np.maximum(table["trigger_index"][kept_rows] - pretrig, 0)
    held = {"pulse": 0, "glitch": 0}
    for c, chan in enumerate(tentry.SHELL_CHANNELS):
        for kind, reach in (("pulse", n - FG_HOLD),
                            ("glitch", n - tentry.FG_GLITCH + 1)):
            at = art[kind][ev, c] - start
            inside = (at >= 0) & (at < reach)
            held[kind] += int(inside.sum())
            left = np.flatnonzero(inside & masks[c])
            if len(left):
                raise RuntimeError(f"{chan}: windows {left.tolist()} hold an "
                                   f"injected {kind} and were kept")
    log(f"[j] injected artifacts held by windows: {held} (channel, window) "
        f"pairs, every one cut")


def phase_j(device, card, errs):
    """Filter generation from flat int16 continuous files
    (entry.filter_generation_entry), chained into FeatureProcessing;
    returns the kernels' launches on both paths."""
    tmp = tempfile.mkdtemp(prefix="detprocess_smoke_fg_")
    try:
        return _phase_j(device, card, errs, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phase_j(device, card, errs, tmp):
    t_phase = time.perf_counter()
    t = time.perf_counter()
    proc, index, art = tentry.filter_generation_entry(
        device, tmp, nevents=FG_EVENTS, seed=SEED, length=FG_LENGTH,
        nrandoms=FG_NRANDOMS, n=FG_N, pretrig=FG_PRETRIG, nfiles=FG_FILES)
    nbytes = sum(os.path.getsize(p) for p in index.paths)
    log(f"[j] wrote {FG_EVENTS} continuous events of {FG_LENGTH} samples, "
        f"{nbytes / 2**30:.3f} GiB of int16 codes, in {FG_FILES} flat dumps "
        f"in {time.perf_counter() - t:.1f} s (set-up, not timed)")
    chans = list(tentry.SHELL_CHANNELS)

    _kernels.reset_launch_counts()
    timer = StageTimer()
    t = time.perf_counter()
    fd = proc.process(seed=SEED, timer=timer)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches, library = _kernels.launch_counts(), _kernels.library_counts()
    log(f"[j] first call: {first_s:.4f} s; host stages " + str(
        {k: round(v["seconds"], 4)
         for k, v in timer.report(log=False).items()}) + f" s; on {card}")
    want = {"rfft": FG_SPECTRAL, "fused_nodelay_of": 0, "cufft_rfft": 0}
    log(f"[j] launches: {launches}, library route {library} (expected "
        f"{want})")
    if {**launches, **library} != want:
        raise RuntimeError(f"filter generation launches {launches}, library "
                           f"{library}, expected {want}")
    st = proc.stats
    log(f"[j] windows {st['windows']} ({st['dropped']} dropped), kept "
        f"{st['kept']}, clip passes (std, range, slope, baseline) "
        f"{st['passes']}, offsets {st['offsets']}; upload "
        f"{st['upload_bytes']} bytes for {st['upload_samples']} samples")
    if st["upload_bytes"] != 2 * st["upload_samples"] or not st["windows"]:
        raise RuntimeError(f"filter generation upload not int16: {st}")

    # the timed call, and one under torch.profiler
    timer = StageTimer()
    torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    proc.process(seed=SEED, timer=timer)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    stages = {k: round(v["seconds"], 4)
              for k, v in timer.report(log=False).items()}
    log(f"[j] second call: {warm_s:.4f} s (host clock, process() call to "
        f"returned filter data), {st['windows'] / warm_s:.1f} windows/s; "
        f"host stages {stages} s; peak device memory {peak:.2f} GiB; on "
        f"{card}")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        proc.process(seed=SEED)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t
    busy, kern, copy = device_intervals(prof)
    share = busy / (1e3 * prof_s)
    log(f"[j] device busy {busy:.3f} ms of the profiled {1e3 * prof_s:.3f} "
        f"ms call ({100 * share:.1f}% busy, {100 * (1 - share):.1f}% idle; "
        f"union of device intervals); kernels {kern:.3f} ms, copies "
        f"{copy:.3f} ms; on {card}")

    # the same windows and cuts again, on the card and in float64 on the
    # CPU
    table = Randoms(index, verbose=False, device=device).process(
        nrandoms=FG_NRANDOMS, seed=SEED)
    rows, _, kept_rows = Randoms(index, verbose=False, device="cpu") \
        .window_rows(table, FG_N, FG_PRETRIG)
    x = Randoms(index, verbose=False, device=device).read_random_traces(
        table, FG_N, FG_PRETRIG, channels=chans)
    stages32, _ = autocuts.cut_stages(autocuts.metrics(x))
    card_masks = stages32[-1]
    t = time.perf_counter()
    x64 = Randoms(index, verbose=False, device="cpu").read_random_traces(
        table, FG_N, FG_PRETRIG, channels=chans, dtype=torch.float64)
    metrics64 = autocuts.metrics(x64)
    stages64, _ = autocuts.cut_stages(metrics64)
    fg_compare_masks(card_masks, stages64[-1], metrics64, stages64)
    masks = card_masks.cpu()
    kept = {c: int(masks[i].sum()) for i, c in enumerate(chans)}
    every = masks.all(dim=0)
    kept["|".join(chans)] = int(every.sum())
    if kept != st["kept"]:
        raise RuntimeError(f"process() kept {st['kept']}, the cuts of its "
                           f"windows keep {kept}")
    worst = {}
    for i, chan in enumerate(chans):
        k = torch.nonzero(masks[i]).flatten()
        ref = spectral.welch_psd(x64[k, i], FS).numpy()
        got = fd.get_psd(chan)[0]
        worst[f"psd_{chan}"] = float(np.max(np.abs(got - ref) / ref))
        med = np.median(x64[k, i].numpy(), axis=-1).mean()
        worst[f"offset_{chan}"] = abs(st["offsets"][chan] - med) / abs(med)
    k = torch.nonzero(every).flatten()
    ref = spectral.welch_csd(x64[k], FS).numpy()
    got = fd.get_csd("|".join(chans))[0]
    diag = np.sqrt(np.abs(np.einsum("iik->ik", ref)))
    worst["csd"] = float(np.max(np.abs(got - ref)
                                / (diag[:, None] * diag[None, :])))
    log(f"[j] against the float64 CPU run on the same kept windows "
        f"({time.perf_counter() - t:.1f} s): worst relative error "
        f"{json.dumps(worst)} (limit {FG_RTOL:g}; CSD of √(C_ii·C_jj))")
    bad = {k: v for k, v in worst.items() if not v <= FG_RTOL}
    if bad:
        raise RuntimeError(f"filter generation differs from float64: {bad}")
    fg_check_truth(fd, chans, FG_N)
    fg_check_artifacts(table, kept_rows, masks.numpy(), art,
                       FG_EVENTS // FG_FILES, FG_N, FG_PRETRIG)
    tmpl_err = max(float(np.max(np.abs(fd.get_template(c, tag)[0] - want)))
                   for (c, tag), want in tentry.filtergen_templates(
                       FG_N, FG_PRETRIG, FS).items())
    log(f"[j] templates: max |Δ| {tmpl_err:.3e} from the analytic ones "
        f"(limit {FG_TEMPLATE_TOL:g})")
    if not tmpl_err <= FG_TEMPLATE_TOL:
        raise RuntimeError("generated templates differ from the analytic")

    # the rFFT kernel on the phase's own windows, and its time there
    w = x[:, 0].contiguous()
    del x, x64, metrics64
    compare_rfft(w, errs, "j")
    k_ms, p_ms = time_pair(lambda: cuda_fft.rfft_kernel(w),
                           lambda: cuda_fft.rfft_plain(w))
    b_ms, b_by = bound("rfft", FG_N, w.shape[0])
    log(f"[j] rfft at B={w.shape[0]}, N={FG_N}: kernel {k_ms:.4f} ms, "
        f"cuFFT {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); on {card}")
    del w

    # the chain: the generated filter data into FeatureProcessing on (g)'s
    # events (the compound channel, which filter generation does not
    # make, left out)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    paths, amps, shifts = tentry.write_shell_dumps(
        tmp, gen, FG_CHAIN_EVENTS, 1, device, n=FG_N, pretrig=FG_PRETRIG)
    cfg = tentry.shell_config(FG_N, FG_PRETRIG)
    del cfg["feature"][tentry.SHELL_COMPOUND]
    shell = FeatureProcessing(tentry.shell_index(paths, FG_N, FG_PRETRIG),
                              cfg, fd, verbose=False, device=device)
    _kernels.reset_launch_counts()
    ctable, _, _ = run_shell(shell, "chain, generated filter data", card,
                             phase="j", batch_size=FG_CHAIN_BATCH,
                             nreaders=SHELL_READERS)
    chain = _kernels.launch_counts()
    nbatch = -(-FG_CHAIN_EVENTS // FG_CHAIN_BATCH)
    want = {"rfft": len(chans) * nbatch,
            "fused_nodelay_of": len(chans) * nbatch, "cufft_rfft": 0}
    log(f"[j] chain launches: {chain}, library route "
        f"{_kernels.library_counts()} (expected {want})")
    if {**chain, **_kernels.library_counts()} != want:
        raise RuntimeError(f"chain launches {chain}, expected {want}")
    shell_physics(ctable, amps, shifts, phase="j", n=FG_N,
                  per_file=FG_CHAIN_EVENTS)
    log(f"[j] phase time {time.perf_counter() - t_phase:.1f} s; on {card}")
    return {"filtergen": launches, "filtergen_chain": chain}


def phi_c(x):
    """The standard normal's upper tail, Φc(x)."""
    return 0.5 * math.erfc(x / math.sqrt(2.0))


def salt_match_window(sigma_amp, n_sigma):
    """The salt-to-trigger match window of examples/salting/saltchecks.py:
    5 σ_t of the optimal filter's timing at the threshold amplitude, from
    chan1's template and PSD at Nt."""
    n = tentry.TRIGGER_NT
    tmpl = tentry.shell_templates(n, tentry.TRIGGER_PRETRIG)[0]
    dinv = 1.0 / (n * FS * tentry.shell_psds(n)[0])
    dinv[0] = 0.0
    omega2 = (2.0 * np.pi * np.fft.fftfreq(n, 1.0 / FS)) ** 2
    curv = float(np.sum(omega2 * np.abs(np.fft.fft(tmpl)) ** 2 * dinv))
    sigma_t = 1.0 / (n_sigma * sigma_amp * np.sqrt(curv))
    return int(np.ceil(5.0 * sigma_t * FS))


def channel_triggers(table, chan):
    """The triggers of ``chan`` in a merged trigger table (its suffixed
    columns), as a table of series, event and index ({} without any)."""
    if f"trigger_index_{chan}" not in table:
        return {}
    idx = np.asarray(table[f"trigger_index_{chan}"], np.float64)
    ok = np.isfinite(idx)
    return {"series_number": np.asarray(table["series_number"])[ok],
            "event_number": np.asarray(table["event_number"])[ok],
            "trigger_index": idx[ok].astype(np.int64)}


def compare_salted_runs(dev_t, host_t, thresholds):
    """The device-injector run's triggers against the host-injector run's,
    channel by channel: the same (channel, event, index) triggers but for
    those whose Δχ² lies within SALT_NEAR_THRESHOLD of the threshold, and
    Δχ² and amplitudes within SALT_AMP_RTOL on the others. Returns the
    count of triggers in one run only."""
    def keys(t):
        out = {}
        ev = np.asarray(t["event_number"])
        dump = np.asarray(t["dump_number"])
        for chan in tentry.SHELL_CHANNELS:
            i = np.asarray(t[f"trigger_index_{chan}"], np.float64)
            d = np.asarray(t[f"trigger_delta_chi2_{chan}"], np.float64)
            a = np.asarray(t[f"trigger_amplitude_{chan}"], np.float64)
            for r in np.flatnonzero(np.isfinite(i)):
                out[(chan, int(dump[r]), int(ev[r]), int(i[r]))] = (d[r],
                                                                    a[r])
        return out
    kd, kh = keys(dev_t), keys(host_t)
    only = 0
    for mine, other, side in ((kd, kh, "device"), (kh, kd, "host")):
        for key in set(mine) - set(other):
            thr = thresholds[key[0]]
            if abs(mine[key][0] - thr) > SALT_NEAR_THRESHOLD * thr:
                raise RuntimeError(f"salting: trigger {key} (Δχ² "
                                   f"{mine[key][0]:.6g}) only in the {side}"
                                   "-injector run")
            only += 1
    worst = [0.0, 0.0]
    for key in set(kd) & set(kh):
        for j in range(2):
            worst[j] = max(worst[j], abs(kd[key][j] - kh[key][j])
                           / abs(kh[key][j]))
    log(f"[k] device against host injector: {len(kd)} and {len(kh)} "
        f"triggers over the 4 channels, {len(set(kd) & set(kh))} the same; "
        f"{only} in one run only, each with Δχ² within "
        f"{SALT_NEAR_THRESHOLD:g} of the threshold; Δχ² within "
        f"{worst[0]:.3e}, amplitudes within {worst[1]:.3e} (tol "
        f"{SALT_AMP_RTOL:g})")
    if not max(worst) <= SALT_AMP_RTOL:
        raise RuntimeError(f"salting: device and host runs differ by "
                           f"{max(worst):.3e}")
    return only


def check_salt_efficiency(salts, table, res, what, closed_form=True,
                          phase="k"):
    """salt_efficiency of chan1's salts against chan1's triggers, bin by
    bin against ε(A) = Φc(n − A/σ) + Φc(n + A/σ) (saltchecks.py:204-230):
    |pull| < SALT_MAX_PULL where A/σ is more than SALT_PULL_SKIP from n.
    Returns the efficiency table."""
    chan = tentry.SHELL_CHANNELS[0]
    rows = np.asarray(salts["salt_channel"]).astype(str) == chan
    c1 = {k: np.asarray(v)[rows] for k, v in salts.items()}
    points = np.unique(c1["salt_energy_ev"])
    bins = np.concatenate([points * 0.999, [points[-1] * 1.001]])
    n = tentry.TSHELL_SIGMA
    window = salt_match_window(res[0], n)
    eff = salt_efficiency(c1, channel_triggers(table, chan), window, bins)
    pulls = []
    for i, a in enumerate(tentry.SALT_SIGMAS):
        pred = phi_c(n - a) + phi_c(n + a)
        err = max(eff["efficiency_err"][i] if np.isfinite(
            eff["efficiency_err"][i]) else 0.0,
            np.sqrt(max(pred * (1 - pred), 1e-9) / eff["n_injected"][i]),
            1e-3)
        pulls.append((eff["efficiency"][i] - pred) / err)
        log(f"[{phase}] {what}: A = {a:g} σ: {eff['n_recovered'][i]} of "
            f"{eff['n_injected'][i]} chan1 salts recovered within "
            f"±{window} samples, ε {eff['efficiency'][i]:.4f}, closed form "
            f"{pred:.4f}, pull {pulls[-1]:.2f}")
    off = [abs(p) for p, a in zip(pulls, tentry.SALT_SIGMAS)
           if abs(a - n) > SALT_PULL_SKIP]
    if closed_form and not max(off) < SALT_MAX_PULL:
        raise RuntimeError(f"salting: efficiency off the closed form, "
                           f"|pull| {max(off):.2f}")
    return eff


def check_salt_recovery(salts, feats, res, phase="k"):
    """The no-delay amplitudes at the injected indices, channel by channel
    and bin by bin: unbiased within saltchecks.py's bound (max(4·the
    bias's error, 2 %)) and with a scatter of 0.6–1.4 σ from
    SALT_RECOVERY_MIN σ up."""
    nch = len(tentry.SHELL_CHANNELS)
    worst = {}
    for c, chan in enumerate(tentry.SHELL_CHANNELS):
        inj = np.asarray(salts["salt_amplitude"], np.float64)[c::nch]
        got = np.asarray(feats[f"amp_of1x1_nodelay_{chan}"], np.float64)
        nsig = inj / res[c]
        parts = []
        for a in tentry.SALT_SIGMAS:
            sel = np.isclose(nsig, a, rtol=1e-3)
            ratio = float(np.mean(got[sel] / inj[sel]))
            scat = float(np.std(got[sel] - inj[sel]) / res[c])
            parts.append(f"{a:g}σ {ratio:.4f}/{scat:.3f}")
            if a < SALT_RECOVERY_MIN:
                continue
            bound = max(4 * scat / np.sqrt(sel.sum()) / a, SALT_BIAS_FLOOR)
            if not (abs(ratio - 1) < bound
                    and SALT_SCATTER[0] < scat < SALT_SCATTER[1]):
                raise RuntimeError(f"salting: {chan} at {a:g} σ recovered "
                                   f"{ratio:.4f} of the injected amplitude, "
                                   f"scatter {scat:.3f} σ (bias bound "
                                   f"{bound:.4f})")
            worst[chan] = max(worst.get(chan, 0.0), abs(ratio - 1))
        log(f"[{phase}] {chan}: <recovered/injected>/scatter in σ by bin: "
            + "; ".join(parts))
    log(f"[{phase}] energy recovery from {SALT_RECOVERY_MIN:g} σ up: worst "
        "bias "
        + ", ".join(f"{k} {v:.4f}" for k, v in worst.items())
        + f" (bound max(4·err, {SALT_BIAS_FLOOR:g})), scatter within "
        f"{SALT_SCATTER}")


def salt_injection_ms(injector, x, series, events, chans, starts=None):
    """One batch's ``injector.inject`` into ``x``, the third of three
    rounds: (its CUDA-event ms, the host ms of one separate ``plan`` call,
    the plan)."""
    for _ in range(3):
        with dev.CudaTimer() as t:
            injector.inject(x, series, events, window_starts=starts,
                            channels=chans)
    t0 = time.perf_counter()
    plan = injector.plan(series, events, x.shape[-1], window_starts=starts,
                         channels=chans)
    return t.ms, 1e3 * (time.perf_counter() - t0), plan


def phase_k(device, card, errs):
    """Salting: the trigger shell with the device injector, the host
    injector and unsalted, salt_efficiency against the closed form, then
    the salted feature shell at the injected indices; returns each path's
    launches."""
    tmp = tempfile.mkdtemp(prefix="detprocess_smoke_salting_")
    try:
        return _phase_k(device, card, errs, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phase_k(device, card, errs, tmp):
    t_phase = t = time.perf_counter()
    salting, tshell, fshell, index = tentry.salting_chain_entry(
        device, tmp, nevents=SALT_EVENTS, seed=SEED, length=SALT_LENGTH,
        nsalt=SALT_PER_POINT)
    salts = salting.get_dataframe()
    chans = list(tentry.SHELL_CHANNELS)
    nsalt = len(salts["salt_id"]) // len(chans)
    nbytes = sum(os.path.getsize(p) for p in index.paths)
    log(f"[k] wrote {SALT_EVENTS} noise-only continuous events of "
        f"{len(chans)} x {SALT_LENGTH} int16 samples, {nbytes / 2**20:.1f} "
        f"MiB in one flat dump, and drew {nsalt} salts coincident on the "
        f"{len(chans)} channels ({SALT_PER_POINT} at each of "
        f"{tentry.SALT_SIGMAS} σ) in {time.perf_counter() - t:.1f} s "
        "(set-up, not timed)")
    res = tentry.trigger_shell_resolutions()
    fd = tentry.shell_filter_data(tentry.TRIGGER_NT, tentry.TRIGGER_PRETRIG)
    config = tentry.trigger_shell_config()
    host = TriggerProcessing(index, config, fd, verbose=False, device=device)
    host.set_salting(salting.make_injector(chans))
    plain = TriggerProcessing(index, config, fd, verbose=False,
                              device=device)
    kw = dict(event_batch=TSHELL_BATCH, capacity=TSHELL_CAPACITY)
    nbatch = -(-SALT_EVENTS // TSHELL_BATCH)
    want = {"rfft": (len(chans) + 1) * nbatch, "fused_nodelay_of": 0,
            "cufft_rfft": nbatch}
    runs, launches, stats, secs = {}, {}, {}, {}
    for what, shell in (("device", tshell), ("host", host),
                        ("unsalted", plain)):
        label = what if what == "unsalted" else f"{what} injector"
        _kernels.reset_launch_counts()
        runs[what], _, _ = run_tshell(shell, f"{label}, first call", card,
                                      "k", **kw)
        launches[what] = _kernels.launch_counts()
        library = _kernels.library_counts()
        log(f"[k] {label}: launches {launches[what]}, library route "
            f"{library} ({nbatch} batches)")
        if {**launches[what], **library} != want:
            raise RuntimeError(f"salting, {label}: launches "
                               f"{launches[what]}, library {library}, "
                               f"expected {want}")
        stats[what] = dict(shell.stats)
        _, secs[what], _ = run_tshell(shell, f"{label}, second call", card,
                                      "k", **kw)
    samples = SALT_EVENTS * len(chans) * SALT_LENGTH
    up = {k: v["upload_bytes"] for k, v in stats.items()}
    log(f"[k] upload bytes for {samples} samples: {up}")
    if not (up["device"] == up["unsalted"] == 2 * samples
            and up["host"] == 2 * up["device"]
            and all(v["upload_samples"] == samples for v in stats.values())):
        raise RuntimeError(f"salting: the uploads are off: {stats}")
    log("[k] second call, continuous events/s: " + ", ".join(
        f"{k} {SALT_EVENTS / v:.3f}" for k, v in secs.items())
        + f" (host clock); on {card}")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, prof_s, _ = run_tshell(tshell, "device injector, third call, "
                                  "under torch.profiler", card, "k", **kw)
    busy, kern, copy = device_intervals(prof)
    share = busy / (1e3 * prof_s)
    log(f"[k] device injector: device busy {busy:.3f} ms of the profiled "
        f"{1e3 * prof_s:.3f} ms call ({100 * share:.1f}% busy, "
        f"{100 * (1 - share):.1f}% idle); kernels {kern:.3f} ms, copies "
        f"{copy:.3f} ms; on {card}")

    thresholds = {tc.name: tc.chi2_threshold for tc in tshell.channels}
    compare_salted_runs(runs["device"], runs["host"], thresholds)
    check_salt_efficiency(salts, runs["device"], res, "device injector")
    none = check_salt_efficiency(salts, runs["unsalted"], res,
                                 "unsalted run at the salts' indices",
                                 closed_form=False)
    if none["n_recovered"].sum() > 2:
        raise RuntimeError("salting: the unsalted run triggers at the "
                           "salts' indices")

    # the device injection alone, on one batch of each shell
    injector = salting.make_device_injector(chans, max_salts_per_event=64)
    reader = RawReader(index)
    rows = index.order[:TSHELL_BATCH]
    evs = [reader.read_row(int(r), dtype=None, adctoamp=False)
           for r in rows]
    reader.close()
    x = adc_convert(torch.as_tensor(np.stack([e for e, _ in evs]),
                                    device=device),
                    torch.as_tensor(np.stack([a["adc_conv"] for _, a in evs]),
                                    device=device))
    t_ms, t_host, plan = salt_injection_ms(
        injector, x, [a["series_number"] for _, a in evs],
        [a["event_number"] for _, a in evs], chans)
    t_batch = 1e3 * secs["device"] / nbatch
    truth = tentry.salting_truth_table(salts)
    nrow = len(truth["trigger_index"])
    nfb = -(-nrow // SALT_FEATURE_BATCH)
    fx = torch.zeros((min(nrow, SALT_FEATURE_BATCH), len(chans),
                      tentry.TRIGGER_NT), device=device)
    f_ms, f_host, fplan = salt_injection_ms(
        injector, fx, truth["series_number"][:len(fx)],
        truth["event_number"][:len(fx)], chans,
        truth["trigger_index"][:len(fx)] - tentry.TRIGGER_PRETRIG)

    # the salted windows at the injected indices through FeatureProcessing
    _kernels.reset_launch_counts()
    feats, _, _ = run_shell(fshell, "salted windows at the injected "
                            "indices, first call", card, "k",
                            batch_size=SALT_FEATURE_BATCH)
    flaunch = _kernels.launch_counts()
    flib = _kernels.library_counts()
    fwant = {"rfft": len(chans) * nfb, "fused_nodelay_of": len(chans) * nfb,
             "cufft_rfft": 0}
    log(f"[k] salted feature shell launches: {flaunch}, library route "
        f"{flib} ({nfb} batches)")
    if {**flaunch, **flib} != fwant:
        raise RuntimeError(f"salted feature shell: launches {flaunch}, "
                           f"library {flib}, expected {fwant}")
    fst = fshell.stats
    if (len(feats["event_number"]) != nrow or fst["dropped"]
            or fst["upload_bytes"] != 2 * fst["upload_samples"]):
        raise RuntimeError("salted feature shell: "
                           f"{len(feats['event_number'])} of {nrow} rows, "
                           f"stats {fst}")
    _, fsec, _ = run_shell(fshell, "salted windows, second call", card, "k",
                           batch_size=SALT_FEATURE_BATCH)
    check_salt_recovery(salts, feats, res)
    f_batch = 1e3 * fsec / nfb
    log(f"[k] DeviceInjector.inject, CUDA-event ms a batch (the plan on "
        f"the host, its copy and the add; the host ms of one separate plan "
        f"call in brackets): trigger shell [{len(x)}, "
        f"{len(chans)}, {SALT_LENGTH}] {t_ms:.4f} (plan {t_host:.4f}) ms "
        f"for {int((plan.amp != 0).sum())} salts, "
        f"{100 * t_ms / t_batch:.2f}% of its {t_batch:.3f} ms batch; "
        f"feature shell [{len(fx)}, {len(chans)}, {tentry.TRIGGER_NT}] "
        f"{f_ms:.4f} (plan {f_host:.4f}) ms for "
        f"{int((fplan.amp != 0).sum())} salts, {100 * f_ms / f_batch:.2f}% "
        f"of its {f_batch:.3f} ms batch; on {card}")

    # both kernels against their twins at this path's shapes
    step1 = tshell.trigger_steps()[0]
    kernel_d, _ = step1.device_kernels()
    compare_rfft(trigger.fir_segments(x[:, :1], kernel_d).reshape(
        -1, kernel_d.fft_size), errs, "k")
    fstep = fshell.group_steps()[0]
    slot = next(s.slot for s in fstep.specs if s.base == "of1x1_nodelay")
    treader = RawReader(index)
    wins = []
    for d, e, i in zip(truth["dump_number"][:SALT_FEATURE_BATCH],
                       truth["event_number"][:SALT_FEATURE_BATCH],
                       truth["trigger_index"][:SALT_FEATURE_BATCH]):
        start = int(i) - tentry.TRIGGER_PRETRIG
        w, admin = treader.read_row(int(index.lookup[(int(d) - 1, int(e))]),
                                    [chans[0]], (start, tentry.TRIGGER_NT))
        wins.append(salting.inject_raw_salt(w, admin, [chans[0]],
                                            window_start=start)[0])
    treader.close()
    compare_kernels(torch.as_tensor(np.stack(wins), dtype=torch.float32,
                                    device=device),
                    fstep.nodelay[str(slot)], errs, "k", "batch")
    log(f"[k] phase took {time.perf_counter() - t_phase:.1f} s")
    return {"salting_trigger": launches["device"],
            "salting_trigger_host": launches["host"],
            "salting_trigger_unsalted": launches["unsalted"],
            "salting_feature": flaunch}


def pair_triggers(table, pulses, per_file, nev):
    """For each injected pair, the triggers of its channel within
    MODES_PAIR_HALF samples of its pulses: [E, channels, pairs]."""
    ev = event_of(table, per_file)
    out = np.zeros(pulses["pairs"][:nev].shape[:3], np.int64)
    for k, c in enumerate(tentry.TSHELL_PAIR_CHANNELS):
        chan = tentry.SHELL_CHANNELS[c]
        idx = np.asarray(table[f"trigger_index_{chan}"], np.float64)
        for e in range(nev):
            mine = idx[ev == e]
            for p, (a, b) in enumerate(pulses["pairs"][e, k]):
                out[e, k, p] = np.sum((mine >= a - MODES_PAIR_HALF)
                                      & (mine <= b + MODES_PAIR_HALF))
    return out


def run_tshell_quiet(shell, what, card, **kw):
    """:func:`run_tshell` with the shell's own printing captured: (table,
    seconds, the shell's warnings)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        table, sec, _ = run_tshell(shell, what, card, "l", **kw)
    text = buf.getvalue()
    sys.stdout.write(text)
    return table, sec, [ln for ln in text.splitlines() if "WARNING" in ln]


def phase_l(device, card, errs):
    """The trigger modes: dynamic windows and sub-tile windows through the
    TriggerProcessing shell, and template alignment, on the card; returns
    each path's launches."""
    tmp = tempfile.mkdtemp(prefix="detprocess_smoke_modes_")
    try:
        return _phase_l(device, card, errs, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phase_l(device, card, errs, tmp):
    t_phase = t = time.perf_counter()
    chans = list(tentry.SHELL_CHANNELS)
    paths, pulses = tentry.write_trigger_dumps(
        tmp, torch.Generator().manual_seed(SEED + 1), MODES_EVENTS,
        TSHELL_FILES, device, npairs=MODES_PAIRS)
    nbytes = sum(os.path.getsize(p) for p in paths)
    log(f"[l] wrote {MODES_EVENTS} continuous events of {len(chans)} x "
        f"{tentry.TRIGGER_L} int16 samples, {nbytes / 2**20:.1f} MiB, in "
        f"{TSHELL_FILES} flat dumps, (h)'s pulses and {MODES_PAIRS} pairs "
        f"of {tentry.TSHELL_PAIR_SIGMA:g}σ pulses {tentry.TSHELL_PAIR_SEP} "
        f"samples apart on chan2 an event, in "
        f"{time.perf_counter() - t:.1f} s (set-up, not timed)")
    per_file = MODES_EVENTS // TSHELL_FILES
    index = tentry.trigger_shell_index(paths)
    fd = tentry.shell_filter_data(tentry.TRIGGER_NT, tentry.TRIGGER_PRETRIG)
    res = tentry.trigger_shell_resolutions()
    config = tentry.trigger_shell_config()
    sub_config = tentry.trigger_shell_config(
        pileup_windows=tentry.TSHELL_SUBTILE_WINDOWS)

    def dynamic_shell(idx, dev_):
        shell = TriggerProcessing(idx, config, fd, verbose=False,
                                  device=dev_)
        for c in chans:
            shell.set_dynamic_threshold(c, tentry.trigger_shell_window_fn)
        return shell

    static = TriggerProcessing(index, config, fd, verbose=False,
                               device=device)
    shells = {"dynamic": dynamic_shell(index, device),
              "subtile": TriggerProcessing(index, sub_config, fd,
                                           verbose=False, device=device)}
    kws = {"dynamic": dict(event_batch=TSHELL_BATCH,
                           capacity=TSHELL_CAPACITY, nreaders=TSHELL_READERS),
           # window 0 makes every above-threshold sample a row: 16 events,
           # a capacity that holds them, and no coincidence merge
           "subtile": dict(event_batch=TSHELL_BATCH, nevents=MODES_SUB_EVENTS,
                           capacity=MODES_SUB_CAPACITY,
                           coincident_window_msec=0.0)}
    nevs = {"dynamic": MODES_EVENTS, "subtile": MODES_SUB_EVENTS}

    # (h)'s static windows on these files: each pair gives two rows
    stable, _, warned = run_tshell_quiet(
        static, "(h)'s static windows", card, **kws["dynamic"])
    pairs = {"static": pair_triggers(stable, pulses, per_file, MODES_EVENTS)}

    launches, secs, walks, tables = {}, {}, {}, {}
    for what, shell in shells.items():
        nbatch = -(-nevs[what] // TSHELL_BATCH)
        _kernels.reset_launch_counts()
        trigger.reset_walk_counts()
        tables[what], _, w = run_tshell_quiet(shell, f"{what}, first call",
                                              card, **kws[what])
        launches[what] = _kernels.launch_counts()
        library = _kernels.library_counts()
        walks[what] = trigger.walk_counts()
        warned += w
        want = {"rfft": (len(chans) + 1) * nbatch, "fused_nodelay_of": 0,
                "cufft_rfft": nbatch}
        log(f"[l] {what}: launches {launches[what]}, library route {library}"
            f" ({nbatch} batches); dynamic walk {walks[what]}")
        if {**launches[what], **library} != want:
            raise RuntimeError(f"trigger modes, {what}: launches "
                               f"{launches[what]}, library {library}, "
                               f"expected {want}")
        sub = {k: (v[:nevs[what]] if v is not None else None)
               for k, v in pulses.items()}
        worst_i, worst_a = tshell_found(tables[what], sub, res, per_file,
                                        f"trigger modes, {what}")
        pairs[what] = pair_triggers(tables[what], pulses, per_file,
                                    nevs[what])
        log(f"[l] {what}: every injected 10σ pulse found (worst index "
            f"offset {worst_i:g} samples, amplitude error {worst_a:.3f} σ); "
            f"{len(tables[what]['trigger_index'])} rows")
        _, secs[what], w = run_tshell_quiet(shell, f"{what}, second call",
                                            card, **kws[what])
        warned += w
    if warned:
        raise RuntimeError(f"trigger modes: the shell warned: {warned[:3]}")
    walk = walks["dynamic"]
    log(f"[l] dynamic walk of the first call: {walk['merges']} merges "
        f"(4 channels and chan1's residual pass a batch), {walk['steps']} "
        f"steps ({walk['steps'] / max(walk['merges'], 1):.1f} a merge), "
        f"{walk['syncs']} host reads (one a merge); sub-tile run "
        f"{walks['subtile']}")
    if walk["syncs"] != walk["merges"] or walks["subtile"]["merges"]:
        raise RuntimeError(f"trigger modes: walk counts {walks}")
    log(f"[l] chan2's triggers within {MODES_PAIR_HALF} samples of each "
        "pulse pair: " + ", ".join(f"{k} {np.bincount(v.ravel()).tolist()}"
                               for k, v in pairs.items())
        + " (count of pairs with 0, 1, 2, … triggers)")
    if not ((pairs["static"] == 2).all() and (pairs["dynamic"] == 1).all()
            and (pairs["subtile"] >= 2).all()):
        raise RuntimeError("trigger modes: a pair did not give two rows "
                           "with the static window and one with the "
                           "dynamic window")

    # event 1 against the float64 CPU run of the same configuration
    first = index.subset(index.order[:1])
    refs = {"dynamic": dynamic_shell(first, "cpu"),
            "subtile": TriggerProcessing(first, sub_config, fd,
                                         verbose=False, device="cpu")}
    for what, ref_shell in refs.items():
        kw = {k: v for k, v in kws[what].items()
              if k not in ("nreaders", "nevents")}
        kw["event_batch"] = 1
        ref = ref_shell.process(dtype=np.float64, **kw)
        mine = np.flatnonzero(event_of(tables[what], per_file) == 0)
        got = {k: np.asarray(v)[mine] for k, v in tables[what].items()}
        compare_tshell_event(got, ref, static.channels[0].chi2_threshold,
                             f"{what}: event 1 vs the float64 CPU run", "l")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, prof_s, _ = run_tshell_quiet(shells["dynamic"], "dynamic, third "
                                        "call, under torch.profiler", card,
                                        **kws["dynamic"])
    busy, kern, copy = device_intervals(prof)
    share = busy / (1e3 * prof_s)
    log(f"[l] dynamic: device busy {busy:.3f} ms of the profiled "
        f"{1e3 * prof_s:.3f} ms call ({100 * share:.1f}% busy, "
        f"{100 * (1 - share):.1f}% idle); kernels {kern:.3f} ms, copies "
        f"{copy:.3f} ms; on {card}")
    log("[l] second call, continuous events/s: " + ", ".join(
        f"{k} {nevs[k] / v:.3f} ({nevs[k]} events)" for k, v in secs.items())
        + f" (host clock); on {card}")

    # one batch's merges by layer: the dynamic step beside (h)'s tiled one
    reader = RawReader(index)
    rows = index.order[:TSHELL_BATCH]
    evs = [reader.read_row(int(r), dtype=None, adctoamp=False)
           for r in rows]
    reader.close()
    x = adc_convert(torch.as_tensor(np.stack([e for e, _ in evs]),
                                    device=device),
                    torch.as_tensor(np.stack([a["adc_conv"] for _, a in evs]),
                                    device=device))
    merges = {}
    for what, shell in (("dynamic", shells["dynamic"]), ("tiled", static)):
        step = shell.trigger_steps(TSHELL_CAPACITY)[0]
        layers, _ = trigger_layer_times(step, x[:, :1])
        merges[what] = {k: layers[k] for k in ("tiled merge", "second merge")}
    log(f"[l] chan1's merges on one batch [{TSHELL_BATCH}, 1, "
        f"{tentry.TRIGGER_L}], (CUDA-event ms, device ms): dynamic "
        f"{merges['dynamic']}, (h)'s tiled {merges['tiled']}; on {card}")
    step = shells["dynamic"].trigger_steps(TSHELL_CAPACITY)[0]
    kernel_d, _ = step.device_kernels()
    compare_rfft(trigger.fir_segments(x[:, :1], kernel_d).reshape(
        -1, kernel_d.fft_size), errs, "l")
    del x

    # template alignment on the card against the float64 CPU run
    tmpl = tentry.shell_templates(tentry.TRIGGER_NT, tentry.TRIGGER_PRETRIG)[0]
    psd, _ = fd.get_psd(chans[0])
    rolled = [np.roll(tmpl, s) for s in MODES_ALIGN_SHIFTS]
    _, card_shifts = trigger.shift_templates_to_match_chi2(
        FS, tmpl, rolled, psd, device=device)
    _, cpu_shifts = trigger.shift_templates_to_match_chi2(
        FS, tmpl, rolled, psd, device="cpu")
    log(f"[l] shift_templates_to_match_chi2 of chan1's template rolled by "
        f"{MODES_ALIGN_SHIFTS}: card {card_shifts.tolist()}, float64 CPU "
        f"{cpu_shifts.tolist()}")
    if not np.array_equal(card_shifts, cpu_shifts):
        raise RuntimeError("template alignment: the card's shifts differ")
    log(f"[l] phase took {time.perf_counter() - t_phase:.1f} s")
    return {"trigger_shell_dynamic": launches["dynamic"],
            "trigger_shell_subtile": launches["subtile"]}


# -- phase (m): the IV/dIdV sweep and the dIdV branch of filter generation --

def sweep_fit_rows(ana):
    """{(row, poles): DIDVFit} of an IVSweepAnalysis's sweep table."""
    out = {}
    for i, fits in enumerate(ana._sweep_df[tentry.CHANNEL]["didv_fits"]):
        for key, fit in (fits or {}).items():
            if key.startswith("fit_"):
                out[(i, fit.poles)] = fit
    return out


def held_params(fit):
    """The parameters of a fit that the data identify: all of them below
    3 poles; A and τ₂ at 3 poles, where the sweep's one-block working
    points leave C → 0 and τ₃ (and τ₁ along with it) free."""
    return fit.params[[0, 4]] if fit.poles == 3 else fit.params


def max_rel(got, ref):
    """max |got − ref| / max |ref| over arrays (NaN where both are)."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = float(np.nanmax(np.abs(ref))) if ref.size else 0.0
    if scale == 0.0:
        return float(np.nanmax(np.abs(got))) if got.size else 0.0
    return float(np.nanmax(np.abs(got - ref)) / scale)


def compare_sweep(card, cpu, ana_card, ana_cpu):
    """The card's sweep table and analysis against the float64 CPU run:
    {what: worst relative difference}; raises past the tolerances."""
    chan = tentry.CHANNEL
    worst = {}
    if list(card["state"]) != list(cpu["state"]):
        raise RuntimeError("sweep: the state tags differ from the CPU run")
    ib_c, ib_r = ana_card.get_ibis(chan), ana_cpu.get_ibis(chan)
    worst["ibis"] = max(max_rel(getattr(ib_c, f), getattr(ib_r, f))
                        for f in ib_r._fields)
    for col in ("offset_noise", "offset_noise_err", "avgtrace_noise",
                "offset_didv", "offset_didv_err", "didv", "didv_weights"):
        worst[col] = max(max_rel(a, b) for a, b in zip(card[col], cpu[col]))
    psd_max, psd_med = [], []
    for a, b in zip(card["psd"], cpu["psd"]):
        rel = np.abs(a[1:] - b[1:]) / b[1:]
        psd_max.append(float(rel.max()))
        psd_med.append(float(np.median(rel)))
    worst["psd"] = max(psd_max)
    fc, fr = sweep_fit_rows(ana_card), sweep_fit_rows(ana_cpu)
    if set(fc) != set(fr):
        raise RuntimeError("sweep: the card and CPU runs fitted other "
                           "points")
    for poles in (1, 2, 3):
        keys = [k for k in fr if k[1] == poles]
        if keys:
            worst[f"fit_{poles}poles"] = max(
                max(max_rel(held_params(fc[k]), held_params(fr[k])),
                    abs(fc[k].cost / fr[k].cost - 1)) for k in keys)
    limits = {"ibis": IV_IBIS_RTOL, "psd": IV_PSD_RTOL,
              **{k: IV_FIT_RTOL for k in worst if k.startswith("fit_")}}
    for key, value in worst.items():
        limit = limits.get(key, IV_DATA_RTOL)
        if not value <= limit:
            raise RuntimeError(f"sweep: {key} differs from the float64 CPU "
                               f"run by {value:.3e} (tolerance {limit:g})")
    return worst, float(np.median(psd_med))


def sweep_physics(table, ana, points, noise):
    """The sweep's physics against the truth it was made from; raises
    unless Rn, Rp and each transition R0 are within 5 %, β within 0.5 and
    the loop gain within 30 % on IV_MIN_GOOD transition points, and σ_E
    is finite and positive on every transition point."""
    chan = tentry.CHANNEL
    ibis = ana.get_ibis(chan)
    df = ana._sweep_df[chan]
    states = np.asarray(df["state"]).astype(str)
    truth = {p["tes_bias"]: p for p in points}
    trans = states == "transition"
    r0_true = np.array([truth[b]["params"].r0 for b in df["tes_bias"]])
    r0_err = np.abs(df["r0"][trans] / r0_true[trans] - 1)
    beta = df["didv_2poles_beta"][trans]
    loop = df["didv_2poles_l"][trans]
    good = (np.abs(beta - tentry.IV_BETA) < 0.5) & (
        np.abs(loop / tentry.IV_LOOPGAIN - 1) < 0.3)
    sigma = df["energy_resolution"][trans]
    log(f"[m] physics: Rn {ibis.rn:.6f} Ω (truth {tentry.IV_RN}), Rp "
        f"{ibis.rp:.6e} Ω (truth {tentry.IV_RP}), ioffset "
        f"{ibis.ioffset:.6e} A (truth {tentry.IV_IOFFSET}); transition R0 "
        f"worst {r0_err.max():.3e} relative; 2-pole β "
        f"[{beta.min():.4f}, {beta.max():.4f}], l [{loop.min():.4f}, "
        f"{loop.max():.4f}] (truth {tentry.IV_BETA}, {tentry.IV_LOOPGAIN}):"
        f" {int(good.sum())} of {int(trans.sum())} points within 0.5 and "
        f"30 %; σ_E [{np.nanmin(sigma):.4e}, {np.nanmax(sigma):.4e}] J; "
        f"Tload {noise['tload']:.5f} K (truth {tentry.IV_TLOAD})")
    if list(states) != [p["state"] for p in points]:
        raise RuntimeError(f"sweep: state tags {list(states)}")
    if not (abs(ibis.rn / tentry.IV_RN - 1) < 0.05
            and abs(ibis.rp / tentry.IV_RP - 1) < 0.05
            and (r0_err < 0.05).all()):
        raise RuntimeError("sweep: Rn, Rp or a transition R0 is off truth")
    if good.sum() < IV_MIN_GOOD:
        raise RuntimeError(f"sweep: β and l near truth on only "
                           f"{int(good.sum())} transition points")
    if not (np.isfinite(sigma).all() and (sigma > 0).all()):
        raise RuntimeError("sweep: σ_E not finite and positive on every "
                           "transition point")


def compare_didv_store(card_fd, cpu_fd):
    """The filter store's didv_results_* against the float64 CPU run:
    {name: worst relative difference} (held parameters of the fits; the
    small-signal values of 2-pole fits, their errors apart)."""
    chan = tentry.CHANNEL
    worst = {}
    for name, (value, _, _) in card_fd.data[chan].items():
        if not name.startswith("didv_results_"):
            continue
        ref = cpu_fd.data[chan][name][0]
        if name.endswith("_fit_default"):
            fit_c = DIDVFit(value["params"], value["cov"], value["cost"],
                            value["poles"])
            fit_r = DIDVFit(ref["params"], ref["cov"], ref["cost"],
                            ref["poles"])
            worst[name] = max(max_rel(held_params(fit_c),
                                      held_params(fit_r)),
                              abs(value["cost"] / ref["cost"] - 1))
        elif "3poles" not in name:
            worst[name] = max(max_rel(value[k], ref[k]) for k in ref
                              if not k.endswith("_err"))
    for name, value in worst.items():
        if not value <= IV_FIT_RTOL:
            raise RuntimeError(f"filter-generation dIdV: {name} differs "
                               f"from the CPU run by {value:.3e}")
    return worst


def phase_m(device, card, errs):
    """The IV/dIdV sweep (entry.ivsweep_entry, run_ivsweep) and the dIdV
    branch of filter generation with FilterBuilder on the card; returns
    each path's launches."""
    tmp = tempfile.mkdtemp(prefix="detprocess_smoke_ivsweep_")
    try:
        return _phase_m(device, card, errs, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phase_m(device, card, errs, tmp):
    t_phase = t = time.perf_counter()
    chan = tentry.CHANNEL
    points = tentry.ivsweep_points()
    sizes = dict(points=points, ntraces=IV_NTRACES, n=IV_N, ndidv=IV_NDIDV,
                 nper=IV_PERIODS)
    sweep_dir = os.path.join(tmp, "sweep")
    proc, bps = tentry.ivsweep_entry(device, sweep_dir, seed=SEED, **sizes)
    nbytes = sum(os.path.getsize(os.path.join(sweep_dir, f))
                 for f in os.listdir(sweep_dir))
    log(f"[m] wrote a sweep of {len(points)} bias points ({chan}: "
        f"{sum(p['state'] == 'normal' for p in points)} normal, "
        f"{sum(p['state'] == 'transition' for p in points)} transition, "
        f"{sum(p['state'] == 'sc' for p in points)} SC), each {IV_NTRACES} "
        f"noise traces of {IV_N} and {IV_NDIDV} dIdV traces of "
        f"{IV_PERIODS} periods, {nbytes / 2**20:.1f} MiB of int16 codes in "
        f"{2 * len(points)} flat dumps, in {time.perf_counter() - t:.1f} s "
        "(set-up, not timed)")

    # the main path, counted
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    timer = StageTimer()
    t = time.perf_counter()
    table, ana, noise = tentry.run_ivsweep(proc, bps, timer=timer)
    run_s = time.perf_counter() - t
    launches, library = _kernels.launch_counts(), _kernels.library_counts()
    stages = {k: v["seconds"] for k, v in timer.report(log=False).items()}
    fit_stages = ("ibis", "didv fits", "noise model", "energy resolution")
    npoints = sum(b.get("noise_files") is not None for b in bps)
    log(f"[m] sweep on the card: {run_s:.3f} s: reads "
        f"{stages.get('read', 0.0):.3f} s, device work (upload, cuts, PSDs, "
        f"offsets, lock-in, results to the host) "
        f"{stages.get('device', 0.0):.3f} s, CPU fits "
        f"{sum(stages.get(k, 0.0) for k in fit_stages):.3f} s ("
        + ", ".join(f"{k} {stages.get(k, 0.0):.3f} s" for k in fit_stages)
        + f"); launches {launches}, library route {library}")
    want = {"rfft": npoints, "fused_nodelay_of": 0, "cufft_rfft": 0}
    if {**launches, **library} != want:
        raise RuntimeError(f"sweep: launches {launches}, library {library},"
                           f" expected {want}")
    sweep_physics(table, ana, points, noise)

    # the same sweep in float64 on the CPU
    t = time.perf_counter()
    cpu_table, cpu_ana, _ = tentry.run_ivsweep(
        IVSweepProcessing(verbose=False, device="cpu"), bps)
    cpu_s = time.perf_counter() - t
    worst, psd_median = compare_sweep(table, cpu_table, ana, cpu_ana)
    log(f"[m] card against the float64 CPU run ({cpu_s:.3f} s): the same "
        f"state tags; worst relative differences " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items())
        + f"; PSD bins k ≥ 1: median {psd_median:.3e}, worst "
        f"{worst['psd']:.3e} (tolerance {IV_PSD_RTOL:g}: the rFFT kernel is "
        f"float32 on traces whose DC level is up to ~650 σ of the noise, "
        f"and its rounding scales with that level)")

    # the card's busy share over the trace work (a second process() call)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        proc.process(chan, bps, sgfreq=tentry.IV_SGFREQ,
                     sgamp=tentry.IV_SGAMP, rsh=tentry.IV_RSH)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t
    busy, kern, copy = device_intervals(prof)
    share = busy / (1e3 * prof_s)
    log(f"[m] process() under torch.profiler: device busy {busy:.3f} ms of "
        f"{1e3 * prof_s:.3f} ms ({100 * share:.1f}% busy, "
        f"{100 * (1 - share):.1f}% idle); kernels {kern:.3f} ms, copies "
        f"{copy:.3f} ms; on {card}")

    # the kernel against its twin and cuFFT on a bias point's noise batch
    host, conv = read_channel(bps[0]["noise_files"], chan,
                              pin=torch.device(device).type == "cuda")
    x = channel_to_device(host, conv, device).float()
    compare_rfft(x, errs, "m")
    k_ms, p_ms = time_pair(lambda: cuda_fft.rfft_kernel(x),
                           lambda: torch.fft.rfft(x, dim=-1))
    b_ms, b_by = bound("rfft", x.shape[-1], x.shape[0])
    log(f"[m] rfft at [{x.shape[0]}, {x.shape[-1]}] (a bias point's noise "
        f"batch): kernel {k_ms:.4f} ms, torch.fft.rfft (cuFFT) {p_ms:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}); on {card}")
    del x

    # the dIdV branch of filter generation, and FilterBuilder, on dIdV
    # series of the sweep's configuration at one operating point
    t = time.perf_counter()
    fg, series, point = tentry.didv_filtergen_entry(
        device, os.path.join(tmp, "didv"), seed=SEED + 1, nseries=FGD_SERIES,
        ndidv=IV_NDIDV, nper=IV_PERIODS)
    log(f"[m] wrote {FGD_SERIES} dIdV series at R0 = {point['params'].r0} Ω"
        f" in {time.perf_counter() - t:.1f} s (set-up, not timed)")
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    fg_timer = StageTimer()
    t = time.perf_counter()
    fd = fg.proces_didv(timer=fg_timer)
    fg_s = time.perf_counter() - t
    fg_launches = _kernels.launch_counts()
    fg_library = _kernels.library_counts()
    log(f"[m] filter generation's dIdV branch: {fg_s:.3f} s (" + ", ".join(
        f"{k} {v['seconds']:.3f} s"
        for k, v in fg_timer.report(log=False).items())
        + f"); launches {fg_launches}, library route {fg_library} (no "
        "kernel is on this path: the lock-in's spectra are float64 "
        "torch.fft, as the JAX branch's are np.fft)")
    if any(fg_launches.values()) or any(fg_library.values()):
        raise RuntimeError("filter-generation dIdV: a counted route ran")
    ssp = fd.get_didv_results(chan, 2, tag="smallsignalparams_default")
    rows = fd.get_didv_dataframe(chan)
    log(f"[m] filter file: {sorted(k for k in fd.data[chan] if 'didv' in k)}"
        f"; combined 2-pole β {ssp['beta']:.4f} ± {ssp['beta_err']:.4f}, "
        f"l {ssp['l']:.4f} ± {ssp['l_err']:.4f}; per series l "
        f"{np.round(rows['l_2poles_fit'], 4).tolist()}")
    if not (abs(ssp["beta"] - tentry.IV_BETA) < 0.5
            and abs(ssp["l"] / tentry.IV_LOOPGAIN - 1) < 0.3
            and len(rows["series_name"]) == FGD_SERIES):
        raise RuntimeError("filter-generation dIdV: β or l off truth")
    iv = tentry.ivsweep_results_of(point)
    cpu_fd = FilterDataProcessing(
        didv_files=series, config=tentry.didv_filtergen_config(iv),
        verbose=False, device="cpu").proces_didv()
    fg_worst = compare_didv_store(fd, cpu_fd)
    log("[m] filter file against the float64 CPU run: " + ", ".join(
        f"{k} {v:.3e}" for k, v in fg_worst.items()))

    fb = FilterBuilder(verbose=False, device=device)
    first = sorted(series)[0]
    fb.didv.process_raw_data(chan, series[first], tentry.IV_SGFREQ,
                             tentry.IV_SGAMP, tentry.IV_RSH)
    fb.didv.dofit(chan, poles=2)
    fb.didv.set_ivsweep_results(chan, iv)
    fb.didv.calc_smallsignal_params(chan, poles=2)
    l_fb = fb.didv.get_smallsignal_params(chan, 2)["l"]
    l_fg = float(rows["l_2poles_fit"][0])
    log(f"[m] FilterBuilder on series {first}: l {l_fb:.6f} (the filter "
        f"file's row: {l_fg:.6f}); one store under Noise, Template and "
        f"DIDVAnalysis: {fb.didv._filter_data is fb.noise._filter_data}")
    if not (abs(l_fb / l_fg - 1) < IV_DATA_RTOL
            and fb.didv._filter_data is fb.template._filter_data):
        raise RuntimeError("FilterBuilder: differs from the filter file")
    log(f"[m] phase took {time.perf_counter() - t_phase:.1f} s (the sweep "
        f"{run_s:.1f} s on the card, its float64 CPU run {cpu_s:.1f} s)")
    return {"ivsweep": launches, "filtergen_didv": fg_launches}


def cli_table(directory, prefix):
    """The table of the dumps ``{prefix}_{CLI_OUT_SERIES}_F0001.npz``, …
    of an output directory of the command line (every .npz there), and
    their names."""
    files = sorted(f for f in os.listdir(directory) if f.endswith(".npz"))
    want = [f"{prefix}_{tentry.CLI_OUT_SERIES}_F{k:04d}.npz"
            for k in range(1, len(files) + 1)]
    if not files or files != want:
        raise RuntimeError(f"{directory} holds {files}, expected the dumps "
                           f"{prefix}_{tentry.CLI_OUT_SERIES}_F0001.npz, …")
    return files, table_io.concat_tables(
        [table_io.read_table(os.path.join(directory, f)) for f in files])


def compare_tables(got, ref, what, rtol=CLI_FLOAT_RTOL):
    """Two tables with the same columns and rows: integer, boolean and
    string columns exactly (a missing string as None or NaN), float
    columns within ``rtol`` of the reference (NaN where it is NaN).
    Returns the worst relative difference."""
    if list(got) != list(ref):
        raise RuntimeError(f"{what}: columns {list(got)} against "
                           f"{list(ref)}")
    worst = 0.0
    for k in ref:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        if a.shape != b.shape:
            raise RuntimeError(f"{what}: column {k} has {a.shape} rows "
                               f"against {b.shape}")
        if b.dtype.kind == "f" or a.dtype.kind == "f":
            a, b = a.astype(np.float64), b.astype(np.float64)
            if not np.array_equal(np.isnan(a), np.isnan(b)):
                raise RuntimeError(f"{what}: column {k} differs in NaN")
            ok = ~np.isnan(b)
            d = np.abs(a[ok] - b[ok])
            scale = np.abs(b[ok])
            rel = float(np.max(d / np.where(scale > 0, scale, 1.0),
                               initial=0.0))
            worst = max(worst, rel)
            if not rel <= rtol:
                raise RuntimeError(f"{what}: column {k} differs by {rel:.3e}"
                                   f" (rtol {rtol:g})")
        elif not np.array_equal(missing_as_none(a), missing_as_none(b)):
            raise RuntimeError(f"{what}: column {k} differs")
    return worst


def missing_as_none(values):
    """An object column with its missing values (None, NaN) as None, as
    a table file gives them back."""
    if values.dtype != object:
        return values
    return np.array([None if v is None or (isinstance(v, float) and v != v)
                     else v for v in values], dtype=object)


def cli_call(argv, what):
    """``cli.main(argv)`` in this process, counted: (return code, host
    seconds, launches, library routes)."""
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    launches, library = _kernels.launch_counts(), _kernels.library_counts()
    log(f"[n] call {what}: rc {rc}, {sec:.3f} s (host clock); launches "
        f"{launches}, library route {library}")
    if rc != 0:
        raise RuntimeError(f"command line, call {what}: rc {rc}")
    return sec, launches, library


def salts_clear_of(salts, art):
    """The salts (every channel's row) whose Nt-sample feature window
    around the injection overlaps none of the raw events' own pulses
    (TRIGGER_NT samples from their onset) and glitches, in any channel
    (the chain's raw group is one dump: event k is art's row k − 1)."""
    nch = len(tentry.SHELL_CHANNELS)
    nt, pre = tentry.TRIGGER_NT, tentry.TRIGGER_PRETRIG
    keep = []
    for i in range(0, len(salts["salt_channel"]), nch):
        ev = int(salts["event_number"][i]) - 1
        s0 = int(salts["trigger_index"][i]) - pre
        hit = (((art["pulse"][ev] < s0 + nt) & (art["pulse"][ev] + nt > s0))
               | ((art["glitch"][ev] < s0 + nt)
                  & (art["glitch"][ev] + tentry.FG_GLITCH > s0)))
        if not hit.any():
            keep.extend(range(i, i + nch))
    return {c: np.asarray(v)[keep] for c, v in salts.items()}


def salts_at_triggers(salts, table, window):
    """The salts of the first channel that a row of ``table`` (same
    series and event, ``trigger_index`` within ``window``) holds: (salt
    rows of every channel of those salts, the matching rows of
    ``table``)."""
    nch = len(tentry.SHELL_CHANNELS)
    first = np.asarray(salts["salt_channel"]).astype(str)[::nch]
    if not (first == tentry.SHELL_CHANNELS[0]).all():
        raise RuntimeError("salting table: not one row a channel in order")
    key = {}
    for r, (sn, ev, ti) in enumerate(zip(table["series_number"],
                                         table["event_number"],
                                         table["trigger_index"])):
        key.setdefault((int(sn), int(ev)), []).append((int(ti), r))
    keep, rows = [], []
    for k in range(len(first)):
        i = k * nch
        cands = key.get((int(salts["series_number"][i]),
                         int(salts["event_number"][i])), [])
        best = min(cands, key=lambda c: abs(c[0] - int(
            salts["trigger_index"][i])), default=None)
        if best is not None and abs(best[0] - int(
                salts["trigger_index"][i])) <= window:
            keep.extend(range(i, i + nch))
            rows.append(best[1])
    return ({c: np.asarray(v)[keep] for c, v in salts.items()},
            {c: np.asarray(v)[rows] for c, v in table.items()})


def phase_n(device, card, errs):
    """The command line (python -m detprocess_tpu_torch.cli) over files:
    filter generation and randoms, salting, trigger and features, the IV
    sweep; each call against the same work through the Python API, the
    second call again as a subprocess; returns each call's launches."""
    tmp = tempfile.mkdtemp(prefix="detprocess_smoke_cli_")
    try:
        return _phase_n(device, card, errs, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phase_n(device, card, errs, tmp):
    t_phase = t = time.perf_counter()
    points = tentry.ivsweep_points()
    chain = tentry.cli_chain_entry(
        device, tmp, nevents=CLI_EVENTS, seed=SEED, length=CLI_LENGTH,
        nrandoms=CLI_NRANDOMS, nsalt=CLI_NSALT, points=points,
        ntraces=IV_NTRACES, n=IV_N, ndidv=IV_NDIDV, nper=IV_PERIODS)
    raw_files = sorted(os.path.join(chain.raw, f)
                       for f in os.listdir(chain.raw) if f.endswith(".bin"))
    nbytes = sum(os.path.getsize(p) for p in raw_files)
    log(f"[n] wrote a flat raw group of {CLI_EVENTS} continuous events "
        f"({nbytes / 2**20:.1f} MiB of int16 codes, "
        f"{[os.path.basename(p) for p in raw_files]} and its manifest), the "
        f"sweep of {len(points)} bias points as a flat group "
        f"({len(os.listdir(chain.sweep))} files) and the JSON setups in "
        f"{time.perf_counter() - t:.1f} s (set-up, not timed)")
    setup = load_yaml(chain.setup)
    index = RawIndex.from_files(raw_files)
    chans = list(tentry.SHELL_CHANNELS)
    secs, api = {}, {}

    # call A: filter generation and randoms
    secs["A"], la, liba = cli_call(chain.a, "A (--calc-filter --enable-rand)")
    want = {"rfft": len(chans), "fused_nodelay_of": 0, "cufft_rfft": 0}
    if {**la, **liba} != want:
        raise RuntimeError(f"call A: launches {la}, library {liba}, "
                           f"expected {want}")
    fd = FilterData(verbose=False).load(chain.filter_file())
    rname, rand_cli = cli_table(os.path.join(chain.out, "randoms"),
                                "rand_randoms")
    t = time.perf_counter()
    fd_api = FilterDataProcessing(raw_path=chain.raw, config=setup,
                                  verbose=False, device=device).process(
        nrandoms=CLI_NRANDOMS, seed=SEED)
    rand_api = Randoms(index, verbose=False, device=device).process(
        nrandoms=CLI_NRANDOMS, seed=SEED)
    torch.cuda.synchronize()
    api["A"] = time.perf_counter() - t
    compare_tables(rand_cli, rand_api, "call A, randoms")
    worst = {}
    for chan in chans:
        got, ref = fd.get_psd(chan)[0], fd_api.get_psd(chan)[0]
        worst[f"psd_{chan}"] = float(np.max(np.abs(got - ref) / ref))
    got = fd.get_csd("|".join(chans))[0]
    ref = fd_api.get_csd("|".join(chans))[0]
    diag = np.sqrt(np.abs(np.einsum("iik->ik", ref)))
    worst["csd"] = float(np.max(np.abs(got - ref)
                                / (diag[:, None] * diag[None, :])))
    for (chan, tag), tmpl in tentry.filtergen_templates(
            tentry.TRIGGER_NT, tentry.TRIGGER_PRETRIG, FS).items():
        worst[f"template_{chan}_{tag}"] = float(np.max(np.abs(
            fd.get_template(chan, tag)[0] - tmpl)))
    log(f"[n] call A wrote {os.path.basename(chain.filter_file())} and "
        f"{rname} ({table_io.table_rows(rand_cli)} randoms, equal to the API "
        f"run's); against FilterDataProcessing.process on the same files: "
        f"{json.dumps(worst)} (PSDs and CSD limit {FG_RTOL:g}, templates "
        f"{FG_TEMPLATE_TOL:g} from the analytic ones)")
    bad = {k: v for k, v in worst.items()
           if not v <= (FG_TEMPLATE_TOL if k.startswith("template")
                        else FG_RTOL)}
    if bad:
        raise RuntimeError(f"call A differs from the API run: {bad}")

    # call B: salting (device injector), trigger and features
    ff = chain.filter_file()
    secs["B"], lb, libb = cli_call(chain.b(ff), "B (--enable-salting "
                                   "--device-salting --enable-trig "
                                   "--enable-feature)")
    prefixes = {"salting": "salting_salting", "trigger": "threshtrig_trigger",
                "feature": "feature_features"}
    names, out_b = {}, {}
    for sub, prefix in prefixes.items():
        names[sub], out_b[sub] = cli_table(os.path.join(chain.out, sub),
                                           prefix)
    log(f"[n] call B wrote {json.dumps(names)}")
    salts, trig, feats = out_b["salting"], out_b["trigger"], out_b["feature"]
    nrow = table_io.table_rows(trig)
    nbt = -(-CLI_EVENTS // TSHELL_BATCH)
    nbf = -(-table_io.table_rows(feats) // CLI_BATCH)
    want = {"rfft": (len(chans) + 1) * nbt + len(chans) * nbf,
            "fused_nodelay_of": len(chans) * nbf, "cufft_rfft": nbt}
    if {**lb, **libb} != want:
        raise RuntimeError(f"call B: launches {lb}, library {libb}, "
                           f"expected {want} ({nbt} trigger batches, {nbf} "
                           "feature batches)")

    t = time.perf_counter()
    sal = Salting(fd, verbose=False)
    overall = setup["salting"]
    salts_api = sal.generate_salt(
        index, chans, energies=overall["energies"], nsalt=overall["nsalt"],
        seed=SEED, energy_norm_ev_per_amp=overall["energy_norm_ev_per_amp"],
        min_separation_msec=overall["min_separation_msec"],
        edge_exclusion_msec=overall["edge_exclusion_msec"])
    inj = sal.make_device_injector(chans, max_salts_per_event=max(
        16, cli.most_salts_per_event(salts_api)))
    tproc = TriggerProcessing(index, setup, fd, verbose=False, device=device)
    tproc.set_salting(inj)
    trig_api = tproc.process(series_name=tentry.CLI_OUT_SERIES)
    fproc = FeatureProcessing(index, setup, fd, trigger_table=trig_api,
                              verbose=False, device=device)
    fproc.set_salting(inj)
    feats_api = fproc.process(batch_size=CLI_BATCH,
                              series_name=tentry.CLI_OUT_SERIES)
    torch.cuda.synchronize()
    api["B"] = time.perf_counter() - t
    worst_b = {"salting": compare_tables(salts, salts_api, "call B, salts"),
               "trigger": compare_tables(trig, trig_api, "call B, triggers"),
               "feature": compare_tables(feats, feats_api,
                                         "call B, features")}
    log(f"[n] call B: {table_io.table_rows(salts)} salt rows, {nrow} trigger "
        f"rows, {table_io.table_rows(feats)} feature rows "
        f"({fproc.stats['dropped']} windows off the trace in the API run);"
        f" each equal to the API run's (worst float difference "
        f"{json.dumps(worst_b)}, rtol {CLI_FLOAT_RTOL:g})")

    # the salts through the command line, as phase (k) checks them: the
    # setup sized each salt in the analytic trigger resolutions, which
    # the PSDs of call A's filter file estimate
    res = tentry.trigger_shell_resolutions()
    res_fd = tentry.trigger_shell_resolutions(filter_data=fd)
    log(f"[n] trigger resolutions from call A's filter file "
        f"{res_fd.tolist()} A, {np.round(res_fd / res - 1, 5).tolist()} "
        f"relative to the analytic {res.tolist()} A that size the salts")
    # the raw events' own pulses and glitches would count as salts found
    # and swamp an amplitude: only the salts clear of them are checked
    clear = salts_clear_of(salts, chain.artifacts)
    log(f"[n] {table_io.table_rows(clear) // len(chans)} of "
        f"{table_io.table_rows(salts) // len(chans)} salts clear of the raw "
        "events' pulses and glitches")
    check_salt_efficiency(clear, trig, res, "command line, device injector",
                          phase="n")
    # the energy scale: of the salts a feature row holds (same series and
    # event, its index within the match window), each channel's no-delay
    # fit at that row against the injected amplitude
    window = salt_match_window(res[0], tentry.TSHELL_SIGMA)
    held, rows = salts_at_triggers(clear, feats, window)
    log(f"[n] {table_io.table_rows(rows)} of "
        f"{table_io.table_rows(clear) // len(chans)} of those salts held by "
        f"a feature row (±{window} samples)")
    check_salt_recovery(held, rows, res, phase="n")

    # call B again, as the real entry point, into a second output base
    out2 = os.path.join(tmp, "out_subprocess")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "detprocess_tpu_torch.cli", *chain.b(ff, out2)],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=CLI_SUBPROCESS_TIMEOUT)
    secs["B, subprocess"] = time.perf_counter() - t
    log(f"[n] call B as `python -m detprocess_tpu_torch.cli`: rc "
        f"{proc.returncode}, {secs['B, subprocess']:.3f} s wall (start-up, "
        "imports and loading the built kernels included)")
    if proc.returncode != 0:
        raise RuntimeError("call B as a subprocess failed:\n"
                           + proc.stdout[-2000:] + proc.stderr[-2000:])
    for sub, prefix in prefixes.items():
        name, table = cli_table(os.path.join(out2, sub), prefix)
        if name != names[sub]:
            raise RuntimeError(f"subprocess files {name}, expected "
                               f"{names[sub]}")
        compare_tables(table, out_b[sub], f"subprocess call B, {sub}")
    log("[n] the subprocess's salting, trigger and feature tables equal the "
        "in-process call's")

    # call C: the IV sweep
    secs["C"], lc, libc = cli_call(chain.c, "C (--enable-ivsweep)")
    want = {"rfft": len(points), "fused_nodelay_of": 0, "cufft_rfft": 0}
    if {**lc, **libc} != want:
        raise RuntimeError(f"call C: launches {lc}, library {libc}, "
                           f"expected {want}")
    sweep_files = os.listdir(os.path.join(chain.out, "ivsweep"))
    if sweep_files != [f"ivsweep_{tentry.CLI_OUT_SERIES}.npz"]:
        raise RuntimeError(f"call C wrote {sweep_files}")
    chan = tentry.CHANNEL
    table = FilterData(verbose=False).load(os.path.join(
        chain.out, "ivsweep", sweep_files[0])).get_ivsweep_data(chan)
    t = time.perf_counter()
    bps = discover_bias_points(chain.sweep, chan)
    table_api = IVSweepProcessing(verbose=False, device=device).process(
        chan, bps, sgfreq=tentry.IV_SGFREQ, sgamp=tentry.IV_SGAMP,
        rsh=tentry.IV_RSH)
    torch.cuda.synchronize()
    api["C"] = time.perf_counter() - t
    if list(table["state"]) != list(table_api["state"]):
        raise RuntimeError("call C: state tags differ from the API run")
    worst_c = {}
    for key, tol in (("offset_noise", IV_DATA_RTOL),
                     ("offset_didv", IV_DATA_RTOL),
                     ("avgtrace_noise", IV_DATA_RTOL),
                     ("didv", IV_DATA_RTOL), ("psd", IV_PSD_RTOL)):
        worst_c[key] = max(max_rel(a, b) for a, b in zip(table[key],
                                                        table_api[key]))
        if not worst_c[key] <= tol:
            raise RuntimeError(f"call C: {key} differs from the API run by "
                               f"{worst_c[key]:.3e} (tol {tol:g})")
    log(f"[n] call C: {table_io.table_rows(table)} bias points, the API "
        f"run's tags; worst relative differences {json.dumps(worst_c)}")

    # both kernels against their twins on call B's shapes
    reader = RawReader(index)
    evs = [reader.read_row(int(r), dtype=None, adctoamp=False)
           for r in index.order[:TSHELL_BATCH]]
    x = adc_convert(torch.as_tensor(np.stack([e for e, _ in evs]),
                                    device=device),
                    torch.as_tensor(np.stack([a["adc_conv"] for _, a in evs]),
                                    device=device))
    inj.inject(x, [a["series_number"] for _, a in evs],
               [a["event_number"] for _, a in evs], channels=chans)
    kernel_d, _ = tproc.trigger_steps()[0].device_kernels()
    compare_rfft(trigger.fir_segments(x[:, :1], kernel_d).reshape(
        -1, kernel_d.fft_size), errs, "n")
    del x
    fstep = fproc.group_steps()[0]
    slot = next(s.slot for s in fstep.specs if s.base == "of1x1_nodelay")
    wins = []
    for r in range(min(CLI_BATCH, nrow)):
        start = int(trig["trigger_index"][r]) - tentry.TRIGGER_PRETRIG
        row = index.lookup[(int(trig["dump_number"][r]) - 1,
                            int(trig["event_number"][r]))]
        if start < 0 or start + tentry.TRIGGER_NT > CLI_LENGTH:
            continue
        w, admin = reader.read_row(int(row), [chans[0]],
                                   (start, tentry.TRIGGER_NT))
        wins.append(sal.inject_raw_salt(w, admin, [chans[0]],
                                        window_start=start)[0])
    reader.close()
    compare_kernels(torch.as_tensor(np.stack(wins), dtype=torch.float32,
                                    device=device),
                    fstep.nodelay[str(slot)], errs, "n", "batch")

    log("[n] host seconds, command line against the API run of the same "
        "work (the difference is the command line's own: start-up, "
        "imports, setup and filter-file reads, npz writes): " + ", ".join(
            f"{k} {secs[k]:.3f} / {api[k]:.3f}" for k in api)
        + f"; B as a subprocess {secs['B, subprocess']:.3f} s; on {card}")
    log(f"[n] phase took {time.perf_counter() - t_phase:.1f} s")
    return {"cli_a": la, "cli_b": lb, "cli_c": lc}


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
    tshell_launches = phase_h(device, card, errs)
    cov_launches = phase_i(device, card, errs)
    fg_launches = phase_j(device, card, errs)
    salt_launches = phase_k(device, card, errs)
    mode_launches = phase_l(device, card, errs)
    sweep_launches = phase_m(device, card, errs)
    cli_launches = phase_n(device, card, errs)
    kernels = []
    for name in _kernels.KERNELS:
        b_ms, b_by = bound(name, N, BATCH)
        per_path = {"feature": launches[name], "trigger": trig_launches[name],
                    "shell": shell_launches[name],
                    **{path: counts[name]
                       for path, counts in tshell_launches.items()},
                    "coverage": cov_launches[name],
                    **{path: counts[name]
                       for path, counts in fg_launches.items()},
                    **{path: counts[name]
                       for path, counts in salt_launches.items()},
                    **{path: counts[name]
                       for path, counts in mode_launches.items()},
                    **{path: counts[name]
                       for path, counts in sweep_launches.items()},
                    **{path: counts[name]
                       for path, counts in cli_launches.items()}}
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
