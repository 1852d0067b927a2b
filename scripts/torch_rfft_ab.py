#!/usr/bin/env python3
"""Time the rFFT kernel against an earlier checkout's and cuFFT, on one card.

    git archive 7e05668 | tar -x -C build/parent      # the block form
    python3 scripts/torch_rfft_ab.py --parent build/parent

The ``detprocess_tpu_torch`` package of ``--parent`` and this checkout's
are imported side by side (``torch_fused_ab.import_tree``), and each
builds its kernels into its own ``build/torch_kernels/`` (the builds run
together). At each shape of ``SHAPES`` (the feature step at B = 8192,
N = 32768 and 16384; the shell's batch; the trigger FIR segments; the
residual basis) the script checks that both trees' ``rfft_kernel`` agree
with ``torch.fft.rfft`` (cuFFT) and with each other within 1e-5 of
max|ref|, times the three in turns (parent, this, cuFFT, cuFFT, this,
parent; CUDA events over at least 10 calls, and over enough calls to move
4 GB at the small shapes), and reads the mean SM clocks per trace of each
phase of this tree's kernel from one launch of ``rfft_phase_clocks`` (and
of the parent's, where it has one).

Prints one line per result and writes them as JSON to ``--out``
(default ``build/rfft_ab.json``).
Needs one CUDA device; imports no JAX.
"""

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from chip_smoke import bound  # noqa: E402
from detprocess_tpu_torch import device as dev  # noqa: E402
from torch_fused_ab import import_tree  # noqa: E402

# (rows, N): feature step, feature step at N/2, the shell's batch, the
# trigger FIR segments, the residual basis
SHAPES = ((8192, 32768), (8192, 16384), (2048, 32768), (816, 16384),
          (416, 32768))
REPS = 10                 # calls a timed run, at least
RUN_BYTES = 4e9           # and enough calls to move this many bytes
TOL = 1e-5                # max|Δ| / max|ref|


def log(msg):
    print(msg, flush=True)


def mean_clocks(cuda_fft, x):
    """{phase: mean SM clocks per trace} from one stamped launch."""
    stamps = cuda_fft.rfft_phase_clocks(x).double().mean(dim=0).tolist()
    return dict(zip(cuda_fft.PHASES, stamps))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "rfft_ab.json")
    args = ap.parse_args()
    parent = args.parent.resolve()
    device = dev.require_cuda()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[device.index]
    log(card)

    trees = {"parent": import_tree(parent, "ops.cuda_fft"),
             "this": import_tree(ROOT, "ops.cuda_fft")}
    with ThreadPoolExecutor(len(trees)) as pool:
        list(pool.map(lambda m: m._kernels.build(), trees.values()))
    for name, m in trees.items():
        for line in m._kernels.build_log().splitlines():
            if "rfft" in line or "registers" in line or "spill" in line:
                log(f"    [{name}] {line.strip()}")

    fns = {"parent": trees["parent"].rfft_kernel,
           "this": trees["this"].rfft_kernel, "cuFFT": torch.fft.rfft}
    gen = torch.Generator(device=device).manual_seed(0)
    results = {"card": card, "parent": str(parent), "shapes": {}}
    for rows, n in SHAPES:
        x = torch.randn((rows, n), generator=gen, device=device)
        out = {k: f(x) for k, f in fns.items()}
        scale = float(out["cuFFT"].abs().max())
        err = {f"{a} vs {b}": float((out[a] - out[b]).abs().max()) / scale
               for a, b in (("parent", "cuFFT"), ("this", "cuFFT"),
                            ("this", "parent"))}
        del out
        log(f"[{rows}, {n}]: max|Δ|/max|ref|: " + ", ".join(
            f"{k} {v:.3e}" for k, v in err.items()) + f" (tol {TOL:g})")
        if not max(err.values()) <= TOL:
            raise RuntimeError(f"the forms disagree at [{rows}, {n}]: {err}")

        row_bytes = 4 * n + 8 * (n // 2 + 1)
        reps = max(REPS, round(RUN_BYTES / (rows * row_bytes)))
        times = {k: [] for k in fns}
        for which in ("parent", "this", "cuFFT", "cuFFT", "this", "parent"):
            f = fns[which]
            f(x)
            with dev.CudaTimer() as t:
                for _ in range(reps):
                    f(x)
            times[which].append(t.ms / reps)
        clocks = {"this": mean_clocks(trees["this"], x)}
        if hasattr(trees["parent"], "rfft_phase_clocks"):
            clocks["parent"] = mean_clocks(trees["parent"], x)
        sm_clock = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        b_ms, _ = bound("rfft", n, rows)
        ms = {k: float(np.mean(v)) for k, v in times.items()}
        results["shapes"][f"{rows}x{n}"] = {
            "ms": ms, "ms_each": times, "reps": reps, "bound_ms": b_ms,
            "max_rel_err": err, "clocks": clocks, "sm_clock": sm_clock}
        for k, v in ms.items():
            log(f"[{rows}, {n}] {k}: {v:.4f} ms ("
                + ", ".join(f"{t:.4f}" for t in times[k])
                + f"), {100 * b_ms / v:.1f}% of the {b_ms:.4f} ms bound "
                f"(on {card})")
        for k, ck in clocks.items():
            total = sum(ck.values())
            log(f"[{rows}, {n}] {k} clocks per trace: " + "; ".join(
                f"{p} {c:.0f} ({100 * c / total:.1f}%)" for p, c in ck.items())
                + f"; total {total:.0f} (SM clock after the run {sm_clock})")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(results, indent=1))
    log(json.dumps({"ok": True, "out": str(args.out)}))


if __name__ == "__main__":
    main()
