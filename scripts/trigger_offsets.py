#!/usr/bin/env python3
"""Distribution of the trigger's time and amplitude errors on injected pulses.

    python3 scripts/trigger_offsets.py --device cpu --dtype float64 --batches 8
    python3 scripts/trigger_offsets.py --device cuda --batches 64

In the trigger configuration of ``entry.trigger_entry()`` (two-pole
template, Nt = 4096, flat PSD 4e-18 A²/Hz, window 125, 5σ) the script
makes white noise of ``--events`` events × 1,250,000 samples a batch,
injects one ``--sigma``-resolution pulse at a random index in every
4·Nt-sample slot but the first (so pulses are ≥ 2·Nt apart and clear of
the edges), runs the base-mode ``TriggerStep`` and, for each pulse, takes
the trigger nearest to it. It prints, as one JSON line, the quantiles and
the largest of |trigger index − injected index| and of the amplitude
error in resolutions, the mean and rms of the signed index offset, and
the count of pulses with no trigger at all. On the CPU in float64 this
is the port's reference (its parity with the JAX package is
tests/test_torch_trigger*).
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from detprocess_tpu_torch import entry  # noqa: E402
from detprocess_tpu_torch.pipelines.trigger_step import (  # noqa: E402
    TriggerStep)

QUANTILES = (0.5, 0.9, 0.99, 0.999)


def batch(gen, kernel, tmpl, events, sigma, device, dtype):
    """Noise [E, 1, L] with one pulse in each 4·Nt slot; returns (x,
    indices [E, P], amplitude)."""
    l, nt = entry.TRIGGER_L, kernel.nt
    slot = 4 * nt
    npulse = l // slot - 1                  # slot 0 left empty
    x = torch.randn((events, l), generator=gen, device=device,
                    dtype=dtype) * np.sqrt(entry.TRIGGER_PSD * entry.FS)
    offs = torch.randint(nt, slot - nt, (events, npulse), generator=gen,
                         device=device)
    idx = torch.arange(1, npulse + 1, device=device) * slot + offs
    amp = sigma * float(kernel.resolution[0])
    cols = ((idx - kernel.pretrigger)[..., None]
            + torch.arange(nt, device=device)).reshape(events, -1)
    x.scatter_add_(-1, cols, (amp * tmpl).repeat(events, npulse))
    return x[:, None, :], idx, amp


def nearest(ts, idx):
    """(|offset|, amplitude, signed offset) of the trigger nearest each
    injected pulse; |offset| is the dtype's max where an event has no
    trigger."""
    got = ts.indices[:, None, :]
    dist = torch.where(got >= 0, (got - idx[..., None]).abs(),
                       torch.iinfo(got.dtype).max)
    d, slot = dist.min(dim=-1)
    signed = got.expand_as(dist).gather(-1, slot[..., None])[..., 0] - idx
    return d, ts.amplitudes[:, 0, :].gather(-1, slot), signed


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--events", type=int, default=entry.TRIGGER_EVENTS)
    ap.add_argument("--sigma", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--threads", type=int, default=4,
                    help="CPU threads on --device cpu")
    args = ap.parse_args()
    dtype = getattr(torch, args.dtype)
    device = torch.device(args.device)
    torch.set_num_threads(args.threads)
    kernel, _, template = entry.build_trigger(
        real_dtype=np.float64 if dtype == torch.float64 else np.float32)
    step = TriggerStep(kernel, None, entry.TRIGGER_SIGMA,
                       entry.TRIGGER_WINDOW, device=device, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    tmpl = torch.as_tensor(template, dtype=dtype, device=device)
    res = float(kernel.resolution[0])
    dist, aerr, signed = [], [], []
    for _ in range(args.batches):
        x, idx, amp = batch(gen, kernel, tmpl, args.events, args.sigma,
                            device, dtype)
        ts, _ = step(x)
        d, a, s = nearest(ts, idx)
        dist.append(d.flatten().cpu().numpy())
        aerr.append(((a - amp) / res).flatten().double().cpu().numpy())
        signed.append(s.flatten().cpu().numpy())
    dist, aerr, signed = map(np.concatenate, (dist, aerr, signed))
    found = dist < np.iinfo(dist.dtype).max
    out = {
        "device": str(device), "dtype": args.dtype, "sigma": args.sigma,
        "pulses": int(dist.size), "no_trigger": int((~found).sum()),
        "offset_quantiles": {str(q): float(np.quantile(dist[found], q))
                             for q in QUANTILES},
        "offset_max": int(dist[found].max()),
        "offset_mean_signed": float(signed[found].mean()),
        "offset_rms": float(np.sqrt(np.mean(signed[found] ** 2.0))),
        "offsets_over": {str(t): int((dist[found] > t).sum())
                         for t in (16, 32, 48, 64, 96, 128)},
        "amp_err_quantiles": {str(q): float(np.quantile(np.abs(aerr[found]),
                                                        q))
                              for q in QUANTILES},
        "amp_err_max": float(np.abs(aerr[found]).max()),
        "amp_err_mean": float(aerr[found].mean()),
    }
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
