#!/usr/bin/env python3
"""Where the FeatureProcessing shell's time goes, by reader count and
batch size.

    python3 scripts/torch_shell_sweep.py                       # on the GPU
    python3 scripts/torch_shell_sweep.py --events 512 --device cpu

The script writes ``--events`` events of ``entry.py``'s 4-channel shell
configuration (N = 32768, int16 codes, 256 KiB an event) into flat dumps
in a temporary directory, then:

- reads: the pread of every event into host buffers by k threads alone
  (no shell), for each k in ``--readers``: GB/s;
- the shell: ``process(dtype=float32)`` for each (batch size, reader
  count), ``--repeats`` times in turns after one call that is not
  counted: events/s from process() call to returned columns, and the
  StageTimer's read/dispatch/drain seconds;
- the group steps alone on one batch already on the device (CUDA events
  on the GPU).

It prints one JSON object and writes it to ``--out`` (default
``build/shell_sweep.json``), and deletes the dumps. Every number
comes with the device's name (and, on the GPU, nvidia-smi's name and
power limit).
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from detprocess_tpu_torch import device as dev  # noqa: E402
from detprocess_tpu_torch import entry  # noqa: E402
from detprocess_tpu_torch.io.fastio import FastReader  # noqa: E402
from detprocess_tpu_torch.ops.adc import adc_convert  # noqa: E402
from detprocess_tpu_torch.pipelines.features import (  # noqa: E402
    FeatureProcessing)
from detprocess_tpu_torch.utils.logging import StageTimer  # noqa: E402


def read_rate(index, k, event_bytes):
    """GB/s of k threads preading every event of ``index`` into buffers
    of their own."""
    rows = np.array_split(index.order, k)
    fast = FastReader()
    bufs = [np.empty((2,) + index.datasets[0].shape, index.datasets[0].dtype)
            for _ in range(k)]

    def work(i):
        for j, r in enumerate(rows[i]):
            fast.read(index.datasets[int(r)], out=bufs[i][j % 2])

    threads = [threading.Thread(target=work, args=(i,)) for i in range(k)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    sec = time.perf_counter() - t
    fast.close()
    return len(index) * event_bytes / sec / 1e9


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--events", type=int, default=8192)
    ap.add_argument("--files", type=int, default=4)
    ap.add_argument("--readers", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--batches", type=int, nargs="+", default=[1024, 2048])
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "shell_sweep.json"))
    args = ap.parse_args()
    device = (dev.require_cuda() if args.device == "cuda"
              else torch.device(args.device))
    on_cuda = device.type == "cuda"
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.strip()
            if on_cuda else f"{device} (no GPU: not a device measurement)")
    tmp = tempfile.mkdtemp(prefix="detprocess_sweep_")
    try:
        gen = torch.Generator(device=device).manual_seed(0)
        paths, _, _ = entry.write_shell_dumps(tmp, gen, args.events,
                                              args.files, device)
        index = entry.shell_index(paths)
        event_bytes = 2 * len(entry.SHELL_CHANNELS) * entry.SHELL_N
        out = {"card": card, "events": args.events,
               "bytes": args.events * event_bytes,
               "read_GBps": {k: read_rate(index, k, event_bytes)
                             for k in args.readers}}
        shell = FeatureProcessing(index, entry.shell_config(),
                                  entry.shell_filter_data(), verbose=False,
                                  device=device)
        cells = [(b, k) for b in args.batches for k in args.readers]
        shell.process(batch_size=cells[0][0], nreaders=cells[0][1])
        runs = {f"batch {b}, readers {k}": [] for b, k in cells}
        for _ in range(args.repeats):
            for b, k in cells:
                timer = StageTimer()
                t = time.perf_counter()
                shell.process(batch_size=b, nreaders=k, timer=timer)
                if on_cuda:
                    torch.cuda.synchronize(device)
                sec = time.perf_counter() - t
                runs[f"batch {b}, readers {k}"].append({
                    "events_per_s": args.events / sec,
                    **{s: v["seconds"] for s, v in
                       timer.report(log=False).items()}})
        out["shell"] = runs
        b = args.batches[-1]
        block = min(b, args.events) * event_bytes // 2
        codes = torch.as_tensor(np.fromfile(paths[0], np.int16, block)
                                .reshape(-1, len(entry.SHELL_CHANNELS),
                                         entry.SHELL_N)).to(device)
        conv = torch.as_tensor(entry.shell_conv(), dtype=torch.float32,
                               device=device).expand(codes.shape[0], -1)
        x = adc_convert(codes, conv)
        steps = shell.group_steps()
        for step in steps:
            step(x)
        t = time.perf_counter()
        if on_cuda:
            with dev.CudaTimer() as tm:
                for step in steps:
                    step(x)
            ms = tm.ms
        else:
            for step in steps:
                step(x)
            ms = 1e3 * (time.perf_counter() - t)
        out["group_steps"] = {"batch": codes.shape[0], "ms": ms,
                              "events_per_s": codes.shape[0] / (ms / 1e3)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = json.dumps(out)
    print(line)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
