#!/usr/bin/env python3
"""Time the fused no-delay kernel against an earlier checkout's, on one card.

    git archive <commit> | tar -x -C build/parent     # the earlier tree
    python3 scripts/torch_fused_ab.py --parent build/parent

The ``detprocess_tpu_torch`` package of ``--parent`` and this checkout's
are imported side by side, each under its own module objects, and each
builds its kernels into its own ``build/torch_kernels/`` (the builds run
together). At B = 8192 and N = 16384 and 32768 (S = 1, the 1/f bank of
``entry.build_bank``) the script checks that the two trees'
``FusedNodelayOF.kernel`` agree, times them in turns (parent, this, this,
parent; 10 calls each, CUDA events) and reads the mean SM clocks per trace
of each kernel's phases from one launch of its ``phase_clocks``.

A tree without ``phase_clocks`` (the shared-memory form of the port's
first commits, up to 2d3ba50) is stamped from a copy: clock64() stores are
inserted at that form's phase boundaries, which the script finds by their
text, and the copy is built and launched like the parent. Without those
boundaries a tree is timed but not stamped.

Prints one line per result and writes them as JSON to ``--out``
(default ``build/fused_ab.json``).
Needs one CUDA device; imports no JAX.
"""

import argparse
import ctypes
import importlib
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from detprocess_tpu_torch import device as dev  # noqa: E402
from detprocess_tpu_torch.entry import build_bank  # noqa: E402
from detprocess_tpu_torch.ops import filterbank  # noqa: E402

PKG = "detprocess_tpu_torch"
FS = 1.25e6
BATCH = 8192
REPS = 10
HBM_PEAK = 3.35e12
PHASES = ("load", "FFT passes", "untangle and sums", "reduction")

# The shared-memory form's phase boundaries: (its text, the same with a
# stamp). Stamps 0 start, 1 after the load, 2 after the stages, 3 after
# the sums and warp shuffles, 4 after the block reduction and the stores.
STAMPS = [
    ("  const long long b = blockIdx.x;\n",
     "  const long long b = blockIdx.x;\n  DP_STAMP(0)\n"),
    ("  dp::load_packed<LOG2M>(x + b * S::N, s);\n",
     "  dp::load_packed<LOG2M>(x + b * S::N, s);\n  DP_STAMP(1)\n"),
    ("  dp::fft_smem<LOG2M>(s, tw);\n",
     "  dp::fft_smem<LOG2M>(s, tw);\n  DP_STAMP(2)\n"),
    ("  __syncthreads();\n  double* red",
     "  __syncthreads();\n  DP_STAMP(3)\n  double* red"),
    ("    c0_out[b * nslots + sl] = cs;\n  }\n}\n",
     "    c0_out[b * nslots + sl] = cs;\n  }\n  DP_STAMP(4)\n}\n"),
]
STAMP_HEAD = """
__device__ long long* dp_stamps = nullptr;
#define DP_STAMP(i) \\
  if (dp_stamps != nullptr && threadIdx.x == 0) \\
    dp_stamps[blockIdx.x * 5 + (i)] = clock64();
extern "C" int dp_set_stamps(void* p) {
  return (int)cudaMemcpyToSymbol(dp_stamps, &p, sizeof(p));
}
"""


def log(msg):
    print(msg, flush=True)


def import_tree(root, module="ops.cuda_of"):
    """The module ``module`` of the checkout ``root``'s package, imported
    under module objects of its own; ``sys.modules`` is left as it was."""
    def ours():
        return [k for k in sys.modules if k == PKG or k.startswith(PKG + ".")]

    saved = {k: sys.modules.pop(k) for k in ours()}
    sys.path.insert(0, str(root))
    try:
        return importlib.import_module(f"{PKG}.{module}")
    finally:
        sys.path.remove(str(root))
        for k in ours():
            del sys.modules[k]
        sys.modules.update(saved)


def stamped_copy(parent, dest):
    """A copy of ``parent``'s package with the shared-memory form's phase
    stamps inserted, or None if its kernel source lacks those phases."""
    src = (parent / PKG / "csrc" / "fused_nodelay_of.cu").read_text()
    head = '#include "rfft_smem.cuh"\n'
    if any(src.count(a) != 1 for a, _ in STAMPS) or src.count(head) != 1:
        return None
    src = src.replace(head, head + STAMP_HEAD)
    for anchor, stamped in STAMPS:
        src = src.replace(anchor, stamped)
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(parent / PKG, dest / PKG,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dest / PKG / "csrc" / "fused_nodelay_of.cu").write_text(src)
    return dest


def stamped_clocks(cuda_of, fused, x):
    """Mean SM clocks per trace of each phase, from one launch of the
    stamped copy's kernel."""
    lib = cuda_of._kernels.lib()
    lib.dp_set_stamps.argtypes = [ctypes.c_void_p]
    lib.dp_set_stamps.restype = ctypes.c_int
    stamps = torch.zeros(x.shape[0], 5, dtype=torch.int64, device=x.device)
    if lib.dp_set_stamps(stamps.data_ptr()) != 0:
        raise RuntimeError("dp_set_stamps failed")
    fused.kernel(x)
    torch.cuda.synchronize(x.device)
    lib.dp_set_stamps(None)
    return stamps.diff(dim=1).double().mean(dim=0).tolist()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "fused_ab.json")
    args = ap.parse_args()
    parent = args.parent.resolve()
    device = dev.require_cuda()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[device.index]
    log(card)

    trees = {"parent": import_tree(parent), "this": import_tree(ROOT)}
    stamp_tree = None
    if not hasattr(trees["parent"].FusedNodelayOF, "phase_clocks"):
        copy = stamped_copy(parent, ROOT / "build" / "fused_ab_stamped")
        stamp_tree = import_tree(copy) if copy is not None else None
    mods = [*trees.values()] + ([stamp_tree] if stamp_tree else [])
    with ThreadPoolExecutor(len(mods)) as pool:
        list(pool.map(lambda m: m._kernels.build(), mods))
    for name, m in trees.items():
        for line in m._kernels.build_log().splitlines():
            if "fused" in line or "registers" in line or "spill" in line:
                log(f"    [{name}] {line.strip()}")

    gen = torch.Generator(device=device).manual_seed(0)
    results = {"card": card, "batch": BATCH, "parent": str(parent),
               "sizes": {}}
    for n in (16384, 32768):
        bank, template, _ = build_bank(n, n // 2, FS)
        tb = filterbank.bank_to_torch(bank, device, torch.float32)
        fused = {k: m.FusedNodelayOF.from_bank(tb) for k, m in trees.items()}
        tmpl = torch.as_tensor(template, dtype=torch.float32, device=device)
        x = (torch.randn((BATCH, n), generator=gen, device=device) * 1e-8
             + torch.empty(BATCH, 1, device=device).uniform_(
                 1e-6, 3e-6, generator=gen) * tmpl)

        amp = {k: f.kernel(x)[0].double() for k, f in fused.items()}
        amp_plain = fused["this"].plain(x)[0].double()
        rel = {k: float(((a - amp_plain).abs() / amp_plain.abs()).max())
               for k, a in amp.items()}
        log(f"N={n}: amp max rel against the plain twin: "
            + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()))
        if not max(rel.values()) <= 1e-5:
            raise RuntimeError(f"a kernel disagrees at N={n}: {rel}")

        times = {"parent": [], "this": []}
        for which in ("parent", "this", "this", "parent"):
            f = fused[which]
            with dev.CudaTimer() as t:
                for _ in range(REPS):
                    f.kernel(x)
            times[which].append(t.ms / REPS)
        clocks = {"this": fused["this"].phase_clocks(x).double().mean(
            dim=0).tolist()}
        if hasattr(fused["parent"], "phase_clocks"):
            clocks["parent"] = fused["parent"].phase_clocks(x).double().mean(
                dim=0).tolist()
        elif stamp_tree is not None:
            clocks["parent"] = stamped_clocks(
                stamp_tree, stamp_tree.FusedNodelayOF.from_bank(tb), x)
        sm_clock = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        res = {"ms": {k: float(np.mean(v)) for k, v in times.items()},
               "ms_each": times, "sm_clock": sm_clock, "max_rel_amp": rel,
               "clocks": {k: dict(zip(PHASES, v))
                          for k, v in clocks.items()}}
        for tree in ("parent", "this"):
            ms = res["ms"][tree]
            share = BATCH * 4 * n / (ms * 1e-3) / HBM_PEAK
            ck = res["clocks"].get(tree)
            stamps = ("; ".join(f"{k} {v:.0f}" for k, v in ck.items())
                      + f"; total {sum(ck.values()):.0f}" if ck
                      else "not stamped")
            log(f"N={n} {tree}: {ms:.4f} ms ("
                + ", ".join(f"{t:.4f}" for t in times[tree])
                + f"), {100 * share:.1f}% of HBM peak; clocks per trace: "
                f"{stamps} (on {card}, SM clock after the run {sm_clock})")
        results["sizes"][str(n)] = res
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(results, indent=1))
    log(json.dumps({"ok": True, "out": str(args.out)}))


if __name__ == "__main__":
    main()
