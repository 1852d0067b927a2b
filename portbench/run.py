"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the repository root on a machine with an NVIDIA GPU. Prints,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``
and, traced, ``breakdown``; last in it ``checks``, each number compared
with its limit, which also end standard error. Exits with another code,
printing no result, without a card, in a process that holds JAX or the
JAX package once the window has closed, or when the program is missing.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]


def finite(x):
    """A JSON number, or null for one that is not finite."""
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    import cell as cellmod
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = cellmod.Cell(bench, args.workload)
    chips = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    def log(msg):
        print(f"portbench: {msg}", file=sys.stderr, flush=True)

    result = cellmod.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T_START, log)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    result["checks"] = {k: {"value": finite(c["value"]),
                            "limit": finite(c["limit"])}
                        for k, c in result["checks"].items()}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
