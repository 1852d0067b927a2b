"""The readings that a cell's limits are set from, one JSON line a seed:
the program's numbers (one pass over the cell's data, checked as a run
checks its window) and the control's (the reference computed with
bfloat16 storage put in the program's place, on the same sampled
answers, against the float64 reference).

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ...

Runs on the card (the tests call :func:`readings` on the CPU). The
benchmark's own runs never run it.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]


def control_features(cell, codes, device):
    """The control's feature rows of raw codes [R, C, N]."""
    from reference import features
    return features.features(codes, cell.config, cell.traffic, device,
                             precision="bfloat16").values


def control_event(cell, codes, device):
    """The control's triggers and rows of one event's codes [C, L], in
    the form :func:`checks.table_event` gives the program's."""
    from reference import triggers
    found, rows, _ = triggers.event_triggers(codes, cell.config, device,
                                             precision="bfloat16")
    return ({ch: [(t["index"], t["dchi2"], t["amp"]) for t in trig]
             for ch, trig in found.items()}, rows)


def readings(cell, seed, device, tmp):
    """(program's numbers, control's numbers) of one seed."""
    import numpy as np

    import cell as cellmod
    import checks
    import gen
    from shells import Program
    paths = gen.write_dumps(tmp, cell.config, cell.traffic, seed, device)
    program = Program(cell.config, cell.traffic, paths, device)
    table, _ = program.run_pass()
    del program
    mine = cellmod.check(cell, [table], paths, seed, device)
    where = cellmod.file_positions(paths, cell.config)
    rng = np.random.default_rng(seed)
    if cell.traffic["shell"] == "features":
        pairs = cellmod.sample(rng, 1, len(where), cell.traffic["check_rows"])
        codes = gen.read_events(paths, cell.config, [p for _, p in pairs])
        theirs = cellmod.feature_numbers(
            cell, control_features(cell, codes, device), codes, device)
    else:
        pairs = cellmod.sample(rng, 1, len(where),
                               cell.traffic["check_events"])
        parts = []
        for _, pos in pairs:
            codes = gen.read_events(paths, cell.config, [pos])[0]
            found, rows = control_event(cell, codes, device)
            parts.append(cellmod.event_numbers(cell.config, found, rows,
                                               codes, device))
        theirs = checks.combine(parts)
    return mine, theirs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    import cell as cellmod
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = cellmod.Cell(json.load(f), args.workload)
    for seed in args.seeds:
        tmp = tempfile.mkdtemp(prefix="portbench_control_")
        try:
            mine, theirs = readings(cell, seed, torch.device("cuda", 0),
                                    tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": mine, "control": theirs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
