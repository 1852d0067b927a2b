"""Multi-node launcher: each node takes its slice of the raw series and runs
the command-line chain on it.

    python -m detprocess_tpu_torch.launch --node_num 0 --nb_nodes 2 \\
        --raw_path ... --processing_setup process.json \\
        --enable-trig --enable-feature

(under SLURM the node defaults come from SLURM_PROCID and SLURM_NTASKS).
The port's counterpart of ``scripts/process_distributed.py``: the node's
series come from ``parallel/multihost.split_series_for_host``, and its
output series is the job's base series plus the node number
(``output_series_num_for_host``), so that nodes never write the same
names. The base is ``DETPROC_TPU_BASE_SERIES`` (one value for the whole
job; its facility digit follows ``--facility``), else this node's clock.
Everything else goes to :func:`detprocess_tpu_torch.cli.main` as given.

Unlike the script, the node arguments are taken out by their exact flags
(``--node_num 1``, ``--node_num=1``; the launcher takes no abbreviations),
so no other argument is stripped with them, and a
``DETPROC_TPU_BASE_SERIES`` that is not a series name is refused by name.
"""

from __future__ import annotations

import os
import re
import sys
from typing import List, Sequence

from detprocess_tpu_torch import cli
from detprocess_tpu_torch.io.rawdata import (RawData, series_number_to_name,
                                             series_to_number)
from detprocess_tpu_torch.parallel import multihost
from detprocess_tpu_torch.utils.misc import create_series_name

BASE_SERIES_ENV = "DETPROC_TPU_BASE_SERIES"
NODE_FLAGS = ("--node_num", "--nb_nodes")
SERIES_NAME_RE = re.compile(r"I\d+_D\d{8}_T\d{6}")


def build_parser():
    parser = cli.build_parser()
    parser.prog = "detprocess-tpu-torch-launch"
    parser.allow_abbrev = False
    parser.add_argument("--node_num", type=int, default=None)
    parser.add_argument("--nb_nodes", type=int, default=None)
    return parser


def strip_node_args(argv: Sequence[str]) -> List[str]:
    """``argv`` without the node flags and their values: ``--node_num N``
    (two tokens) or ``--node_num=N``, matched exactly."""
    out: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in NODE_FLAGS:
            i += 2               # the flag and its value
            continue
        if a.split("=", 1)[0] in NODE_FLAGS and "=" in a:
            i += 1
            continue
        out.append(a)
        i += 1
    return out


def main(argv=None) -> int:
    src = list(sys.argv[1:] if argv is None else argv)
    args, _ = build_parser().parse_known_args(src)

    rawdata = RawData(args.raw_path,
                      data_type="calib" if args.calib else "continuous",
                      restricted=args.restricted)
    all_series = rawdata.get_series_list()
    my_series = multihost.split_series_for_host(
        all_series, node_num=args.node_num, nb_nodes=args.nb_nodes)
    if not my_series:
        print("INFO: no series assigned to this node")
        return 0
    print(f"INFO: node processes {len(my_series)}/{len(all_series)} series")

    forwarded = strip_node_args(src) + ["--series", *my_series]
    if args.output_series_name is None:
        node_num = args.node_num
        if node_num is None:
            node_num = int(os.environ.get("SLURM_PROCID", 0))
        base_name = os.environ.get(BASE_SERIES_ENV)
        if base_name is not None:
            if not SERIES_NAME_RE.fullmatch(base_name):
                print(f"ERROR: {BASE_SERIES_ENV}={base_name!r} is not a "
                      "series name I{fac}_D{yyyymmdd}_T{hhmmss} (e.g. "
                      "I1_D20260820_T120000)")
                return 1
            # the job shares the timestamp; the facility is this run's
            base_name = f"I{args.facility}_" + base_name.split("_", 1)[1]
        else:
            base_name = create_series_name(args.facility)
            if (args.nb_nodes or int(os.environ.get("SLURM_NTASKS",
                                                    0) or 1)) > 1:
                print(f"WARNING: {BASE_SERIES_ENV} not set — deriving the "
                      "output series base from this node's clock; nodes "
                      "launched with sub-minute skew can still collide. "
                      "Export one base series for the job.")
        base = series_to_number(base_name)
        forwarded += ["--output-series-name", series_number_to_name(
            multihost.output_series_num_for_host(base, node_num))]
    return cli.main(forwarded)


if __name__ == "__main__":
    sys.exit(main())
