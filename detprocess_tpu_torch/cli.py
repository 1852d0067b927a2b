"""The command line of the port: filter generation → IV sweep →
salting → randoms → trigger → feature processing over a raw data group,
on one GPU.

Port of ``detprocess_tpu/cli.py``: the same flags and aliases
(:31-121), the same workloads chained in the same order with the same
rules (:133-406), the same output directories and file names, the same
``ERROR:`` messages and return codes. Example:

    python -m detprocess_tpu_torch.cli \\
        --raw_path /data/run42/raw --processing_setup process.json \\
        --calc-filter --enable-rand --enable-trig --enable-feature \\
        --output_group_path /data/run42/processed

Beside the JAX flags:

- ``--device`` (default ``cuda``, which needs a CUDA device and raises
  without one before any work; ``cpu`` runs the kernels' plain twins);
- ``--output-format npz``, the port's own table and filter-file form for
  machines without h5py or pandas (``io/tables``, ``io/filterdata``).

The raw group may hold pytesdaq HDF5 files or flat dumps with their JSON
manifests (``io/rawdata.write_flat_series``), and the setup may be YAML
or JSON (``config/yamlconfig.load_yaml``). The forms follow the files'
suffixes and the flag; nothing falls back to another form, device or
mode when one fails.

``--mesh-devices`` above 1 is refused: the mesh is ROADMAP.md §1 item 7.
``--prewarm`` keeps its use: one capped run of trigger and features that
saves nothing, the host workloads skipped with the JAX notice; what it
warms here is the nvcc build of the kernels at first use
(``ops/_kernels``), whose directory it prints.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Optional

import numpy as np
import torch

from detprocess_tpu_torch import device as dev
from detprocess_tpu_torch.config.yamlconfig import load_yaml, normalize_config
from detprocess_tpu_torch.io import tables
from detprocess_tpu_torch.io.filterdata import FilterData
from detprocess_tpu_torch.io.rawdata import RawData, RawIndex
from detprocess_tpu_torch.utils.misc import create_series_name

MESH_REFUSAL = ("ERROR: --mesh-devices {n} is not ported yet (ROADMAP.md "
                "§1 item 7, multi-GPU): run one process per GPU on its own "
                "series (python -m detprocess_tpu_torch.launch)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="detprocess-tpu-torch",
        description="detector data processing on a GPU (PyTorch/CUDA)")
    p.add_argument("--raw_path", "--input_group_path", type=str,
                   required=True, help="raw data group directory")
    p.add_argument("--processing_setup", type=str,
                   help="processing configuration (YAML, or JSON)")
    p.add_argument("--filter_file", type=str, default=None,
                   help="filter file (.hdf5, or .npz)")
    p.add_argument("--output_group_path", "--save_path", type=str,
                   default=None)
    p.add_argument("-s", "--series", "--input_series", nargs="+",
                   default=None)
    p.add_argument("--processing_id", type=str, default=None)
    p.add_argument("--facility", type=int, default=1)
    p.add_argument("--output-series-name", "--output_series_name",
                   default=None,
                   help="output series name override (default: "
                        "timestamp-derived). Multi-node launchers pass a "
                        "node-offset name here so concurrent nodes "
                        "never collide (python -m "
                        "detprocess_tpu_torch.launch)")
    p.add_argument("--nevents", type=int, default=-1)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--restricted", action="store_true")
    p.add_argument("--calib", action="store_true",
                   help="process calibration data")
    p.add_argument("--output-format", choices=("hdf5", "parquet", "npz"),
                   default="hdf5",
                   help="table and filter-file form: hdf5 (h5py), parquet "
                        "(pandas; filter files stay hdf5) or npz (numpy "
                        "only)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a CUDA device), "
                        "cuda:N, or cpu")

    p.add_argument("--enable-salting", "--enable_salting",
                   dest="enable_salting", action="store_true")
    p.add_argument("--enable-rand", "--enable-randoms", "--enable_rand",
                   dest="enable_rand", action="store_true")
    p.add_argument("--enable-trig", "--enable-triggers", "--enable_trig",
                   dest="enable_trig", action="store_true")
    p.add_argument("--enable-feature", "--enable_feature",
                   dest="enable_feature", action="store_true")
    p.add_argument("--enable-ivsweep", dest="enable_ivsweep",
                   action="store_true",
                   help="process IV/dIdV sweep data (discovered bias "
                        "points) into the filter file")
    p.add_argument("--calc-filter", "--calc_filter", dest="calc_filter",
                   action="store_true",
                   help="generate the filter file (noise/didv/template)")

    p.add_argument("--trigger_dataframe_path", type=str, default=None,
                   help="existing trigger dataframe for feature processing")
    p.add_argument("--trigger_series", nargs="+", default=None,
                   help="restrict the trigger dataframe to these series")
    p.add_argument("--salting_dataframe_path", type=str, default=None,
                   help="existing salting dataframe (skip generation)")
    p.add_argument("--ntriggers", type=int, default=-1,
                   help="max triggers to feature-process")
    p.add_argument("--ncores", type=int, default=None,
                   help="concurrent host reader threads feeding the "
                        "device pipeline")
    p.add_argument("--mesh-devices", type=int, default=None,
                   help="not ported yet (ROADMAP.md §1 item 7): a value "
                        "above 1 is refused")
    p.add_argument("--random_rate", type=float, default=None)
    p.add_argument("--nrandoms", type=int, default=None)
    p.add_argument("--salting_energies", type=float, nargs="+",
                   default=None)
    p.add_argument("--nsalt", type=int, default=100)
    p.add_argument("--device-salting", "--device_salting",
                   dest="device_salting", action="store_true",
                   help="inject salts on the device (the host only plans "
                        "index/amplitude arrays): salted runs keep the "
                        "int16 upload. Default: host injection")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--prewarm", action="store_true",
                   help="a capped run of trigger and features that saves "
                        "nothing (host workloads skipped), so that the "
                        "kernels are built before production runs")
    p.add_argument("--verbose", action="store_true", default=True,
                   help="verbose output (default; see --quiet)")
    p.add_argument("--quiet", dest="verbose", action="store_false",
                   help="suppress per-batch INFO output")
    return p


def resolve_device(name: str) -> torch.device:
    """``cuda``/``cuda:N`` through ``device.require_cuda`` (which raises
    without a CUDA device), anything else as given."""
    if name.startswith("cuda"):
        index = int(name.split(":", 1)[1]) if ":" in name else 0
        return dev.require_cuda(index)
    return torch.device(name)


def table_paths(directory: str) -> list:
    """The table dumps of a directory (.hdf5, .parquet and .npz)."""
    return sorted(glob.glob(os.path.join(directory, "*.hdf5"))
                  + glob.glob(os.path.join(directory, "*.parquet"))
                  + glob.glob(os.path.join(directory, "*.npz")))


def most_salts_per_event(table: dict) -> int:
    """The most rows of one (series, event) of a salting table."""
    keys = np.stack([np.asarray(table["series_number"]).astype(np.int64),
                     np.asarray(table["event_number"]).astype(np.int64)])
    _, counts = np.unique(keys, axis=1, return_counts=True)
    return int(counts.max()) if counts.size else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mesh_devices not in (None, 0, 1):
        print(MESH_REFUSAL.format(n=args.mesh_devices))
        return 1
    device = resolve_device(args.device)

    data_type = "calib" if args.calib else "continuous"
    rawdata = RawData(args.raw_path, data_type=data_type,
                      series=args.series, restricted=args.restricted)
    series_map = rawdata.get_data_files()
    raw_files = sorted(f for files in series_map.values() for f in files)
    needs_continuous = (args.enable_rand or args.enable_trig
                        or args.enable_feature or args.enable_salting)
    if not raw_files:
        if needs_continuous:
            print(f"ERROR: no {data_type} raw files found in "
                  f"{args.raw_path}")
            return 1
        # ivsweep / filter-generation runs: any data type provides the
        # channel list
        for alt in ("iv", "didv", "rand", "calib"):
            alt_map = RawData(args.raw_path, data_type=alt,
                              series=args.series,
                              restricted=args.restricted).get_data_files()
            raw_files = sorted(f for files in alt_map.values()
                               for f in files)
            if raw_files:
                break
        if not raw_files:
            print(f"ERROR: no raw files found in {args.raw_path}")
            return 1
    index = RawIndex.from_files(raw_files)

    out_base = args.output_group_path or os.path.join(args.raw_path, "..",
                                                      "processed")
    os.makedirs(out_base, exist_ok=True)
    out_series = (args.output_series_name
                  or create_series_name(args.facility))

    setup = config = None
    if args.processing_setup:
        setup = load_yaml(args.processing_setup)
        config = normalize_config(setup, index.channels,
                                  sample_rate=index.sample_rate)

    if args.prewarm:
        # a capped normal run of the workloads with a no-save mode; the
        # others would write real outputs and are skipped with a notice
        args.nevents = max(args.batch_size, 8)
        skipped = [flag for flag, on in (
            ("--enable-salting", args.enable_salting),
            ("--enable-rand", args.enable_rand),
            ("--enable-ivsweep", args.enable_ivsweep),
            ("--calc-filter", args.calc_filter)) if on]
        args.enable_salting = args.enable_rand = False
        args.enable_ivsweep = args.calc_filter = False
        args.salting_dataframe_path = None
        if skipped and args.verbose:
            print(f"INFO: prewarm skips {', '.join(skipped)} (host-side "
                  "workloads with nothing to compile; they would write "
                  "real outputs)")
        if args.verbose:
            from detprocess_tpu_torch.ops import _kernels
            print(f"INFO: prewarm run ({args.nevents} events/rows per "
                  f"workload); kernel build directory: "
                  f"{_kernels.BUILD_DIR}")
    nreaders = max(int(args.ncores or 1), 1)
    if nreaders > 1 and args.verbose:
        print(f"INFO: --ncores {nreaders}: host reads run in "
              f"{nreaders} reader threads feeding the device pipeline")

    filter_file = args.filter_file
    if filter_file is None and config is not None:
        filter_file = (config["feature"].get("overall", {})
                       or {}).get("filter_file")
    filter_store: Optional[FilterData] = None

    def filter_data() -> Optional[FilterData]:
        nonlocal filter_store
        if filter_store is None and filter_file is not None:
            filter_store = FilterData(verbose=args.verbose).load(filter_file)
        return filter_store

    # ---- filter generation --------------------------------------------
    if args.calc_filter:
        from detprocess_tpu_torch.pipelines.filtergen import (
            FilterDataProcessing)
        proc = FilterDataProcessing(raw_path=args.raw_path, config=setup,
                                    series=args.series,
                                    facility=args.facility,
                                    verbose=args.verbose, device=device)
        out_dir = os.path.join(out_base, "filterdata")
        proc.process(lgc_save=True, output_path=out_dir,
                     nrandoms=args.nrandoms, random_rate=args.random_rate,
                     seed=args.seed, output_format=args.output_format)
        print(f"INFO: filter data written to {out_dir}")

    # ---- IV/dIdV sweep ------------------------------------------------
    if args.enable_ivsweep:
        from detprocess_tpu_torch.pipelines.ivsweep import (
            IVSweepProcessing, discover_bias_points)
        sweep_proc = IVSweepProcessing(verbose=args.verbose, device=device)
        didv_cfg = (config["didv"].get("overall", {})
                    if config else {}) or {}
        nproc = 0
        for chan in index.channels:
            bias_points = discover_bias_points(args.raw_path, chan,
                                               series=args.series)
            if not bias_points:
                continue
            table = sweep_proc.process(
                chan, bias_points,
                sgfreq=didv_cfg.get("sgfreq", 100.0),
                sgamp=didv_cfg.get("sgamp", 1e-8),
                rsh=didv_cfg.get("rshunt", 5e-3))
            nproc += 1
            print(f"INFO: IV sweep processed for {chan}: "
                  f"{tables.table_rows(table)} bias points")
        if nproc == 0:
            print("ERROR: no IV/dIdV sweep bias points discovered")
            return 1
        out_dir = os.path.join(out_base, "ivsweep")
        os.makedirs(out_dir, exist_ok=True)
        ext = "npz" if args.output_format == "npz" else "hdf5"
        sweep_proc.save(os.path.join(out_dir, f"ivsweep_{out_series}.{ext}"))
        print(f"INFO: IV sweep data written to {out_dir}")

    # ---- salting ------------------------------------------------------
    salting = None
    if args.salting_dataframe_path:
        from detprocess_tpu_torch.pipelines.salting import Salting
        paths = table_paths(args.salting_dataframe_path)
        if not paths and os.path.isfile(args.salting_dataframe_path):
            paths = [args.salting_dataframe_path]
        if not paths:
            print("ERROR: no salting dataframe found at "
                  f"{args.salting_dataframe_path}")
            return 1
        if filter_file is None:
            print("ERROR: salting requires a filter file")
            return 1
        salting = Salting(filter_data(), verbose=args.verbose)
        salting.set_dataframe(tables.concat_tables(
            [tables.read_table(p) for p in paths]))
        print(f"INFO: loaded {tables.table_rows(salting.dataframe)} salts "
              f"from {args.salting_dataframe_path}")
    elif args.enable_salting:
        from detprocess_tpu_torch.pipelines.salting import Salting
        if filter_file is None:
            print("ERROR: salting requires a filter file")
            return 1
        salting_cfg = (config["salting"]
                       if config else {"overall": {}, "channel_list": []})
        channels = salting_cfg.get("channel_list") or index.channels
        overall = salting_cfg.get("overall", {}) or {}
        pdf_file = overall.get("dm_pdf_file") or overall.get("pdf_file")
        energies = None
        if pdf_file is None:
            energies = (args.salting_energies or overall.get("energies")
                        or [100.0])
        salting = Salting(filter_data(), verbose=args.verbose)
        salt_kwargs = {k: overall[k] for k in (
            "energy_norm_ev_per_amp", "channel_fractions", "template_tag",
            "min_separation_msec", "edge_exclusion_msec", "coincident",
            "pdf_xrange_kev") if k in overall}
        salting.generate_salt(
            index, channels, energies=energies, pdf_file=pdf_file,
            nsalt=overall.get("nsalt", args.nsalt), seed=args.seed,
            **salt_kwargs)
        out_dir = os.path.join(out_base, "salting")
        path = salting.save(out_dir, series_name=out_series,
                            facility=args.facility,
                            output_format=args.output_format)
        print(f"INFO: salting dataframe written to {path}")

    def injector():
        # the device injector gets a slot for every salt of the busiest
        # event, so that none is dropped
        if args.device_salting:
            return salting.make_device_injector(
                index.channels, max_salts_per_event=max(
                    16, most_salts_per_event(salting.dataframe)))
        return salting.make_injector(index.channels)

    # ---- randoms ------------------------------------------------------
    if args.enable_rand:
        from detprocess_tpu_torch.pipelines.randoms import Randoms
        randoms = Randoms(index, processing_id=args.processing_id,
                          facility=args.facility, verbose=args.verbose,
                          device=device)
        out_dir = os.path.join(out_base, "randoms")
        randoms.process(random_rate=args.random_rate,
                        nrandoms=args.nrandoms, seed=args.seed,
                        lgc_save=True, output_path=out_dir,
                        output_format=args.output_format,
                        series_name=out_series, lgc_output=False)
        print(f"INFO: randoms written to {out_dir}")

    # ---- triggering ---------------------------------------------------
    trigger_table = None
    if args.enable_trig:
        from detprocess_tpu_torch.pipelines.triggers import TriggerProcessing
        proc = TriggerProcessing(index, setup, filter_data=filter_data(),
                                 processing_id=args.processing_id,
                                 restricted=args.restricted,
                                 calib=args.calib, facility=args.facility,
                                 verbose=args.verbose, device=device)
        if salting is not None:
            proc.set_salting(injector())
        out_dir = os.path.join(out_base, "trigger")
        trigger_table = proc.process(nevents=args.nevents,
                                     lgc_save=not args.prewarm,
                                     output_path=out_dir,
                                     output_format=args.output_format,
                                     series_name=out_series,
                                     nreaders=(nreaders if args.nevents < 0
                                               else 1))
        print(f"INFO: {tables.table_rows(trigger_table)} triggers "
              + ("computed (prewarm: not saved)" if args.prewarm
                 else f"written to {out_dir}"))

    # ---- feature extraction ------------------------------------------
    if args.enable_feature:
        from detprocess_tpu_torch.pipelines.features import FeatureProcessing
        ttable = trigger_table
        if ttable is None and args.trigger_dataframe_path:
            paths = table_paths(args.trigger_dataframe_path)
            if args.trigger_series:
                paths = [pp for pp in paths
                         if any(sn in os.path.basename(pp)
                                for sn in args.trigger_series)]
            if not paths:
                print("ERROR: no trigger dataframes found in "
                      f"{args.trigger_dataframe_path}"
                      + (f" matching series {args.trigger_series}"
                         if args.trigger_series else "")
                      + " — refusing to silently fall back to "
                      "full-stream feature processing")
                return 1
            ttable = tables.concat_tables([tables.read_table(p)
                                           for p in paths])
        if ttable is not None and args.ntriggers > 0:
            ttable = {k: np.asarray(v)[: args.ntriggers]
                      for k, v in ttable.items()}
        proc = FeatureProcessing(index, setup, filter_data=filter_data(),
                                 trigger_table=ttable,
                                 processing_id=args.processing_id,
                                 restricted=args.restricted,
                                 calib=args.calib, facility=args.facility,
                                 verbose=args.verbose, device=device)
        if salting is not None:
            # salts live only in the injector, not in the raw files: the
            # feature reads inject them again
            proc.set_salting(injector())
        out_dir = os.path.join(out_base, "feature")
        proc.process(nevents=args.nevents, batch_size=args.batch_size,
                     lgc_save=not args.prewarm, output_path=out_dir,
                     output_format=args.output_format,
                     series_name=out_series,
                     nreaders=(nreaders if ttable is not None
                               or args.nevents < 0 else 1))
        print("INFO: features "
              + ("computed (prewarm: not saved)" if args.prewarm
                 else f"written to {out_dir}"))

    return 0


if __name__ == "__main__":
    sys.exit(main())
