"""The feature plan: a normalized processing config compiled into trace
groups of algorithm specs with their compound-channel mix and OF bank.

Copy of the plan half of ``detprocess_tpu/pipelines/features.py``
(``AlgoSpec`` :72, ``TraceGroup`` :89, ``_build_plan`` :308,
``_resolve_group`` :413, ``_window_cut`` :581 and the window masks of
``_make_group_fn`` :639-666), as functions of the config, the raw
channels, sample rate and trace geometry, the filter data and, in
trigger-table mode, the trigger geometry:

- specs are grouped by trace geometry (nb_samples, pretrigger); in
  trigger-table mode the read window widens to cover every group around
  the trigger point (:372-381);
- each group gets its compound channels as one mix matrix over the raw
  channels, and one OF bank slot per distinct (channel, template tag,
  CSD tag, notch settings), built per slot with
  ``ops/filterbank.make_of1x1_bank`` (:561-576);
- raw channels with all-zero mix columns are neither read nor uploaded
  (:389-411);
- the OF delay alignment follows the template's stored pretrigger when
  there is one (``of_pretrigger``, :469-477), and template and PSD must
  have the group's length (:478-487);
- ``of1x2x2`` takes two slots of that bank (its two templates); each
  ``ofnxm`` and ``ofnxmx2`` spec an NxM bank of its own
  (``ops/filterbank.make_ofnxm_bank`` on the template and CSD stored
  under its '|' channel, :512-542) over the compound channels of its
  sub-channels;
- the PSD features, ``rftau``, the trace stats and each external
  extractor read one compound channel each (:542-547); an unknown name is
  refused with the external names listed (:549-552);
- :func:`direct_windows` picks the constrained fits that take the direct
  windowed route (:716-758).

External extractors come from a user module (``external_file``) that
:func:`load_external_extractors` loads with the rules of JAX
``_load_external_extractors`` (:1855-1879): the module's
``EXTRACTORS = {name: fn}``, else every public callable of the module;
a name that duplicates a built-in algorithm is refused. The call contract
is ``feature_group``'s.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from detprocess_tpu_torch.io.filterdata import check_fs_consistent
from detprocess_tpu_torch.ops import filterbank
from detprocess_tpu_torch.utils import channels as chutils
from detprocess_tpu_torch.utils import windows as winutils

OF_1X1_ALGORITHMS = ("of1x1_nodelay", "of1x1_unconstrained",
                     "of1x1_constrained")
OF_NXM_ALGORITHMS = ("ofnxm", "ofnxmx2")
PSD_ALGORITHMS = ("psd_amp", "psd_peaks", "phase")
TRACE_ALGORITHMS = ("baseline", "integral", "maximum", "minimum",
                    "energyabsorbed")
BUILTIN_ALGORITHMS = frozenset(OF_1X1_ALGORITHMS + OF_NXM_ALGORITHMS
                               + PSD_ALGORITHMS + TRACE_ALGORITHMS
                               + ("rftau",))

# Constrained windows of at most this many allowed delays take the direct
# windowed DFT (ops/of1x1.of1x1_windowed_direct_half, ops/ofnxm.
# ofnxm_withdelay_direct_half) in place of the inverse transform (JAX
# features.py:64, where 1024 came from a TPU measurement): the largest
# window at which the direct route beat the irfft route in every chip run
# of chip_smoke.py's phase (q) (PERF.md §6).
DIRECT_WINDOW_MAX = 251


@dataclass
class AlgoSpec:
    """One channel × algorithm instance."""

    algorithm: str          # output name (may be a derived variant)
    base: str               # base algorithm
    channel: str            # config channel key (possibly compound)
    feature_channel: str    # column suffix
    kwargs: dict
    window: tuple           # (min_index, max_index)
    slot: int = -1          # row of the group's 1x1 bank
    slot2: int = -1         # second row (of1x2x2)
    nxm_key: str = ""       # key of the group's NxM bank
    chan_idx: int = -1      # compound-channel row of the group's mix
    nxm_chan_idx: tuple = ()    # rows of the NxM sub-channels
    extractor: Optional[Callable] = None    # an external extractor's fn


@dataclass
class TraceGroup:
    """All work sharing one (nb_samples, nb_pretrigger) trace geometry."""

    nb_samples: int
    nb_pretrigger: int
    compound_channels: List[str] = field(default_factory=list)
    mix_matrix: Optional[np.ndarray] = None      # [n_compound, n_raw]
    specs: List[AlgoSpec] = field(default_factory=list)
    bank_1x1: Optional[filterbank.OF1x1Bank] = None
    slot_keys: List[tuple] = field(default_factory=list)
    nxm_banks: Dict[str, filterbank.OFNxMBank] = field(default_factory=dict)
    of_pretrigger: Optional[int] = None   # the templates' own pretrigger


@dataclass
class FeaturePlan:
    groups: List[TraceGroup]
    raw_nb_samples: int          # the trigger window's in table mode
    raw_pretrigger: int
    read_channels: Optional[List[str]] = None       # None: read all
    trigger_geometry: Optional[tuple] = None        # (n, pretrigger)


def load_external_extractors(path: str) -> Dict[str, Callable]:
    """The extractor registry ``{name: fn}`` of the python file at
    ``path``: its ``EXTRACTORS`` dict, else every public callable it
    defines or imports; a name of a built-in algorithm is refused."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "detprocess_tpu_torch_ext", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if hasattr(module, "EXTRACTORS"):
        registry = dict(module.EXTRACTORS)
    else:
        registry = {name: fn for name, fn in vars(module).items()
                    if callable(fn) and not name.startswith("_")}
    dupes = set(registry) & BUILTIN_ALGORITHMS
    if dupes:
        raise ValueError(
            f"external extractors duplicate built-in algorithms: {dupes} "
            "(features.py:1124-1128 duplicate rejection)")
    return registry


def build_plan(feature_config: dict, channels: List[str], fs: float,
               raw_geometry: tuple, filter_data,
               trigger_mode: bool = False,
               extractors: Optional[Dict[str, Callable]] = None
               ) -> FeaturePlan:
    """Compile the normalized ``feature`` section. ``raw_geometry`` is
    (nb_samples, pretrigger) of the raw traces; ``extractors`` the
    external registry (:func:`load_external_extractors`)."""
    channels_cfg = feature_config["channels"]
    weights_cfg = feature_config.get("weights", {}) or {}
    overall = feature_config.get("overall", {}) or {}

    trigger_geometry = None
    if trigger_mode:
        n0 = overall.get("trace_length_samples")
        p0 = overall.get("pretrigger_length_samples")
        if n0 is None:
            lengths = [ac.get("nb_samples")
                       for cc in channels_cfg.values()
                       if isinstance(cc, dict)
                       for ac in cc.values()
                       if isinstance(ac, dict) and ac.get("nb_samples")]
            if not lengths:
                raise ValueError(
                    "trigger-dataframe mode requires a trace length "
                    "(global trace_length_samples or per-algorithm)")
            n0 = max(lengths)
        if p0 is None:
            p0 = n0 // 2
        trigger_geometry = (int(n0), int(p0))
        raw_n, raw_pre = trigger_geometry
    else:
        raw_n, raw_pre = raw_geometry

    groups: Dict[tuple, TraceGroup] = {}
    for chan, chan_config in channels_cfg.items():
        feature_channel = chan_config.get("feature_channel", chan)
        for algo, algo_config in chan_config.items():
            if not isinstance(algo_config, dict) or not algo_config.get(
                    "run"):
                continue
            base = algo_config.get("base_algorithm", algo)
            nb_s = algo_config.get("nb_samples") or raw_n
            nb_p = algo_config.get("nb_pretrigger_samples")
            if nb_p is None:
                nb_p = raw_pre if nb_s == raw_n else nb_s // 2
            group = groups.setdefault((nb_s, nb_p), TraceGroup(nb_s, nb_p))

            kwargs = {k: v for k, v in algo_config.items() if k != "run"}
            if base in TRACE_ALGORITHMS:
                lo, hi = winutils.extract_window_indices(
                    nb_s, nb_p, fs,
                    **{k: v for k, v in kwargs.items()
                       if k.startswith("window_") and k.endswith("_usec")})
                if kwargs.get("window_min_index") is not None:
                    lo = int(kwargs["window_min_index"])
                if kwargs.get("window_max_index") is not None:
                    hi = int(kwargs["window_max_index"])
                window = (lo, hi)
            else:
                window = (kwargs.get("window_min_index") or 0,
                          kwargs.get("window_max_index") or nb_s - 1)
            group.specs.append(AlgoSpec(
                algorithm=algo, base=base, channel=chan,
                feature_channel=feature_channel, kwargs=kwargs,
                window=window))

    if trigger_mode and groups:
        # the read window covers every group geometry around the trigger
        pre = max(g.nb_pretrigger for g in groups.values())
        post = max(g.nb_samples - g.nb_pretrigger for g in groups.values())
        n0, p0 = trigger_geometry
        pre = max(pre, p0)
        post = max(post, n0 - p0)
        trigger_geometry = (pre + post, pre)
        raw_n, raw_pre = trigger_geometry

    plan = FeaturePlan([], raw_n, raw_pre,
                       trigger_geometry=trigger_geometry)
    for key in sorted(groups):
        resolve_group(groups[key], weights_cfg, channels, fs, filter_data,
                      extractors)
        plan.groups.append(groups[key])

    # channel-subset reads: a raw channel with an all-zero mix column
    # never reaches an output, so it is neither read nor uploaded
    used = np.zeros(len(channels), bool)
    for g in plan.groups:
        if g.mix_matrix is not None and g.mix_matrix.size:
            used |= (g.mix_matrix != 0).any(axis=0)
    used_idx = np.flatnonzero(used)
    if 0 < len(used_idx) < len(channels):
        plan.read_channels = [channels[i] for i in used_idx]
        for g in plan.groups:
            if g.mix_matrix is not None and g.mix_matrix.size:
                g.mix_matrix = g.mix_matrix[:, used_idx]
    return plan


def resolve_group(group: TraceGroup, weights_cfg: dict,
                  raw_channels: List[str], fs: float, filter_data,
                  extractors: Optional[Dict[str, Callable]] = None) -> None:
    """Fill ``group``'s compound channels, mix matrix, 1x1 bank and NxM
    banks, and each external spec's function."""
    extractors = extractors or {}
    compound: List[str] = []
    mix_rows: List[np.ndarray] = []

    def compound_index(chan: str) -> int:
        if chan in compound:
            return compound.index(chan)
        chans, weights = chutils.channel_combination_weights(
            chan, raw_channels)
        missing = [c for c in chans if c not in raw_channels]
        if missing:
            raise ValueError(
                f"feature channel '{chan}' reads raw channel(s) "
                f"{missing} not present in the raw data; "
                f"available channels: {raw_channels}")
        row = np.zeros(len(raw_channels))
        wcfg = weights_cfg.get(chan, {})
        for sub, w in zip(chans, weights):
            row[raw_channels.index(sub)] = w * wcfg.get(f"weight_{sub}", 1.0)
        compound.append(chan)
        mix_rows.append(row)
        return len(compound) - 1

    def need_filter_data(chan: str):
        if filter_data is None:
            raise ValueError(f"no filter data for {chan}: pass filter_data "
                             "or set filter_file in the config")

    slot_keys: List[tuple] = []
    slot_templates: List[np.ndarray] = []
    slot_psds: List[np.ndarray] = []
    slot_notches: List[tuple] = []

    def bank_slot(chan: str, template_tag: str, csd_tag: str,
                  kwargs: dict) -> int:
        notch = tuple(np.atleast_1d(
            kwargs.get("ignored_frequency_peaks") or ()))
        harmonics = bool(kwargs.get("ignore_harmonics", False))
        integralnorm = bool(kwargs.get("integralnorm", False))
        coupling = str(kwargs.get("coupling", "AC")).upper()
        skey = (chan, template_tag, csd_tag, notch, harmonics, integralnorm,
                coupling)
        if skey in slot_keys:
            return slot_keys.index(skey)
        need_filter_data(chan)
        template, _, tmeta = filter_data.get_template(
            chan, tag=template_tag, return_metadata=True)
        check_fs_consistent(fs, tmeta, "template", chan, template_tag)
        template = (np.atleast_2d(template)[0] if np.ndim(template) > 1
                    else np.asarray(template))
        psd, _, pmeta = filter_data.get_psd(chan, tag=csd_tag,
                                            return_metadata=True)
        check_fs_consistent(fs, pmeta, "psd", chan, csd_tag)
        tpre = tmeta.get("nb_pretrigger_samples")
        if tpre is not None:
            tpre = int(tpre)
            if group.of_pretrigger is not None and group.of_pretrigger != tpre:
                raise ValueError(
                    f"inconsistent template pretriggers in trace group "
                    f"({group.of_pretrigger} vs {tpre}, channel {chan})")
            group.of_pretrigger = tpre
        if template.shape[-1] != group.nb_samples:
            raise ValueError(
                f"template length {template.shape[-1]} != trace length "
                f"{group.nb_samples} for channel {chan} "
                f'(tag "{template_tag}")')
        if psd.shape[-1] != group.nb_samples:
            raise ValueError(
                f"psd length {psd.shape[-1]} != trace length "
                f"{group.nb_samples} for channel {chan} (tag \"{csd_tag}\")")
        slot_keys.append(skey)
        slot_templates.append(template)
        slot_psds.append(psd)
        slot_notches.append((notch, harmonics, integralnorm, coupling))
        return len(slot_keys) - 1

    for spec in group.specs:
        kwargs = spec.kwargs
        if spec.base in OF_1X1_ALGORITHMS:
            tag = kwargs.get("template_tag", "default")
            if tag is None:
                raise ValueError(f"template_tag required for "
                                 f"{spec.algorithm} on channel {spec.channel}")
            spec.slot = bank_slot(spec.channel, tag,
                                  kwargs.get("csd_tag", "default"), kwargs)
            spec.chan_idx = compound_index(spec.channel)
        elif spec.base == "of1x2x2":
            csd_tag = kwargs.get("csd_tag", "default")
            spec.slot = bank_slot(spec.channel, kwargs.get(
                "template_tag_1", "Scintillation"), csd_tag, kwargs)
            spec.slot2 = bank_slot(spec.channel, kwargs.get(
                "template_tag_2", "Evaporation"), csd_tag, kwargs)
            spec.chan_idx = compound_index(spec.channel)
            delta_window(spec, fs)
        elif spec.base in OF_NXM_ALGORITHMS:
            tag = kwargs.get("template_tag")
            if tag is None:
                raise ValueError(
                    f'Missing "template_tag" for channel {spec.channel},'
                    f' algorithm "{spec.algorithm}"')
            if spec.base == "ofnxmx2":
                nxmx2_windows(spec, group.nb_samples)
            need_filter_data(spec.channel)
            csd_tag = kwargs.get("csd_tag", "default")
            template, _, tmeta = filter_data.get_template(
                spec.channel, tag=tag, return_metadata=True)
            check_fs_consistent(fs, tmeta, "template", spec.channel, tag)
            csd, _, cmeta = filter_data.get_csd(
                spec.channel, tag=csd_tag, return_metadata=True)
            check_fs_consistent(fs, cmeta, "csd", spec.channel, csd_tag)
            nxm_pre = int(tmeta.get("nb_pretrigger_samples")
                          or group.nb_pretrigger)
            if group.of_pretrigger is None:
                group.of_pretrigger = nxm_pre
            key = f"{spec.channel}::{spec.algorithm}"
            group.nxm_banks[key] = filterbank.make_ofnxm_bank(
                np.asarray(template), np.asarray(csd), fs, nxm_pre,
                ignored_frequency_peaks=kwargs.get("ignored_frequency_peaks"),
                ignore_harmonics=kwargs.get("ignore_harmonics", False),
                coupling=str(kwargs.get("coupling", "AC")))
            spec.nxm_key = key
            subs, _ = chutils.split_channel_name(spec.channel, raw_channels,
                                                 separator="|")
            spec.nxm_chan_idx = tuple(compound_index(c) for c in subs)
        elif (spec.base in TRACE_ALGORITHMS or spec.base in PSD_ALGORITHMS
              or spec.base == "rftau"):
            spec.chan_idx = compound_index(spec.channel)
        elif spec.base in extractors:
            spec.extractor = extractors[spec.base]
            spec.chan_idx = compound_index(spec.channel)
        else:
            raise ValueError(
                f'Cannot find algorithm "{spec.base}" — check feature '
                f"extractor exists (built-ins + external: "
                f"{sorted(extractors)})")

    group.compound_channels = compound
    group.mix_matrix = (np.stack(mix_rows) if mix_rows
                        else np.zeros((0, len(raw_channels))))
    group.slot_keys = slot_keys
    if slot_keys:
        # per-slot notch settings can differ: one bank per slot, stacked
        banks = [filterbank.make_of1x1_bank(
                    slot_templates[i], slot_psds[i], fs, group.nb_pretrigger,
                    integralnorm=slot_notches[i][2],
                    ignored_frequency_peaks=list(slot_notches[i][0]) or None,
                    ignore_harmonics=slot_notches[i][1],
                    coupling=slot_notches[i][3])
                 for i in range(len(slot_keys))]
        group.bank_1x1 = filterbank.OF1x1Bank(
            *(np.concatenate([getattr(b, k) for b in banks])
              for k in ("s_fft", "denom_inv", "phi", "norm", "templates",
                        "psd")),
            fs=fs, pretrigger=group.nb_pretrigger)


def window_cut(group: TraceGroup, raw_n: int, raw_pre: int) -> Optional[int]:
    """Start sample of ``group``'s geometry in raw traces of
    (``raw_n``, ``raw_pre``), or None when it takes the whole trace."""
    if group.nb_samples == raw_n:
        if raw_pre is not None and group.nb_pretrigger != raw_pre:
            raise ValueError(
                f"configured pretrigger {group.nb_pretrigger} != raw "
                f"pretrigger {raw_pre} with full-length traces "
                f"({raw_n} samples); set nb_samples to cut a window "
                "or match the raw pretrigger")
        return None
    start = raw_pre - group.nb_pretrigger
    if start < 0 or start + group.nb_samples > raw_n:
        raise ValueError(
            f"trace geometry ({group.nb_samples}, {group.nb_pretrigger}) "
            f"does not fit in raw trace ({raw_n}, {raw_pre})")
    return start


def window_mask(spec: AlgoSpec, n: int, pretrig: int,
                fs: float) -> Optional[np.ndarray]:
    """The constrained fit's boolean delay mask [n] over absolute trace
    indices, or None when the spec sets no window."""
    wmin = spec.kwargs.get("window_min_index")
    wmax = spec.kwargs.get("window_max_index")
    usec_min = spec.kwargs.get("window_min_from_trig_usec")
    usec_max = spec.kwargs.get("window_max_from_trig_usec")
    if (wmin is None and wmax is None and usec_min is None
            and usec_max is None):
        return None
    lo, hi = winutils.extract_window_indices(
        n, pretrig, fs, window_min_from_trig_usec=usec_min,
        window_max_from_trig_usec=usec_max)
    if wmin is not None:
        lo = int(wmin)
    if wmax is not None:
        hi = int(wmax)
    mask = np.zeros(n, dtype=bool)
    mask[lo:hi + 1] = True
    if spec.kwargs.get("lgc_outside_window", False):
        mask = ~mask
    if not mask.any():
        raise ValueError(
            f"{spec.algorithm} on {spec.channel}: constrained delay window "
            f"[{lo}, {hi}] with lgc_outside_window="
            f"{bool(spec.kwargs.get('lgc_outside_window', False))} selects "
            "no delays — fix window_min/max_index or "
            "window_*_from_trig_usec in the processing config")
    return mask


def direct_windows(group: TraceGroup, fs: float,
                   window_max: Optional[int] = None) -> Dict[int, np.ndarray]:
    """{spec index: window mask} of the group's specs that take the direct
    windowed delay fit (JAX features.py:716-758): an ``of1x1_constrained``
    or ``ofnxm`` spec whose window allows at most ``window_max`` delays
    (default :data:`DIRECT_WINDOW_MAX`), unless its OF filter's full delay
    series is computed anyway, for an ``of1x1_unconstrained`` spec or a
    wider constrained one on the same slot (or NxM bank)."""
    window_max = DIRECT_WINDOW_MAX if window_max is None else window_max
    n, pre = group.nb_samples, group.nb_pretrigger
    masks = {i: window_mask(s, n, pre, fs) for i, s in enumerate(group.specs)
             if s.base in ("of1x1_constrained", "ofnxm")}
    narrow = {i for i, m in masks.items()
              if m is not None and int(m.sum()) <= window_max}
    full_slots = {s.slot for i, s in enumerate(group.specs)
                  if s.base == "of1x1_unconstrained"
                  or (s.base == "of1x1_constrained" and i not in narrow)}
    full_nxm = {s.nxm_key for i, s in enumerate(group.specs)
                if s.base == "ofnxm" and i not in narrow}
    spec = group.specs
    return {i: masks[i] for i in sorted(narrow)
            if (spec[i].slot not in full_slots
                if spec[i].base == "of1x1_constrained"
                else spec[i].nxm_key not in full_nxm)}


def delta_window(spec: AlgoSpec, fs: float) -> Optional[np.ndarray]:
    """The Δ = t2 − t1 samples that an ``of1x2x2`` spec's joint scan may
    take (``delta_window_min_usec``/``delta_window_max_usec``,
    features.py:912-929), or None for the full circular scan."""
    dmin = spec.kwargs.get("delta_window_min_usec")
    dmax = spec.kwargs.get("delta_window_max_usec")
    if dmin is None and dmax is None:
        return None
    if dmax is None:
        raise ValueError(f"{spec.algorithm} on {spec.channel}: "
                         "delta_window_max_usec required when "
                         "delta_window_min_usec is set")
    lo = int(round((dmin if dmin is not None else -dmax) * 1e-6 * fs))
    hi = int(round(dmax * 1e-6 * fs))
    if hi < lo:
        raise ValueError(f"{spec.algorithm} on {spec.channel}: empty delta "
                         f"window [{lo}, {hi}] samples")
    return np.arange(lo, hi + 1)


def nxmx2_windows(spec: AlgoSpec, n: int):
    """(group ids [M], shift mask of group 0, of group 1) of an
    ``ofnxmx2`` spec (features.py:1004-1009), whose ``fit_window`` and
    ``template_group_ids`` are required: the JAX shell fails on either's
    absence with a bare KeyError while it runs, this plan when it is
    built, naming the key."""
    for key in ("template_group_ids", "fit_window"):
        if spec.kwargs.get(key) is None:
            raise ValueError(
                f'Missing "{key}" for {spec.algorithm} on channel '
                f"{spec.channel}: ofnxmx2 takes the shifts of each template "
                "group from fit_window [[min, max], [min, max]] (trace "
                "indices) and the groups from template_group_ids")
    gids = np.asarray(spec.kwargs["template_group_ids"])
    fit_window = np.asarray(spec.kwargs["fit_window"])
    w1 = np.zeros(n, bool)
    w1[fit_window[0][0]:fit_window[0][1] + 1] = True
    w2 = np.zeros(n, bool)
    w2[fit_window[1][0]:fit_window[1][1] + 1] = True
    return gids, w1, w2
