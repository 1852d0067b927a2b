"""The one traffic generator: a configuration and a traffic mix, a seed,
and the flat int16 dumps they describe.

Every random draw comes from one ``torch.Generator`` on the device,
seeded with ``--seed``, in a fixed order, so a seed gives the same files
on every run. Noise has each channel's PSD (a complex normal half
spectrum scaled by √(J·fs·N/2), DC zeroed); pulses are the
configuration's shapes. Events are written as stored codes,
``round(amps / conversion)``, in the pytesdaq flat layout the program
reads: events [E, C, N] back to back, dump k named
``flat_{series}_F{k:04d}.bin``.

Traffic keys read here:

- triggered data: ``shift_samples``, ``pulses``, ``lines`` and
  ``noise_correlation`` (:func:`triggered_events`, :func:`noise`);
- continuous data: ``slots`` {first, end_margin, margin} and ``pulses``:
  ``placement: slot`` pulses (``coincident`` on all their channels with
  offsets within ±spread_samples, or one channel each, ``count`` a
  channel) get one slot each of [first, N − end_margin), placed at least
  ``margin`` from its edges; ``placement: fixed`` pulses sit at
  N − from_end_samples ± jitter_samples. Amplitudes are
  ``amplitude_sigma`` times the channel's trigger resolution (drawn
  uniformly between the two given as a list), or drawn uniformly from
  ``amplitude_a``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from reference import filters

INT16_MAX = np.iinfo(np.int16).max


def dump_path(directory: str, config: dict, k: int) -> str:
    return os.path.join(directory, f"flat_{config['series']}_F{k:04d}.bin")


def noise(gen, config: dict, nevents: int, n: int, device,
          correlation=()) -> torch.Tensor:
    """Noise traces [E, C, n] of each channel's PSD, float32 on device;
    ``correlation`` [{channel, with, rho, lag_samples}] makes a channel
    rho times another one delayed, plus its own part."""
    fs = config["sample_rate_hz"]
    chans = config["channels"]
    nh = n // 2 + 1
    scale = torch.as_tensor(np.sqrt(filters.channel_psds(config, n)[:, :nh]
                                    * fs * n / 2.0), dtype=torch.float32,
                            device=device)
    c = scale.shape[0]
    z = torch.randn((nevents, c, 2, nh), generator=gen, device=device)
    white = torch.complex(z[:, :, 0], z[:, :, 1])
    if n % 2 == 0:
        white[..., -1] = z[:, :, 0, -1] * np.sqrt(2.0)
    for corr in correlation:
        b, a = chans.index(corr["channel"]), chans.index(corr["with"])
        lag = torch.exp(-2j * np.pi * torch.arange(nh, device=device)
                        * corr["lag_samples"] / n)
        rho = corr["rho"]
        white[:, b] = rho * white[:, a] * lag + np.sqrt(1 - rho ** 2) \
            * white[:, b]
    nf = white * scale
    nf[..., 0] = 0.0
    return torch.fft.irfft(nf, n=n)


def uniform(gen, lo: float, hi: float, shape, device) -> torch.Tensor:
    return torch.empty(shape, device=device).uniform_(lo, hi, generator=gen)


def to_codes(traces: torch.Tensor, config: dict) -> torch.Tensor:
    """Stored int16 codes of traces [E, C, n] in amperes."""
    conv = torch.as_tensor(filters.adc_conversion(config),
                           dtype=torch.float32, device=traces.device)
    codes = torch.round(traces / conv[:, None])
    if float(codes.abs().max()) > INT16_MAX:
        raise ValueError("int16 ADC overflow in the synthetic events")
    return codes.to(torch.int16)


def triggered_events(gen, config: dict, traffic: dict, nevents: int,
                     device) -> torch.Tensor:
    """Codes [E, C, N] of triggered events: noise, then the traffic's
    pulses at the pretrigger, all moved by one offset an event within
    ±shift_samples. A population's shape is its ``template`` (a name of
    the traffic's ``templates``) or each channel's own; its amplitude is
    drawn from ``amplitude_a`` a channel, or is that of population
    ``amplitude_of``'s first channel; ``delay_samples`` [lo, hi] moves it
    by a further whole number of samples an event. ``lines`` add a sine
    of ``amplitude_a`` and ``phase_rad`` at the bin nearest
    ``freq_hz``."""
    n = config["nb_samples"]
    pre = config["nb_pretrigger_samples"]
    fs = config["sample_rate_hz"]
    chans = config["channels"]
    x = noise(gen, config, nevents, n, device,
              traffic.get("noise_correlation", ()))
    own = torch.as_tensor(filters.channel_templates(config, n, pre),
                          dtype=torch.float32, device=device)
    idx = torch.arange(n, device=device)
    s = int(traffic.get("shift_samples", 0))
    shifts = torch.randint(-s, s + 1, (nevents,), generator=gen,
                           device=device)
    drawn = []
    for pop in traffic["pulses"]:
        rows = [chans.index(c) for c in pop["channels"]]
        if "template" in pop:
            shape = torch.as_tensor(filters.named_shape(
                config, traffic["templates"][pop["template"]], n, pre),
                dtype=torch.float32, device=device).expand(len(rows), n)
        else:
            shape = own[rows]
        at = shifts
        if "delay_samples" in pop:
            lo, hi = pop["delay_samples"]
            at = shifts + torch.randint(lo, hi + 1, (nevents,),
                                        generator=gen, device=device)
        if "amplitude_of" in pop:
            amps = drawn[pop["amplitude_of"]][:, :1].expand(nevents,
                                                            len(rows))
        else:
            amps = uniform(gen, *pop["amplitude_a"], (nevents, len(rows)),
                           device)
        drawn.append(amps)
        cols = (idx[None, :] - at[:, None]) % n
        x[:, rows] += amps[:, :, None] * shape[:, cols].permute(1, 0, 2)
    for line in traffic.get("lines", []):
        f = filters.line_frequency(config, line, n)
        t = idx.to(torch.float32)
        x[:, chans.index(line["channel"])] += line["amplitude_a"] * torch.sin(
            2 * np.pi * f * t / fs + line["phase_rad"])
    return to_codes(x, config)


def trigger_resolutions(config: dict) -> np.ndarray:
    """Each channel's amplitude resolution (A) in its trigger filter."""
    tt = config["trigger_template"]
    nt, pre = tt["nb_samples"], tt["nb_pretrigger_samples"]
    tmpl = filters.channel_templates(config, nt, pre)
    psd = filters.channel_psds(config, nt)
    return np.array([filters.Bank(t, p, config["sample_rate_hz"]).resolution
                     for t, p in zip(tmpl, psd)])


def continuous_pulses(gen, config: dict, traffic: dict, nevents: int,
                      device) -> list:
    """[(channel rows [P], trigger points [E, P], amplitudes [E, P])],
    one entry a pulse population and channel."""
    n = config["nb_samples"]
    chans = config["channels"]
    res = trigger_resolutions(config)
    slot_pops = [p for p in traffic["pulses"] if p["placement"] == "slot"]
    nslot = sum(p["count"] * (1 if p.get("coincident") else
                              len(p["channels"])) for p in slot_pops)
    out = []
    if nslot:
        sl = traffic["slots"]
        lo, hi = sl["first"], n - sl["end_margin"]
        width = (hi - lo) // nslot
        margin = sl["margin"]
        if width <= 2 * margin:
            raise ValueError(f"{nslot} pulses do not fit into {n} samples")
        pos = (lo + width * torch.arange(nslot, device=device)
               + torch.randint(margin, width - margin, (nevents, nslot),
                               generator=gen, device=device))
        perm = torch.argsort(torch.rand((nevents, nslot), generator=gen,
                                        device=device), dim=-1)
        pos = pos.gather(-1, perm)
        used = 0
    for pop in traffic["pulses"]:
        rows = [chans.index(c) for c in pop["channels"]]
        if pop["placement"] == "slot":
            k = pop["count"]
            if pop.get("coincident"):
                at = pos[:, used:used + k]
                used += k
                s = int(pop.get("spread_samples", 0))
                spread = torch.randint(-s, s + 1, (nevents, k, len(rows)),
                                       generator=gen, device=device)
                per_chan = [at + spread[:, :, j] for j in range(len(rows))]
            else:
                per_chan = []
                for _ in rows:
                    per_chan.append(pos[:, used:used + k])
                    used += k
        elif pop["placement"] == "fixed":
            base = n - torch.as_tensor(pop["from_end_samples"], device=device)
            j = int(pop.get("jitter_samples", 0))
            jit = torch.randint(-j, j + 1, (nevents, len(base)),
                                generator=gen, device=device)
            per_chan = [base + jit for _ in rows]
        else:
            raise ValueError(f"unknown placement {pop['placement']!r}")
        for r, at in zip(rows, per_chan):
            sig = pop.get("amplitude_sigma")
            if isinstance(sig, list):
                amp = uniform(gen, *sig, at.shape, device) * float(res[r])
            elif sig is not None:
                amp = torch.full(at.shape, sig * res[r], device=device)
            else:
                amp = uniform(gen, *pop["amplitude_a"], at.shape, device)
            out.append((r, at, amp))
    return out


def continuous_events(gen, config: dict, pulses: list, first: int,
                      count: int, device) -> torch.Tensor:
    """Codes [count, C, N] of continuous events ``first`` …: noise plus
    the pulses of :func:`continuous_pulses`, each put at its trigger
    point (the template's pretrigger sample)."""
    n = config["nb_samples"]
    tt = config["trigger_template"]
    nt, pre = tt["nb_samples"], tt["nb_pretrigger_samples"]
    x = noise(gen, config, count, n, device)
    tmpl = torch.as_tensor(filters.channel_templates(config, nt, pre),
                           dtype=torch.float32, device=device)
    steps = torch.arange(nt, device=device) - pre
    flat = x.view(-1)
    ev = torch.arange(count, device=device)
    for r, at, amp in pulses:
        at, amp = at[first:first + count], amp[first:first + count]
        base = (ev[:, None] * x.shape[1] + r) * n + at       # [count, P]
        where = (base[..., None] + steps).reshape(-1)
        flat.index_add_(0, where, (amp[..., None] * tmpl[r]).reshape(-1))
    return to_codes(x, config)


def write_dumps(directory: str, config: dict, traffic: dict, seed: int,
                device) -> list:
    """Make the cell's events from ``seed`` and write them as
    ``traffic['files']`` flat dumps into ``directory``, synced to disk;
    returns the paths."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    nevents, nfiles = traffic["events"], traffic["files"]
    chunk = traffic["chunk"]
    per = -(-nevents // nfiles)
    continuous = config["data_type"] == "continuous"
    pulses = (continuous_pulses(gen, config, traffic, nevents, device)
              if continuous else None)
    paths = []
    for i in range(nfiles):
        path = dump_path(directory, config, i + 1)
        first, last = i * per, min((i + 1) * per, nevents)
        with open(path, "wb") as f:
            for j in range(first, last, chunk):
                count = min(chunk, last - j)
                if continuous:
                    codes = continuous_events(gen, config, pulses, j, count,
                                              device)
                else:
                    codes = triggered_events(gen, config, traffic, count,
                                             device)
                codes.cpu().numpy().tofile(f)
            # on disk before the window: no writeback of our own in it
            f.flush()
            os.fsync(f.fileno())
        paths.append(path)
    return paths


def read_events(paths: list, config: dict, positions) -> np.ndarray:
    """Stored codes [R, C, N] of events at ``positions`` (0 … in file
    order), read back from the dumps."""
    c, n = len(config["channels"]), config["nb_samples"]
    block = c * n
    sizes = [os.path.getsize(p) // (2 * block) for p in paths]
    starts = np.cumsum([0] + sizes)
    out = np.empty((len(positions), c, n), np.int16)
    for r, pos in enumerate(positions):
        k = int(np.searchsorted(starts, pos, side="right") - 1)
        out[r] = np.fromfile(paths[k], np.int16, block,
                             offset=2 * block * (int(pos) - starts[k])
                             ).reshape(c, n)
    return out
