"""The traffic generator makes the same files from the same seed."""

import hashlib

import numpy as np
import pytest

import gen


def digest(paths):
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


@pytest.mark.parametrize("name", ["events.example", "continuous.example"])
def test_same_seed_same_files(small_cell, tmp_path, name):
    cell = small_cell(name)
    runs = {}
    for tag, seed in (("a", 2**31 + 11), ("b", 2**31 + 11), ("c", 5)):
        d = tmp_path / tag
        d.mkdir()
        runs[tag] = digest(gen.write_dumps(str(d), cell.config, cell.traffic,
                                           seed, "cpu"))
    assert runs["a"] == runs["b"]
    assert runs["a"] != runs["c"]


def test_events_carry_their_pulses(small_cell, tmp_path):
    """Each triggered event holds a pulse of 1–5 µA a channel at the
    pretrigger (within the traffic's shift)."""
    cell = small_cell("events.example")
    paths = gen.write_dumps(str(tmp_path), cell.config, cell.traffic, 3,
                            "cpu")
    codes = gen.read_events(paths, cell.config, range(cell.traffic["events"]))
    conv = np.asarray(cell.config["adc_volts_per_bit"]) / np.asarray(
        cell.config["close_loop_norm"])
    amps = codes * conv[None, :, None]
    pre = cell.config["nb_pretrigger_samples"]
    peak = amps[:, :, pre - 60:pre + 400].max(-1)
    assert (peak > 0.8e-6).all() and (peak < 5.6e-6).all()
    assert codes.shape == (32, 2, 4096)


def test_continuous_pulses_fit_their_slots(small_cell):
    """Every slotted pulse lies in the slot range."""
    import torch
    cell = small_cell("continuous.example")
    gen_ = torch.Generator().manual_seed(9)
    pulses = gen.continuous_pulses(gen_, cell.config, cell.traffic, 4, "cpu")
    n = cell.config["nb_samples"]
    sl = cell.traffic["slots"]
    counts = {}
    for r, at, amp in pulses:
        counts[r] = counts.get(r, 0) + at.shape[1]
        assert int(at.min()) >= sl["first"] - 20
        assert int(at.max()) < n - sl["end_margin"] + 20
        assert (amp > 0).all()
    # each channel: 40 coincident and 4 singles
    assert counts == {0: 44, 1: 44}
