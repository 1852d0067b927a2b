"""The residual deployment (``continuous.residual``) at small sizes: the
port's float64 CPU run against the plain reference, pass by pass, and
the mechanism the cell is for at work: the residual pass finds the
trailers of the pileup pairs on Mv2301, the saturation veto keeps the
saturating pulses out of the subtraction, Mv2302 runs no residual
pass."""

import copy

import numpy as np
import torch

import checks
import gen
from reference import filters, triggers
from reference.precision import Arith
from shells import Program

EVENTS = 4


def port_table(cell, paths, config):
    program = Program(config, cell.traffic, paths, "cpu")
    table = program.shell.process(event_batch=2, capacity=4096,
                                  dtype=np.float64)
    return table, program.shell.stats


def vetoed(config, codes):
    """The reference's first-pass triggers on Mv2301 that its veto flags."""
    name, row, kw = triggers.trigger_channels(config)[0]
    ch = triggers.Channel(config, name, row, kw, Arith("float64"), "cpu")
    x = torch.as_tensor(codes[row], dtype=torch.float64) * float(
        filters.adc_conversion(config)[row])
    d1, _ = ch.series(x)
    sat = ch.saturated(x)
    return sum(bool(sat[i]) for _, _, i, _ in triggers.groups(
        d1, ch.threshold, ch.window))


def test_residual_passes_match_the_port(small_cell, tmp_path):
    cell = small_cell("continuous.residual")
    config = cell.config
    assert cell.traffic["events"] == EVENTS
    paths = gen.write_dumps(str(tmp_path), config, cell.traffic,
                            2**31 + 23, "cpu")
    table, stats = port_table(cell, paths, config)
    # the same run without the residual pass: its triggers are the first
    # pass's (the edge exclusion removes none of either pass)
    first_config = copy.deepcopy(config)
    del first_config["processing"]["trigger"]["Mv2301"]["run_residual"]
    first, _ = port_table(cell, paths, first_config)
    chans = [c for c, _, _ in triggers.trigger_channels(config)]
    assert chans == ["Mv2301", "Mv2302"]

    def events(t):
        return (np.asarray(t["dump_number"]) - 1) * 2 \
            + np.asarray(t["event_number"]) - 1

    ev, ev1 = events(table), events(first)
    assert np.array_equal(np.unique(ev), np.arange(EVENTS))
    second = {c: 0 for c in chans}
    nveto = 0
    for e in range(EVENTS):
        codes = gen.read_events(paths, config, [e])[0]
        ref_found, ref_rows, series = triggers.event_triggers(codes, config,
                                                              "cpu")
        found, rows = checks.table_event(table, ev == e, chans)
        found1, _ = checks.table_event(first, ev1 == e, chans)
        for ch in chans:
            ref1 = sorted(t["index"] for t in ref_found[ch] if t["pass"] == 1)
            ref2 = sorted(t["index"] for t in ref_found[ch] if t["pass"] == 2)
            got1 = sorted(t[0] for t in found1[ch])
            got2 = sorted(set(t[0] for t in found[ch]) - set(got1))
            assert got1 == ref1, (e, ch)
            assert got2 == ref2, (e, ch)
            assert len(found[ch]) == len(ref1) + len(ref2)
            second[ch] += len(ref2)
        assert sorted((r["channel"], r["index"]) for r in rows) == sorted(
            (r["channel"], r["index"]) for r in ref_rows)
        nums = checks.trigger_numbers(found, rows, ref_found, ref_rows,
                                      series, {c: 64.0 for c in chans})
        assert nums["grouping"] == 0 and nums["index_gap"] == 0, nums
        assert nums["dchi2"] < 1e-6 and nums["amp"] < 1e-6, nums
        nveto += vetoed(config, codes)
    # the mechanism has work, and the shell counts it as the reference
    assert second["Mv2301"] >= 20
    assert second["Mv2302"] == 0
    # each event's 4 saturating pulses, at least
    assert nveto >= 4 * EVENTS
    assert stats["residual_triggers"] == second["Mv2301"]
    assert stats["vetoed_triggers"] == nveto
    assert "trigger_edge_exclusion_time_Mv2301" in table


def test_pileup_traffic_lays_out_its_pulses(small_cell):
    """Each event: 128 pulses on Mv2301 and 124 on Mv2302; 40 pairs on
    both channels whose trailer comes 150–540 samples after its leader,
    at least 10,000 samples from any other pulse; slotted pulses at least
    5,000 samples from their slots' edges, moved by the coincident ones'
    ±20 samples; 4 saturating pulses on Mv2301 that stay within int16."""
    cell = small_cell("continuous.residual")
    pulses = gen.continuous_pulses(torch.Generator().manual_seed(5),
                                   cell.config, cell.traffic, EVENTS, "cpu")
    pops = [(r, at.numpy(), amp.numpy()) for r, at, amp in pulses]
    for row, count in ((0, 128), (1, 124)):
        at = np.concatenate([a for r, a, _ in pops if r == row], axis=1)
        assert at.shape == (EVENTS, count)
        lead, trail = [a for r, a, _ in pops if r == row][-2:]
        delay = trail - lead
        assert delay.min() >= 150 and delay.max() <= 540
        partner = {}
        for k in range(lead.shape[1]):
            partner[count - 80 + k] = count - 40 + k
            partner[count - 40 + k] = count - 80 + k
        for e in range(EVENTS):
            gap = np.abs(at[e][:, None] - at[e][None, :]).astype(float)
            np.fill_diagonal(gap, np.inf)
            for i, j in partner.items():
                gap[i, j] = np.inf
            assert gap[count - 80:].min() >= 10000, (row, e)
            assert gap.min() >= 2 * 5000 - 2 * 20, (row, e)
    sat = [amp for r, _, amp in pops if r == 0][2]
    assert sat.shape == (EVENTS, 4)
    assert sat.min() >= 1.05e-5 and sat.max() <= 1.2e-5
    ceiling = 32767 * cell.config["adc_volts_per_bit"] \
        / cell.config["close_loop_norm"][0]
    assert sat.max() < 0.95 * ceiling
