"""The plain reference against a float64 CPU run of the port (its plain
twins), at small sizes: the same columns, triggers and rows."""

import numpy as np

import checks
import gen
from reference import features, triggers
from shells import Program


def port_and_reference(cell, tmp_path, seed):
    paths = gen.write_dumps(str(tmp_path), cell.config, cell.traffic, seed,
                            "cpu")
    program = Program(cell.config, cell.traffic, paths, "cpu")
    table = program.shell.process(batch_size=16, dtype=np.float64)
    codes = gen.read_events(paths, cell.config,
                            range(cell.traffic["events"]))
    got = {k: np.asarray(v, np.float64) for k, v in table.items()
           if np.asarray(v).dtype.kind == "f"}
    return got, features.features(codes, cell.config, cell.traffic, "cpu",
                                  given=got)


def test_features_match_the_port(small_cell, tmp_path):
    """The example's feature pass: of1x1 fits (one interpolated), trace
    stats on a channel and a difference, psd_amp and the NxM fit."""
    cell = small_cell("events.example")
    got, ref = port_and_reference(cell, tmp_path, 21)
    # Mv2301's own block replaces the one it shares with Mv2302: of_fast
    assert {c for c in ref.values if c.endswith("_Mv2301")} == {
        "amp_of_fast_Mv2301", "chi2_of_fast_Mv2301", "lowchi2_of_fast_Mv2301"}
    assert {"t0", "stats", "psd"} <= set(ref.family.values())
    assert "baseline_Mv2301-Mv2302" in ref.values
    for col in ref.values:
        np.testing.assert_allclose(got[col], ref.values[col], rtol=1e-9,
                                   atol=0, err_msg=col)
    assert all(float(g.max()) == 0.0 for g in ref.gaps.values())


def test_every_algorithm_matches_the_port(coverage_cell, tmp_path):
    """The pulse-shape pass: joint, NxM, PSD and rftau fits."""
    cell = coverage_cell
    got, ref = port_and_reference(cell, tmp_path, 23)
    assert set(ref.values) <= set(got)
    assert {"amp", "chi2", "psd", "phase"} <= set(ref.family.values())
    assert any(k.startswith("rftau_") for k in ref.gaps)
    nums = checks.feature_numbers(got, ref)
    assert nums["t0_gap"] == 0, nums
    for fam, err in nums.items():
        # rftau: the 40-step fits against the reference's converged one
        assert err < (1e-2 if fam == "rftau" else 1e-8), (fam, err)
    # the reference's own 40 steps follow the program's
    for col in got:
        if "_rftau_" in col:
            np.testing.assert_allclose(got[col], ref.values[col], rtol=1e-6,
                                       err_msg=col)


def test_triggers_match_the_port(small_cell, tmp_path):
    cell = small_cell("continuous.example")
    paths = gen.write_dumps(str(tmp_path), cell.config, cell.traffic, 22,
                            "cpu")
    program = Program(cell.config, cell.traffic, paths, "cpu")
    table = program.shell.process(event_batch=2, capacity=4096,
                                  dtype=np.float64)
    chans = [c for c, _, _ in triggers.trigger_channels(cell.config)]
    ev = (np.asarray(table["dump_number"]) - 1) * 2 \
        + np.asarray(table["event_number"]) - 1
    assert np.array_equal(np.unique(ev), np.arange(4))
    for e in range(4):
        codes = gen.read_events(paths, cell.config, [e])[0]
        ref_found, ref_rows, series = triggers.event_triggers(
            codes, cell.config, "cpu")
        found, rows = checks.table_event(table, ev == e, chans)
        for ch in chans:
            assert [t[0] for t in found[ch]] == sorted(
                t["index"] for t in ref_found[ch])
        assert sorted((r["channel"], r["index"]) for r in rows) == sorted(
            (r["channel"], r["index"]) for r in ref_rows)
        nums = checks.trigger_numbers(found, rows, ref_found, ref_rows,
                                      series, {c: 64.0 for c in chans})
        assert nums["grouping"] == 0
        assert nums["index_gap"] == 0
        assert nums["dchi2"] < 1e-6 and nums["amp"] < 1e-6
        # the coincidence merge has work: most of the 40 coincident
        # pulses an event (6–20σ on each channel) make rows of both
        assert sum(len(r["members"]) == 2 for r in ref_rows) >= 20
