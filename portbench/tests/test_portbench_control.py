"""Each cell's limits against what they are for: the bfloat16 control
(the reference in the program's place) comes out not correct, a sound run
of the program correct, and a run whose timed path is broken underneath
not correct, once for each fault the cell can have."""

import time

import numpy as np
import pytest

import cell as cellmod
import checks
import control

CELLS = ["events.example", "continuous.example"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(small_cell, tmp_path, name):
    cell = small_cell(name)
    mine, theirs = control.readings(cell, 2**31 + 3, "cpu", str(tmp_path))
    assert checks.judge(mine, cell.limits)[0], mine
    assert not checks.judge(theirs, cell.limits)[0], theirs


def broken_features(monkeypatch, fault):
    from detprocess_tpu_torch.pipelines import feature_group
    forward = feature_group.GroupStep.forward

    def step(self, x, *a, **kw):
        out = forward(self, x, *a, **kw)
        if fault == "altered":
            # one amplitude of each batch off by a hundredth
            col = next(k for k in out if k.startswith("amp_"))
            out[col] = out[col].clone()
            out[col][0] *= 1.01
        else:
            # the second half of the batch left out: its rows repeat the
            # first half's
            half = x.shape[0] // 2
            out = {k: v.clone() for k, v in out.items()}
            for v in out.values():
                v[half:2 * half] = v[:half]
        return out
    monkeypatch.setattr(feature_group.GroupStep, "forward", step)


def broken_triggers(monkeypatch, fault):
    from detprocess_tpu_torch.pipelines import triggers
    drain = triggers.drain_batch

    def drain_batch(channels, sets, admins, *a, **kw):
        table = drain(channels, sets, admins, *a, **kw)
        if table is None:
            return table
        if fault == "altered":
            # one amplitude of each batch off by a hundredth
            col = "trigger_amplitude_Mv2302"
            table[col] = table[col].copy()
            row = int(np.flatnonzero(np.isfinite(table[col]))[0])
            table[col][row] *= 1.01
        else:
            # the second half of the batch's events left out
            gone = {(a_["dump_number"], a_["event_number"])
                    for a_ in admins[len(admins) // 2:]}
            sel = np.array([(d, e) not in gone for d, e in zip(
                table["dump_number"], table["event_number"])], bool)
            table = {k: v[sel] for k, v in table.items()}
        return table
    monkeypatch.setattr(triggers, "drain_batch", drain_batch)


@pytest.mark.parametrize("fault", ["sound", "altered", "half_batch"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(small_cell, monkeypatch, name, fault):
    cell = small_cell(name)
    if fault != "sound":
        (broken_features if cell.traffic["shell"] == "features"
         else broken_triggers)(monkeypatch, fault)
    result = cellmod.run(cell, 2**31 + 5, 0.01, False, "cpu",
                         time.perf_counter(), log=lambda m: None)
    assert result["correct"] is (fault == "sound"), result["checks"]
