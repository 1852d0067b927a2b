"""The readers of the port's spans: each one's value on a hand-built
context and None without its span, and ``reader_gbps.events``'s bytes
against what the feature shell counts it read."""

import numpy as np
import pytest

import cell as cellmod
import gen
from detprocess_tpu_torch.utils.logging import StageTimer

SPANS = {"read.fill": 6.0, "upload.pin": 0.4,
         "dispatch.fill": 0.12, "dispatch.enqueue": 0.2, "drain.wait": 0.04,
         "dispatch": 0.33, "drain": 0.1}


def reader(name):
    return cellmod.reader(cellmod.HERE, name)


def context(stages):
    traffic = {"events": 65536, "batch": 8192, "readers": 4}
    config = {"channels": ["a", "b"], "nb_samples": 4096,
              "stored_dtype": "int16"}
    return dict(stages=stages, stage_window_s=2.5, stage_batches=16,
                trace=None, trace_batches=0, traffic=traffic, config=config,
                card="cpu")


@pytest.mark.parametrize("name,span,value", [
    ("reader_busy_pct.events", "read.fill", 100 * 6.0 / (4 * 2.5)),
    # 16 batches are 2 passes of 65536 events of 2 × 4096 int16 samples
    ("reader_gbps.events", "read.fill", 2 * 65536 * 2 * 4096 * 2 / 6.0 / 1e9),
    ("pin_ms.events", "upload.pin", 1e3 * 0.4 / 16),
    ("fill_ms.continuous", "dispatch.fill", 1e3 * 0.12 / 16),
    ("enqueue_ms.continuous", "dispatch.enqueue", 1e3 * 0.2 / 16),
    ("drain_wait_ms.continuous", "drain.wait", 1e3 * 0.04 / 16),
])
def test_reader_value_and_none_without_its_span(name, span, value):
    read = reader(name)
    assert read(context(dict(SPANS))) == pytest.approx(value, rel=1e-12)
    without = {k: v for k, v in SPANS.items() if k != span}
    assert read(context(without)) is None


def test_reader_gbps_bytes_are_the_bytes_read(small_cell, tmp_path):
    """On a small CPU run of the feature shell: the bytes the reader
    derives from the traffic and the configuration are those the shell
    counts it read (``stats["read_bytes"]``)."""
    from shells import Program
    cell = small_cell("events.example")
    paths = gen.write_dumps(str(tmp_path), cell.config, cell.traffic,
                            2**31 + 11, "cpu")
    program = Program(cell.config, cell.traffic, paths, "cpu")
    timer, read = StageTimer(), 0
    for _ in range(2):
        program.run_pass(timer)
        read += program.shell.stats["read_bytes"]
    stages = {k: v["seconds"] for k, v in timer.report(log=False).items()}
    assert stages["read.fill"] > 0
    ctx = dict(stages={"read.fill": 1.0}, stage_window_s=1.0,
               stage_batches=program.batches, trace=None, trace_batches=0,
               traffic=cell.traffic, config=cell.config, card="cpu")
    derived = reader("reader_gbps.events")(ctx) * 1e9
    assert derived == pytest.approx(read, rel=1e-12)
    assert read == 2 * cell.traffic["events"] * np.prod(
        [len(cell.config["channels"]), cell.config["nb_samples"], 2])
