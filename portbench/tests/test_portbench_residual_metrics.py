"""The readers of the residual pass's spans: each one's value on a
hand-built context, and None without its span."""

import pytest

import cell as cellmod

SPANS = {"step.LPF + saturation": 0.08, "step.residual convolution": 0.05,
         "step.second merge": 0.03, "residual.index_read": 0.02,
         "drain.combine": 0.06, "dispatch": 0.4, "drain": 0.2}


def context(stages):
    return dict(stages=stages, stage_window_s=2.5, stage_batches=16,
                trace=None, trace_batches=0, traffic={"events": 256},
                config={"channels": ["a", "b"], "nb_samples": 1250000},
                card="cpu")


@pytest.mark.parametrize("name,spans,value", [
    ("residual_ms.residual", ("step.LPF + saturation",
                              "step.residual convolution",
                              "step.second merge"),
     1e3 * (0.08 + 0.05 + 0.03) / 16),
    ("index_read_ms.residual", ("residual.index_read",), 1e3 * 0.02 / 16),
    ("combine_ms.residual", ("drain.combine",), 1e3 * 0.06 / 16),
])
def test_reader_value_and_none_without_its_span(name, spans, value):
    read = cellmod.reader(cellmod.HERE, name)
    assert read(context(dict(SPANS))) == pytest.approx(value, rel=1e-12)
    for span in spans:
        without = {k: v for k, v in SPANS.items() if k != span}
        assert read(context(without)) is None
