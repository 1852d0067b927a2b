"""The trigger shell's host milliseconds a batch in the drain's
per-event combine of first- and residual-pass triggers and its edge
exclusion ("drain.combine" span)."""

from _readers import stage_ms


def read(ctx):
    return stage_ms(ctx, "drain.combine")
