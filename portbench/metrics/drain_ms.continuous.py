"""The trigger shell's host milliseconds a batch in ``drain_batch``
(residual combine, edge exclusion, sort, coincidence merge, metadata)."""

from _readers import stage_ms


def read(ctx):
    return stage_ms(ctx, "drain")
