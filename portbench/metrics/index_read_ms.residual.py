"""The trigger shell's host milliseconds a batch in the residual pass's
one host read ("residual.index_read" span: the used-slot bound of the
first pass's triggers, where the dispatch waits for the card)."""

from _readers import stage_ms


def read(ctx):
    return stage_ms(ctx, "residual.index_read")
