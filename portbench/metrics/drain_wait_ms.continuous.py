"""The trigger shell's host milliseconds a batch blocked on the card in
the drain ("drain.wait" span: until the batch's trigger sets have reached
the host)."""

from _readers import stage_ms


def read(ctx):
    return stage_ms(ctx, "drain.wait")
