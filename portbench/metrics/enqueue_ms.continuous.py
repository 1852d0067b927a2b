"""The trigger shell's host milliseconds a batch enqueueing the card's
work ("dispatch.enqueue" span: the upload, each channel's trigger step,
the packed copy of the trigger sets back)."""

from _readers import stage_ms


def read(ctx):
    return stage_ms(ctx, "dispatch.enqueue")
