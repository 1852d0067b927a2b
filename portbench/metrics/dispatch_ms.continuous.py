"""The trigger shell's host milliseconds a batch to fill the pinned
buffer, upload and enqueue every channel's step ("dispatch" stage)."""

from _readers import stage_ms


def read(ctx):
    return stage_ms(ctx, "dispatch")
