"""The trigger shell's host milliseconds a batch filling the pinned
buffer ("dispatch.fill" span: a buffer from the ring, the events copied
into it, the conversion factors stacked)."""

from _readers import stage_ms


def read(ctx):
    return stage_ms(ctx, "dispatch.fill")
