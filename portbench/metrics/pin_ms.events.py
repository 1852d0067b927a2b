"""The feature shell's host milliseconds a batch making pinned host
memory ("upload.pin" spans, on every thread: the reader threads' ring
buffers, the batch's output columns, the conversion factors)."""

from _readers import stage_ms


def read(ctx):
    return stage_ms(ctx, "upload.pin")
