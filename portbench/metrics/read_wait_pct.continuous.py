"""The shell's main thread waiting for the reader threads ("read"
stage), as a share of the window."""

from _readers import stage_share


def read(ctx):
    return stage_share(ctx, "read")
