"""The feature shell's drain of finished batches into the table ("drain"
stage), as a share of the window."""

from _readers import stage_share


def read(ctx):
    return stage_share(ctx, "drain")
