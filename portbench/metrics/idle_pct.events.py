"""The share of the traced window in which no kernel, copy or set ran on
the device (CUPTI intervals from torch.profiler)."""

from _readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
