"""A reader thread's rate while it reads: the bytes the window's passes
read (every event's stored channels, each pass), in GB, over the
"read.fill" spans' seconds."""

import math

import numpy as np


def read_bytes(ctx):
    """The bytes the shell read in the window: its passes (batches over
    the batches of one pass) times one pass's events of every channel."""
    traffic, config = ctx["traffic"], ctx["config"]
    passes = ctx["stage_batches"] / math.ceil(traffic["events"]
                                              / traffic["batch"])
    return (passes * traffic["events"] * len(config["channels"])
            * config["nb_samples"] * np.dtype(config["stored_dtype"]).itemsize)


def read(ctx):
    sec = ctx["stages"].get("read.fill")
    if not sec or not ctx["stage_batches"]:
        return None
    return read_bytes(ctx) / sec / 1e9
