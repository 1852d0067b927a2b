"""Helpers the per-layer metric readers share. A reader is a file
``metrics/<metric>.py`` with ``read(ctx)``, returning the metric's value
or None when its run has nothing to read. ``ctx`` holds:

- ``stages``: {stage: host seconds} the shell's StageTimer added up over
  the untraced half of the window, ``stage_window_s`` that half's length
  and ``stage_batches`` the batches the shell ran in it;
- ``trace``: a :class:`profile_trace.Trace` of the traced half (None without);
  ``trace_batches`` the batches in it;
- ``traffic``, ``config`` and ``card`` (the device's name).
"""

import roofline


def stage_share(ctx, stage):
    """The stage's host seconds as a share of the window, in %."""
    sec = ctx["stages"].get(stage)
    if sec is None or ctx["stage_window_s"] <= 0:
        return None
    return 100.0 * sec / ctx["stage_window_s"]


def stage_ms(ctx, stage):
    """The stage's host milliseconds a batch."""
    sec = ctx["stages"].get(stage)
    if sec is None or not ctx["stage_batches"]:
        return None
    return 1e3 * sec / ctx["stage_batches"]


def idle_pct(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline_pct(ctx, kernel, pattern):
    """The least time of the kernel's work in the traced half (the
    traffic's transforms a batch, times its batches) over the device
    time of the kernels named by ``pattern``, in %."""
    tr = ctx["trace"]
    calls = ctx["traffic"].get("transforms", {}).get(kernel)
    if tr is None or not calls or not ctx["trace_batches"]:
        return None
    spent = tr.kernel_seconds(pattern)
    least = roofline.bound_seconds(kernel, calls, ctx["card"])
    if spent <= 0 or least is None:
        return None
    return 100.0 * least[0] * ctx["trace_batches"] / spent
