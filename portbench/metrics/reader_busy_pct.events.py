"""The feature shell's reader threads busy reading ("read.fill" spans:
from a batch's buffer in hand to its last event read), as a share of
their time: the spans' seconds over the readers times the window."""


def read(ctx):
    sec = ctx["stages"].get("read.fill")
    readers = ctx["traffic"].get("readers")
    if sec is None or not readers or ctx["stage_window_s"] <= 0:
        return None
    return 100.0 * sec / (readers * ctx["stage_window_s"])
