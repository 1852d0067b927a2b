"""The trigger shell's host milliseconds a batch in the residual pass's
layers of the trigger step ("step.LPF + saturation", "step.residual
convolution" and "step.second merge" spans: the veto's low-pass and mask,
the subtraction of the first pass's responses, the merge on what is
left)."""

from _readers import stage_ms

LAYERS = ("step.LPF + saturation", "step.residual convolution",
          "step.second merge")


def read(ctx):
    parts = [stage_ms(ctx, name) for name in LAYERS]
    return None if None in parts else sum(parts)
