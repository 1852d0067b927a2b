"""The fused no-delay fit (csrc/fused_nodelay_of.cu) at its roofline:
the least time of the fits the traffic needs
(roofline.work("fused_nodelay_of")) over the device time of the kernels
named ``fused_nodelay_kernel``."""

from _readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "fused_nodelay_of", r"\bfused_nodelay_kernel\b")
