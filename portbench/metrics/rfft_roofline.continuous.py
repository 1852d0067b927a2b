"""The rFFT kernel (csrc/rfft.cu) at its roofline: the least time of the
transforms the traffic needs (roofline.work("rfft")) over the device
time of the kernels named ``rfft_kernel``."""

from _readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "rfft", r"\brfft_kernel\b")
