"""dIdV models: for now, the current-to-power template conversion and the
energy per unit amplitude that salting scales its templates by.

Copies of ``detprocess_tpu/models/didv.py::convert_template_to_power``
:376 (qetpy.convert_template_to_power) and ``energy_normalization`` :422
(qetpy.get_energy_normalization), host numpy. The dIdV fits and the rest
of the JAX module are still to be ported.
"""

from __future__ import annotations

import numpy as np


def convert_template_to_power(template: np.ndarray, dpdi: np.ndarray,
                              fs: float = None) -> np.ndarray:
    """Current-domain template → power-domain template: the bin-by-bin
    product of its two-sided DFT with dPdI(f), transformed back. ``dpdi``
    is tabulated on the template's two-sided frequency axis; ``fs`` is
    accepted for the qetpy signature (the DFT pair's factors cancel)."""
    s_fft = np.fft.fft(np.asarray(template))
    p_fft = s_fft * np.asarray(dpdi)
    return np.real(np.fft.ifft(p_fft))


def energy_normalization(template: np.ndarray, dpdi: np.ndarray,
                         fs: float) -> float:
    """Energy per unit (current) amplitude of a template: the integral of
    the power-domain template, ∫ p dt in joules."""
    power_template = convert_template_to_power(template, dpdi, fs)
    return float(np.trapezoid(power_template, dx=1.0 / fs))
