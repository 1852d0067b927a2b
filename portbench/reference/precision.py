"""The arithmetic a reference runs in: float64, or bfloat16 storage.

``"float64"`` is the reference. ``"bfloat16"`` is the control: the same
code with every stored array (inputs, filters, spectra, products,
results) rounded to bfloat16 and the arithmetic between roundings in
float32, as a bfloat16 path would store its tensors.
"""

from __future__ import annotations

import torch

PRECISIONS = ("float64", "bfloat16")


class Arith:
    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.real = torch.float64 if precision == "float64" else torch.float32
        self.complex = (torch.complex128 if precision == "float64"
                        else torch.complex64)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` stored in this precision."""
        if self.precision == "float64":
            return x
        if x.is_complex():
            return torch.complex(self.r(x.real), self.r(x.imag))
        return x.to(torch.bfloat16).to(torch.float32)

    def put(self, a, device, complex_: bool = False) -> torch.Tensor:
        """A host array as a stored tensor on ``device``."""
        t = torch.as_tensor(a, dtype=self.complex if complex_ else self.real,
                            device=device)
        return self.r(t)
