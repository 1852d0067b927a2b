"""Optimal-filter bank precomputation (host numpy, float64) and its move
onto a torch device.

The numpy part is a copy of ``detprocess_tpu/ops/filterbank.py``
(``half_bin_weights``, ``notch_bin_mask``, ``OF1x1Bank``,
``make_of1x1_bank``, and for the trigger ``OFNxMBank``,
``make_ofnxm_bank`` and its shape rules); it is a copy because importing
the JAX package needs JAX. Conventions, with two-sided noise PSD J(f_k) [A²/Hz] and unnormalized
FFTs (ṽ = FFT(v), s̃ = FFT(s)):

- ``denom_inv_k = 1 / (N·fs·J_k)``   (zeroed at DC and at notched bins)
- ``phi_k       = conj(s̃_k) · denom_inv_k``
- ``norm        = Σ_k Re(phi_k s̃_k)``   (= 1/σ_amp²)

The device side is complex tensors on the natural half spectrum:
:func:`bank_to_torch` builds them from a bank, :func:`bank_from_jax` from
the JAX package's ``OF1x1Bank.to_device()`` dict (split re/im arrays).
:func:`bank_nxm_from_jax` carries a JAX ``OFNxMBank`` over as the port's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

HALF_BANK_KEYS = ("phi_h", "s_fft_h", "denom_inv_h", "bin_w", "norm")


def half_bin_weights(n: int, dtype=np.float64) -> np.ndarray:
    """Per-bin weights [1, 2, …, 2, 1 (even n)] of length n//2+1 that make
    half-spectrum reductions equal the full-spectrum sum for Hermitian
    spectra."""
    nh = n // 2 + 1
    w = np.full(nh, 2.0, dtype)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    return w


def notch_bin_mask(
    n: int,
    fs: float,
    ignored_frequency_peaks: Optional[Sequence[float]] = None,
    ignore_harmonics: bool = False,
    coupling: str = "AC",
) -> np.ndarray:
    """Boolean mask [n] — True where the frequency bin is KEPT.

    For each ignored frequency the nearest positive- and negative-frequency
    bins (and their mirror partners) are dropped; with ``ignore_harmonics``
    every integer multiple up to Nyquist too. ``coupling='AC'`` drops DC.
    """
    keep = np.ones(n, dtype=bool)
    if str(coupling).upper() != "DC":
        keep[0] = False
    if not ignored_frequency_peaks:
        return keep
    freqs = np.fft.fftfreq(n, d=1.0 / fs)
    nyq = fs / 2.0
    for f0 in ignored_frequency_peaks:
        f0 = abs(float(f0))
        if f0 <= 0:
            continue
        targets = [f0]
        if ignore_harmonics:
            k = 2
            while k * f0 <= nyq:
                targets.append(k * f0)
                k += 1
        for ft in targets:
            for sign in (1.0, -1.0):
                idx = int(np.argmin(np.abs(freqs - sign * ft)))
                keep[idx] = False
                keep[(n - idx) % n] = False
    return keep


class OF1x1Bank(NamedTuple):
    """Stacked single-channel OF precompute over S (channel, template)
    slots; host numpy float64/complex128. N = nb_samples."""

    s_fft: np.ndarray      # [S, N] complex — FFT of templates
    denom_inv: np.ndarray  # [S, N] real — 1/(N·fs·J), 0 at DC/notched bins
    phi: np.ndarray        # [S, N] complex — conj(s_fft)·denom_inv
    norm: np.ndarray       # [S] real — Σ Re(phi·s_fft)
    templates: np.ndarray  # [S, N] real — time-domain templates
    psd: np.ndarray        # [S, N] real — two-sided PSDs
    fs: float
    pretrigger: int

    @property
    def nbins(self) -> int:
        return self.s_fft.shape[-1]

    @property
    def resolution(self) -> np.ndarray:
        """Expected amplitude resolution σ_A = 1/sqrt(norm) per slot."""
        return 1.0 / np.sqrt(self.norm)


def make_of1x1_bank(
    templates: np.ndarray,
    psds: np.ndarray,
    fs: float,
    pretrigger: int,
    integralnorm: bool = False,
    ignored_frequency_peaks: Optional[Sequence[float]] = None,
    ignore_harmonics: bool = False,
    coupling: str = "AC",
) -> OF1x1Bank:
    """Build a stacked 1x1 OF bank from templates [S, N] (or [N]) and
    two-sided PSDs [S, N] (or [N]; inf marks a notch). ``integralnorm``
    normalizes the template FFT by its DC component."""
    templates = np.atleast_2d(np.asarray(templates, dtype=np.float64))
    psds = np.atleast_2d(np.asarray(psds, dtype=np.float64))
    if psds.shape != templates.shape:
        if psds.shape[0] == 1:
            psds = np.broadcast_to(psds, templates.shape).copy()
        elif templates.shape[0] == 1:
            templates = np.broadcast_to(templates, psds.shape).copy()
        else:
            raise ValueError(
                f"template shape {templates.shape} != psd shape {psds.shape}"
            )
    s, n = templates.shape

    s_fft = np.fft.fft(templates, axis=-1)
    if integralnorm:
        dc = s_fft[:, :1].real.copy()
        dc[dc == 0] = 1.0
        s_fft = s_fft / dc

    keep = notch_bin_mask(n, fs, ignored_frequency_peaks, ignore_harmonics,
                          coupling=coupling)
    with np.errstate(divide="ignore", invalid="ignore"):
        denom_inv = 1.0 / (n * fs * psds)
    denom_inv[~np.isfinite(denom_inv)] = 0.0
    denom_inv *= keep[None, :]

    phi = np.conj(s_fft) * denom_inv
    norm = np.real(np.sum(phi * s_fft, axis=-1))

    return OF1x1Bank(
        s_fft=s_fft,
        denom_inv=denom_inv,
        phi=phi,
        norm=norm,
        templates=templates,
        psd=psds,
        fs=float(fs),
        pretrigger=int(pretrigger),
    )


def _complex_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype == torch.float64:
        return torch.complex128
    if dtype == torch.float32:
        return torch.complex64
    raise TypeError(f"bank dtype must be float32 or float64, got {dtype}")


def bank_to_torch(bank: OF1x1Bank, device, dtype=torch.float32) -> dict:
    """Half-spectrum bank tensors on ``device``: ``phi_h``, ``s_fft_h``
    [S, N/2+1] complex, ``denom_inv_h`` [S, N/2+1], ``bin_w`` [N/2+1] and
    ``norm`` [S] real, in ``dtype`` (and its complex counterpart)."""
    cdtype = _complex_dtype(dtype)
    nh = bank.nbins // 2 + 1

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    return {
        "phi_h": put(bank.phi[:, :nh], cdtype),
        "s_fft_h": put(bank.s_fft[:, :nh], cdtype),
        "denom_inv_h": put(bank.denom_inv[:, :nh], dtype),
        "bin_w": put(half_bin_weights(bank.nbins), dtype),
        "norm": put(bank.norm, dtype),
    }


def bank_nxm_to_torch(bank: "OFNxMBank", device,
                      dtype=torch.float32) -> dict:
    """The NxM fits' half-spectrum tensors on ``device`` (the device form
    of the JAX package's ``device_bank_nxm`` :613): ``phi_h`` [C, M,
    N/2+1] and ``icsd_h`` [N/2+1, C, C] complex, ``w_matrix`` and
    ``iw_matrix`` [M, M] and ``bin_w`` [N/2+1] real, in ``dtype`` (and its
    complex counterpart)."""
    cdtype = _complex_dtype(dtype)
    nh = bank.nbins // 2 + 1

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    return {
        "phi_h": put(bank.phi[..., :nh], cdtype),
        "icsd_h": put(bank.icsd[:nh], cdtype),
        "w_matrix": put(bank.w_matrix, dtype),
        "iw_matrix": put(bank.iw_matrix, dtype),
        "bin_w": put(half_bin_weights(bank.nbins), dtype),
    }


def bank_from_jax(dev: dict, device, dtype=torch.float32) -> dict:
    """The same tensors as :func:`bank_to_torch`, from the JAX package's
    ``OF1x1Bank.to_device()`` dict (``phi_h``/``s_fft_h`` as split re/im
    arrays [S, N/2+1, 2]; ``denom_inv_h``, ``bin_w``, ``norm`` real)."""
    cdtype = _complex_dtype(dtype)

    def join(a):
        a = np.asarray(a, dtype=np.float64)
        return torch.as_tensor(a[..., 0] + 1j * a[..., 1], dtype=cdtype,
                               device=device)

    def real(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return {
        "phi_h": join(dev["phi_h"]),
        "s_fft_h": join(dev["s_fft_h"]),
        "denom_inv_h": real(dev["denom_inv_h"]),
        "bin_w": real(dev["bin_w"]),
        "norm": real(dev["norm"]),
    }


def bank_nxm_from_jax(bank) -> "OFNxMBank":
    """The port's :class:`OFNxMBank` from the JAX package's ``OFNxMBank``
    (a named tuple of host numpy fields with the same names)."""
    fields = {name: np.asarray(getattr(bank, name))
              for name in OFNxMBank._fields}
    fields["fs"] = float(bank.fs)
    fields["pretrigger"] = int(bank.pretrigger)
    return OFNxMBank(**fields)


class OFNxMBank(NamedTuple):
    """Multi-channel (C channels), multi-template (M amplitudes) OF
    precompute; host numpy float64/complex128. N = samples."""

    s_fft: np.ndarray      # [C, M, N] complex
    icsd: np.ndarray       # [N, C, C] complex — inverse CSD per frequency
                           # (zeroed at dropped bins)
    phi: np.ndarray        # [C, M, N] complex — conj(J⁻¹ s̃)/(N·fs)
    w_matrix: np.ndarray   # [M, M] real — weight matrix W
    iw_matrix: np.ndarray  # [M, M] real — W⁻¹
    templates: np.ndarray  # [C, M, N] real
    csd: np.ndarray        # [C, C, N] complex two-sided CSD
    fs: float
    pretrigger: int

    @property
    def nbins(self) -> int:
        return self.s_fft.shape[-1]

    @property
    def nchans(self) -> int:
        return self.s_fft.shape[0]

    @property
    def ntmps(self) -> int:
        return self.s_fft.shape[1]

    @property
    def resolution(self) -> np.ndarray:
        """Expected amplitude resolutions sqrt(diag(W⁻¹))."""
        return np.sqrt(np.diag(self.iw_matrix))


def _reshape_template_3d(template: np.ndarray) -> np.ndarray:
    """Accept [N], [1,N], [N,1], or [C,M,N] and return [C,M,N]."""
    template = np.asarray(template, dtype=np.float64)
    if template.ndim == 1:
        return template[None, None, :]
    if template.ndim == 2:
        if template.shape[0] == 1:
            return template.reshape(1, 1, -1)
        if template.shape[1] == 1:
            return template.T.reshape(1, 1, -1)
        raise ValueError(
            f"ambiguous 2D template shape {template.shape}; expected "
            "(C, M, samples), (samples,), (1, samples) or (samples, 1)"
        )
    if template.ndim == 3:
        return template
    raise ValueError(f"bad template ndim: {template.ndim}")


def _reshape_csd_3d(csd: np.ndarray) -> np.ndarray:
    """Accept [N], [1,N], [N,1], or [C,C,N] and return [C,C,N]."""
    csd = np.asarray(csd)
    if csd.ndim == 1:
        return csd[None, None, :].astype(np.complex128)
    if csd.ndim == 2:
        if csd.shape[0] == 1:
            return csd.reshape(1, 1, -1).astype(np.complex128)
        if csd.shape[1] == 1:
            return csd.T.reshape(1, 1, -1).astype(np.complex128)
        raise ValueError(f"ambiguous 2D csd shape {csd.shape}")
    if csd.ndim == 3:
        return csd.astype(np.complex128)
    raise ValueError(f"bad csd ndim: {csd.ndim}")


def make_ofnxm_bank(
    template: np.ndarray,
    csd: np.ndarray,
    fs: float,
    pretrigger: int,
    ignored_frequency_peaks: Optional[Sequence[float]] = None,
    ignore_harmonics: bool = False,
    coupling: str = "AC",
) -> OFNxMBank:
    """Build an NxM optimal-filter bank from templates [C,M,N] and CSD
    [C,C,N] (the precompute of the continuous-data trigger)."""
    tmpl = _reshape_template_3d(template)
    csd3 = _reshape_csd_3d(csd)
    c, m, n = tmpl.shape
    if csd3.shape != (c, c, n):
        raise ValueError(f"csd shape {csd3.shape} != ({c},{c},{n})")

    s_fft = np.fft.fft(tmpl, axis=-1)  # [C, M, N]

    keep = notch_bin_mask(n, fs, ignored_frequency_peaks, ignore_harmonics,
                          coupling=coupling)

    # invert the CSD per kept frequency; dropped bins get a zero inverse
    csd_f = np.moveaxis(csd3, -1, 0)  # [N, C, C]
    icsd = np.zeros_like(csd_f)
    kept_idx = np.where(keep)[0]
    icsd[kept_idx] = np.linalg.inv(csd_f[kept_idx])

    # phi = conj(J⁻¹ s̃)/(N·fs), so that q_i = Σ_{c,k} phi[c,i,k]·ṽ[c,k]
    # equals s̃_i† J⁻¹ ṽ (the conjugate matters when cross-channel terms
    # carry a frequency-dependent phase)
    s_fft_f = np.moveaxis(s_fft, -1, 0)  # [N, C, M]
    js = np.einsum("kab,kbm->kam", icsd, s_fft_f)
    phi = np.moveaxis(np.conj(js) / (n * fs), 0, -1)  # [C, M, N]

    # W[i, j] = Re Σ_k s̃[:, i, k]† J_k⁻¹ s̃[:, j, k] / (N·fs)
    w = np.real(np.einsum("kci,kcj->ij", np.conj(s_fft_f), js)) / (n * fs)
    iw = np.linalg.inv(w)

    return OFNxMBank(
        s_fft=s_fft,
        icsd=icsd,
        phi=phi,
        w_matrix=w,
        iw_matrix=iw,
        templates=tmpl,
        csd=csd3,
        fs=float(fs),
        pretrigger=int(pretrigger),
    )
