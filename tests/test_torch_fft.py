"""The port's real FFTs equal the JAX package's, and the rFFT kernel's
wrapper takes only what the CUDA kernel takes.

On a CPU tensor ``ops.fft.rfft`` is the kernel's plain twin
(``torch.fft.rfft``); it is held to ``detprocess_tpu.ops.fft.rfft`` in
float64 and to the TPU kernel it replaces, ``fft_pallas``, run in
interpret mode as tests/test_pallas_kernels.py runs it. The CUDA kernel
itself runs only on the GPU (``python3 chip_smoke.py`` compares it with
the same twin there); its index math is held here by a numpy model of
the kernel's steps.
"""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from detprocess_tpu.ops import fft as dfft
from detprocess_tpu.ops.pallas_fft import fft_pallas
from detprocess_tpu_torch.ops import _kernels, cuda_fft, fft

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [256, 2048, 2046, 16384])
def test_rfft_matches_jax_f64(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, 2, n))
    got = fft.rfft(torch.as_tensor(x))
    ref = np.asarray(dfft.rfft(jnp.asarray(x)))
    assert got.shape == ref.shape == (3, 2, n // 2 + 1)
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-9 * np.max(np.abs(ref)))


@pytest.mark.parametrize("n1,n2", [(64, 32), (32, 32)])
def test_rfft_matches_pallas_fft_interpret(n1, n2):
    rng = np.random.default_rng(n1 * n2)
    n = n1 * n2
    x = rng.standard_normal((16, n)).astype(np.float32)
    re, im = fft_pallas(jnp.asarray(x), n1, n2, tile=8, interpret=True)
    full = np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)
    # the kernel stores bin k1 + n1·k2 at position k2·n1 + k1: reorder
    # to natural order (it is already natural in this flattening) and
    # keep the non-negative half
    k1 = np.arange(n1)[None, :]
    k2 = np.arange(n2)[:, None]
    pos = (k2 * n1 + k1).ravel()
    natural = np.empty_like(full)
    natural[:, (k1 + n1 * k2).ravel()] = full[:, pos]
    half = natural[:, : n // 2 + 1]
    got = fft.rfft(torch.as_tensor(x)).numpy().astype(np.complex128)
    rel = np.max(np.abs(got - half)) / np.max(np.abs(half))
    assert rel <= 1e-5


def stockham_model(z, tw):
    """The in-place radix-4 Stockham stages of csrc/rfft_smem.cuh
    (fft_smem, one radix-2 stage first when log2(M) is odd) on z [..., M],
    reading the table tw = W_{2M}^k, k < M."""
    mp = z.shape[-1]
    log2m = mp.bit_length() - 1
    stages = ([(2, 0)] if log2m & 1 else []) + [
        (4, lns) for lns in range(log2m & 1, log2m, 2)]
    for radix, lns in stages:
        nb, ns = mp // radix, 1 << lns
        lr = 2 if radix == 4 else 1
        j = np.arange(nb)
        k = j & (ns - 1)
        w = tw[2 * (k << (log2m - lns - lr))]
        v = [z[..., j + r * nb] * w ** r for r in range(radix)]
        y = [sum(v[r] * np.exp(-2j * np.pi * r * q / radix)
                 for r in range(radix)) for q in range(radix)]
        z = np.empty_like(z)
        base = (j - k) * radix + k
        for q in range(radix):
            z[..., base + q * ns] = y[q]
    return z


def kernel_rfft_model(x, tw):
    """csrc/rfft.cu step by step: the trace packed as M = N/2 complex
    values, the Stockham stages, the untangle and the Nyquist bin, with
    ``tw`` = W_N^k (k < M), the kernel's table."""
    m = x.shape[-1] // 2
    zz = stockham_model(x[..., 0::2] + 1j * x[..., 1::2], tw)
    k = np.arange(m)
    zk, zr = zz, np.conj(zz[..., (m - k) & (m - 1)])
    out = np.empty(x.shape[:-1] + (m + 1,), dtype=np.complex128)
    out[..., :m] = 0.5 * (zk + zr) - 0.5j * tw[k] * (zk - zr)
    out[..., m] = zz[..., 0].real - zz[..., 0].imag
    return out


@pytest.mark.parametrize("n", cuda_fft.SUPPORTED_N)
def test_kernel_model_matches_numpy_rfft(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n))
    tw = np.exp(-2j * np.pi * np.arange(n // 2) / n)   # float64 table
    got = kernel_rfft_model(x, tw)
    ref = np.fft.rfft(x)
    assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref))


def test_kernel_model_matches_pallas_fft_interpret():
    n1, n2 = 64, 32
    n = n1 * n2
    x = np.random.default_rng(7).standard_normal((16, n)).astype(np.float32)
    re, im = fft_pallas(jnp.asarray(x), n1, n2, tile=8, interpret=True)
    full = np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)
    half = full[:, : n // 2 + 1]          # natural order (see above)
    tw = cuda_fft.twiddles(n, torch.device("cpu")).numpy()
    got = kernel_rfft_model(x.astype(np.float64), tw.astype(np.complex128))
    assert np.max(np.abs(got - half)) / np.max(np.abs(half)) <= 1e-5


@pytest.mark.parametrize("n", [2048, 2047])
def test_irfft_matches_jax_f64(n):
    rng = np.random.default_rng(n)
    spec = np.fft.rfft(rng.standard_normal((4, n)))
    got = fft.irfft(torch.as_tensor(spec), n)
    ref = np.asarray(dfft.irfft(jnp.asarray(spec), n))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-12 * np.max(np.abs(ref)))


def test_rfft_on_cpu_launches_no_kernel():
    _kernels.reset_launch_counts()
    fft.rfft(torch.ones(4, 256, dtype=torch.float32))
    assert _kernels.launch_counts() == {name: 0 for name in _kernels.KERNELS}
    assert _kernels.library_counts() == {"cufft_rfft": 0}


@pytest.mark.parametrize("n,dtype,contiguous,route", [
    (32768, torch.float32, True, "kernel"),
    (256, torch.float32, True, "kernel"),
    (300, torch.float32, True, "cufft"),
    (25000, torch.float32, True, "cufft"),
    (65536, torch.float32, True, "cufft"),
    (32768, torch.float64, True, "raises"),
    (32768, torch.float32, False, "kernel"),
])
def test_rfft_cuda_route_by_shape(monkeypatch, n, dtype, contiguous, route):
    """On a CUDA tensor ``ops/fft.rfft`` routes by length alone: the
    kernel's lengths go to the kernel (a view made contiguous, another
    type than float32 refused), any other to torch.fft.rfft, each route
    counted: the kernel's launches and the library route's calls. The C
    library, the device check and the stream are stood in for on the
    CPU."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(_kernels, "lib",
                        lambda: types.SimpleNamespace(dp_rfft_f32=entry))
    def check_contiguous(x, name):
        assert x.is_contiguous() and x.dtype == torch.float32
        return x.shape[-1]

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    x = torch.randn(3, 2 * n, dtype=dtype)[:, ::2] if not contiguous \
        else torch.randn(3, n, dtype=dtype)
    _kernels.reset_launch_counts()
    if route == "raises":
        # the real check refuses the type before it looks at the device
        with pytest.raises(TypeError, match="float32"):
            fft.rfft_cuda(x)
        assert calls == []
        assert _kernels.library_counts() == {"cufft_rfft": 0}
        return
    monkeypatch.setattr(cuda_fft, "check_kernel_input", check_contiguous)
    out = fft.rfft_cuda(x)
    assert out.shape == (3, n // 2 + 1)
    assert len(calls) == (route == "kernel")
    assert _kernels.launch_counts() == {"rfft": int(route == "kernel"),
                                        "fused_nodelay_of": 0}
    assert _kernels.library_counts() == {"cufft_rfft": int(route == "cufft")}
    if route == "cufft":
        np.testing.assert_array_equal(out.numpy(),
                                      torch.fft.rfft(x).numpy())
    _kernels.reset_launch_counts()
    assert _kernels.library_counts() == {"cufft_rfft": 0}


@pytest.mark.parametrize("x,err,match", [
    (torch.zeros(2, 300), ValueError, "power of two"),
    (torch.zeros(2, 65536), ValueError, "power of two"),
    (torch.zeros(2, 1024, dtype=torch.float64), TypeError, "float32"),
    (torch.zeros(1024, 2).t(), ValueError, "contiguous"),
    (torch.zeros(2, 1024), ValueError, "CUDA tensors"),
])
def test_rfft_kernel_rejects_what_the_kernel_does_not_take(x, err, match):
    with pytest.raises(err, match=match):
        cuda_fft.rfft_kernel(x)


def test_supported_lengths():
    assert cuda_fft.SUPPORTED_N == tuple(2 ** p for p in range(8, 16))


def test_twiddle_table():
    n = 1024
    tw = cuda_fft.twiddles(n, torch.device("cpu"))
    assert tw.dtype == torch.complex64 and tw.shape == (n // 2,)
    ref = np.exp(-2j * np.pi * np.arange(n // 2) / n)
    np.testing.assert_allclose(tw.numpy(), ref, rtol=0, atol=1e-7)


def test_kernel_build_is_not_triggered_by_import():
    # importing the package and calling the CPU paths must not look for
    # nvcc or load the library
    assert _kernels._lib is None
    assert all(str(p).endswith(".cu") for p in _kernels.sources())
    assert {p.name for p in _kernels.sources()} == {"rfft.cu",
                                                     "fused_nodelay_of.cu"}
    cmd = _kernels.nvcc_command("nvcc", _kernels.library_path())
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert _kernels.library_path().parent == _kernels.BUILD_DIR
