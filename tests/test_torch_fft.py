"""The port's real FFTs equal the JAX package's, and the rFFT kernel's
wrapper takes only what the CUDA kernel takes.

On a CPU tensor ``ops.fft.rfft`` is the kernel's plain twin
(``torch.fft.rfft``); it is held to ``detprocess_tpu.ops.fft.rfft`` in
float64 and to the TPU kernel it replaces, ``fft_pallas``, run in
interpret mode as tests/test_pallas_kernels.py runs it. The CUDA kernel
itself runs only on the GPU (``python3 chip_smoke.py`` compares it with
the same twin there); its index maps and arithmetic are held here by the
numpy model of its steps in tests/fused_model.py, which it shares with
the fused kernel (the same FFT core, csrc/fft_regs.cuh).
"""

import re
import types
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import fused_model as fm
from detprocess_tpu.ops import fft as dfft
from detprocess_tpu.ops.pallas_fft import fft_pallas
from detprocess_tpu_torch.ops import _kernels, cuda_fft, fft

torch.set_num_threads(1)

CSRC = Path(cuda_fft.__file__).resolve().parent.parent / "csrc"


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


def _table(n):
    """The kernel's twiddle table W_N^k (k < N/2) in float64."""
    return np.exp(-2j * np.pi * np.arange(n // 2) / n)


@pytest.mark.parametrize("n", cuda_fft.SUPPORTED_N)
def test_kernel_model_matches_numpy_rfft(n):
    """The model of csrc/rfft.cu (fft_regs.cuh's passes, the paired
    untangle and its store map) is the exact rFFT in float64."""
    x = np.random.default_rng(n).standard_normal((3, n))
    got = fm.rfft_spectrum(x, _table(n))
    ref = np.fft.rfft(x)
    assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref))


@pytest.mark.parametrize("n", [16384, 32768])
def test_kernel_model_float32_matches_numpy_rfft(n):
    """In complex64 (the kernel's roundings, the float32 table's and the
    twiddle products' included) the model stays within the card's
    tolerance, 1e-5 of max|X|, at the trigger segments' lengths."""
    x = np.random.default_rng(n + 3).standard_normal((2, n)).astype(
        np.float32)
    got = fm.rfft_spectrum(x, _table(n).astype(np.complex64), np.complex64)
    assert got.dtype == np.complex64
    ref = np.fft.rfft(x.astype(np.float64))
    assert np.max(np.abs(got - ref)) <= 1e-5 * np.max(np.abs(ref))


def test_kernel_model_matches_pallas_fft_interpret():
    n1, n2 = 64, 32
    n = n1 * n2
    x = np.random.default_rng(7).standard_normal((16, n)).astype(np.float32)
    re_, im = fft_pallas(jnp.asarray(x), n1, n2, tile=8, interpret=True)
    full = np.asarray(re_, np.float64) + 1j * np.asarray(im, np.float64)
    half = full[:, : n // 2 + 1]          # natural order (see above)
    tw = cuda_fft.twiddles(n, torch.device("cpu")).numpy()
    got = fm.rfft_spectrum(x.astype(np.float64), tw.astype(np.complex128))
    assert np.max(np.abs(got - half)) / np.max(np.abs(half)) <= 1e-5


@pytest.mark.parametrize("n", cuda_fft.SUPPORTED_N)
def test_kernel_store_map_writes_each_bin_once(n):
    """rfft.cu's threads write each of the M + 1 bins exactly once, a
    warp's lanes on consecutive bins (one run ascending, one descending),
    and the model leaves no bin unwritten."""
    m = n // 2
    pairs, mid = fm.rfft_store_map(m)
    assert pairs.shape == (m // 16, 8, 2)
    bins = np.concatenate([pairs.ravel(), [mid]])
    assert np.array_equal(np.sort(bins), np.arange(m + 1))
    assert np.all(np.diff(pairs[..., 0], axis=0) == 1)
    assert np.all(np.diff(pairs[..., 1], axis=0) == -1)
    x = np.random.default_rng(n).standard_normal((1, n))
    assert not np.isnan(fm.rfft_spectrum(x, _table(n))).any()


def test_kernel_source_runs_on_the_register_core():
    src = (CSRC / "rfft.cu").read_text()
    assert re.findall(r'#include\s+[<"]([^>"]+)', src) == ["fft_regs.cuh"]
    for step in ("dpr::load_first", "dpr::first_pass", "dpr::other_passes"):
        assert step in src
    assert not (CSRC / "rfft_smem.cuh").exists()
    assert sorted(p.name for p in CSRC.glob("*.cuh")) == ["fft_regs.cuh"]


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
    assert _kernels.library_counts() == {"cufft_rfft": 0,
                                         "cufft_rfft_f64": 0}


@pytest.mark.parametrize("n,dtype,contiguous,route", [
    (32768, torch.float32, True, "kernel"),
    (256, torch.float32, True, "kernel"),
    (300, torch.float32, True, "cufft"),
    (25000, torch.float32, True, "cufft"),
    (65536, torch.float32, True, "cufft"),
    (32768, torch.float64, True, "cufft_f64"),
    (25000, torch.float64, True, "cufft_f64"),
    (32768, torch.float64, False, "cufft_f64"),
    (32768, torch.float16, True, "raises"),
    (32768, torch.float32, False, "kernel"),
])
def test_rfft_cuda_route_by_shape(monkeypatch, n, dtype, contiguous, route):
    """On a CUDA tensor ``ops/fft.rfft`` routes by dtype and length: float32
    at the kernel's lengths goes to the kernel (a view made contiguous),
    float32 at any other length to torch.fft.rfft as ``cufft_rfft``,
    float64 at any length to torch.fft.rfft as ``cufft_rfft_f64`` (the port
    of JAX's float64 XLA FFT), another dtype is refused by name; each route
    is counted: the kernel's launches and each library route's calls. The C
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
    x = torch.randn(3, 2 * n)[:, ::2] if not contiguous \
        else torch.randn(3, n)
    x = x.to(dtype)
    zero = {"cufft_rfft": 0, "cufft_rfft_f64": 0}
    _kernels.reset_launch_counts()
    if route == "raises":
        with pytest.raises(TypeError, match="float32 or float64"):
            fft.rfft_cuda(x)
        assert calls == []
        assert _kernels.library_counts() == zero
        return
    monkeypatch.setattr(cuda_fft, "check_kernel_input", check_contiguous)
    out = fft.rfft_cuda(x)
    assert out.shape == (3, n // 2 + 1)
    assert len(calls) == (route == "kernel")
    assert _kernels.launch_counts() == {"rfft": int(route == "kernel"),
                                        "fused_nodelay_of": 0}
    assert _kernels.library_counts() == {
        "cufft_rfft": int(route == "cufft"),
        "cufft_rfft_f64": int(route == "cufft_f64")}
    if route != "kernel":
        assert out.dtype == (torch.complex128 if dtype == torch.float64
                             else torch.complex64)
        np.testing.assert_array_equal(out.numpy(),
                                      torch.fft.rfft(x).numpy())
    _kernels.reset_launch_counts()
    assert _kernels.library_counts() == zero


def test_rfft_kernel_refuses_float64():
    """The kernel's wrapper itself still refuses float64 traces with a
    TypeError before it looks at the device; only ``ops/fft.rfft`` routes
    them to cuFFT."""
    _kernels.reset_launch_counts()
    with pytest.raises(TypeError, match="float32"):
        cuda_fft.rfft_kernel(torch.zeros(3, 32768, dtype=torch.float64))
    assert _kernels.launch_counts()["rfft"] == 0


@pytest.mark.parametrize("method,batch,entry,counted", [
    ("rfft_kernel", 3, "dp_rfft_f32", 1),
    ("rfft_kernel", 0, None, 0),
    ("rfft_phase_clocks", 3, "dp_rfft_stamped_f32", 0)])
def test_rfft_counts_only_main_path_launches(monkeypatch, method, batch,
                                             entry, counted):
    """The wrapper adds one to the launch count where it launches the
    main-path kernel, and nowhere else: not for an empty batch (nothing is
    launched) and not for the stamped instance, whose stamps [B, 3] it
    hands to the kernel and returns. The C library, the device check and
    the stream are stood in for on the CPU."""
    calls = []

    def stand_in(name):
        def launch(*args):
            calls.append((name, args))
            return 0
        return launch

    lib = types.SimpleNamespace(
        dp_rfft_f32=stand_in("dp_rfft_f32"),
        dp_rfft_stamped_f32=stand_in("dp_rfft_stamped_f32"))
    monkeypatch.setattr(_kernels, "lib", lambda: lib)
    monkeypatch.setattr(cuda_fft, "check_kernel_input",
                        lambda x, name: x.shape[-1])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    x = torch.zeros(batch, 1024, dtype=torch.float32)
    _kernels.reset_launch_counts()
    out = getattr(cuda_fft, method)(x)
    assert [name for name, _ in calls] == ([entry] if entry else [])
    assert _kernels.launch_counts() == {"rfft": counted,
                                        "fused_nodelay_of": 0}
    if method == "rfft_phase_clocks":
        assert out.shape == (batch, len(cuda_fft.PHASES)) == (3, 3)
        assert out.dtype == torch.int64
        assert calls[0][1][3] == out.data_ptr()
    else:
        assert out.shape == (batch, 513) and out.dtype == torch.complex64


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
    src = _kernels.sources()[0]
    cmd = _kernels.compile_command("nvcc", src, src.with_suffix(".o"))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-c" in cmd
    link = _kernels.link_command("nvcc", [src.with_suffix(".o")],
                                 _kernels.library_path())
    assert "arch=compute_90a,code=sm_90a" in link and "-shared" in link
    assert _kernels.library_path().parent == _kernels.BUILD_DIR
