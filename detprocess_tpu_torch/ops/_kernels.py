"""Build, load and count the hand-written CUDA kernels.

The kernels live in ``detprocess_tpu_torch/csrc/*.cu`` behind a plain C
interface. At first use they are compiled by ``nvcc`` into one shared
library under ``build/torch_kernels/`` at the repository root (rebuilt
whenever a source's hash changes) and loaded with :mod:`ctypes`. Nothing
here runs at import time, so the package imports on machines without a
GPU or a CUDA toolkit; a missing toolkit raises at the first launch.

Each C entry returns the ``cudaError_t`` of its launch
(``cudaGetLastError()`` right after it); :func:`check` raises on any
non-zero code. Each kernel has a plain-integer launch count, bumped by
its wrapper right after an accepted launch and nowhere else. Beside them,
each library route (a PyTorch call that serves a CUDA tensor the kernels
do not take, such as cuFFT for a trace length outside the rFFT kernel's
domain) has a count of its own, bumped where the route is taken.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("rfft", "fused_nodelay_of")
LIBRARY_ROUTES = ("cufft_rfft",)

_launches = {name: 0 for name in KERNELS}
_library_calls = {name: 0 for name in LIBRARY_ROUTES}
_lib = None


def count_launch(name: str) -> None:
    """Add one to ``name``'s launch count (called by its wrapper only)."""
    _launches[name] += 1


def count_library_call(name: str) -> None:
    """Add one to library route ``name``'s count (called where the route
    is taken only)."""
    _library_calls[name] += 1


def reset_launch_counts() -> None:
    """Set every kernel's launch count and every library route's count
    to 0."""
    for counts in (_launches, _library_calls):
        for name in counts:
            counts[name] = 0


def launch_counts() -> dict:
    return dict(_launches)


def library_counts() -> dict:
    return dict(_library_calls)


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    """Hash of every kernel source and header plus the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libdetprocess_kernels_{source_hash()}.so"


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    toolkit = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if nvcc is None and os.path.exists(toolkit):
        nvcc = toolkit
    if nvcc is None:
        raise RuntimeError(
            f"nvcc not found (looked on PATH and at {toolkit}): the CUDA "
            "kernels of detprocess_tpu_torch cannot be built")
    return nvcc


def nvcc_command(nvcc: str, output: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output),
            *(str(p) for p in sources())]


def build() -> Path:
    """Compile the kernels if the library for the current sources is
    missing; return its path. The compiler's output (``-Xptxas -v``:
    registers, shared memory and spills per kernel) is kept beside the
    library as ``.log``."""
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(nvcc, Path(tmp)),
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        lib_path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (rc={proc.returncode}):\n{log[-4000:]}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def build_log() -> str:
    """The compiler output of the current library's build ('' if none)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        handle.dp_rfft_f32.argtypes = [p, p, p, ll, i, i, p]
        handle.dp_rfft_f32.restype = i
        handle.dp_rfft_stamped_f32.argtypes = [p, p, p, p, ll, i, i, p]
        handle.dp_rfft_stamped_f32.restype = i
        handle.dp_fused_nodelay_of_f32.argtypes = [p, p, p, p, i, ll, i, p,
                                                   p, i, p]
        handle.dp_fused_nodelay_of_f32.restype = i
        handle.dp_fused_nodelay_of_stamped_f32.argtypes = [p, p, p, p, i, ll,
                                                           i, p, p, p, i, p]
        handle.dp_fused_nodelay_of_stamped_f32.restype = i
        handle.dp_error_string.argtypes = [i]
        handle.dp_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(code: int, name: str) -> None:
    """Raise if a kernel's C entry reported a CUDA error."""
    if code != 0:
        msg = lib().dp_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: cudaError {code} "
                           f"({msg})")
