"""Build, load and count the hand-written CUDA kernels.

The kernels live in ``detprocess_tpu_torch/csrc/*.cu`` behind a plain C
interface. At first use each source is compiled by its own ``nvcc``, all
started together, and the objects are linked into one shared library
under ``build/torch_kernels/`` at the repository root (rebuilt whenever a
source's hash changes), loaded with :mod:`ctypes`. Nothing
here runs at import time, so the package imports on machines without a
GPU or a CUDA toolkit; a missing toolkit raises at the first launch.

Each C entry returns the ``cudaError_t`` of its launch
(``cudaGetLastError()`` right after it); :func:`check` raises on any
non-zero code. Each kernel has a plain-integer launch count, bumped by
its wrapper right after an accepted launch and nowhere else. Beside them,
each library route (a PyTorch call that serves a CUDA tensor the kernels
do not take, such as cuFFT for a trace length outside the rFFT kernel's
domain, or for float64 traces) has a count of its own, bumped where the
route is taken.
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

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

KERNELS = ("rfft", "fused_nodelay_of")
LIBRARY_ROUTES = ("cufft_rfft", "cufft_rfft_f64")

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


def compile_command(nvcc: str, source: Path, obj: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(source)]


def link_command(nvcc: str, objs: list[Path], output: Path) -> list[str]:
    return [nvcc, *ARCH, "-shared", "-o", str(output),
            *(str(p) for p in objs)]


def build() -> Path:
    """Compile the kernels if the library for the current sources is
    missing; return its path. One ``nvcc`` a source, all started together,
    then one link. The compilers' output (``-Xptxas -v``: registers,
    shared memory and spills per kernel) is kept beside the library as
    ``.log``, in source order."""
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / "lib.so"
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        procs = [subprocess.Popen(compile_command(nvcc, src, obj),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [p.returncode for p in procs if p.returncode != 0]
        if not failed:
            link = subprocess.run(link_command(nvcc, objs, out),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            logs.append(link.stdout)
            failed = [link.returncode] if link.returncode != 0 else []
        log = "".join(logs)
        lib_path.with_suffix(".log").write_text(log)
        if failed:
            raise RuntimeError(
                f"nvcc failed (rc={failed[0]}):\n{log[-4000:]}")
        os.replace(out, lib_path)
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
