"""Build and bind the port's hand-written CUDA kernels (csrc/*.cu).

The sources compile with `nvcc` into one shared library with a plain C
interface, loaded with ctypes: no PyTorch headers, so a build takes
seconds. The library lands in `pnr_tpu_torch/_build/` under a name keyed
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. A failed build raises with nvcc's stderr.

Every C entry point takes device pointers and the CUDA stream as
`c_void_p`, sizes as `c_int`, launches on that stream without
synchronising, and returns `cudaGetLastError()`; `check` turns a
non-zero code into an exception.

The wrappers may be called from several host threads at once (the batch
driver's prefetch workers launch the front half's kernels on their own
streams while the main thread traces): the library loads once under a
lock, and every launch counter is added to under `COUNT_LOCK`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

#: no --use_fast_math: the Frangi exponentials, acosf and the FLT_MIN
#: gating of the correlation depend on IEEE expf/sqrtf/division and on
#: denormals not being flushed
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "pnr_frangi_scale": (
        _P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _F, _F, _F, _F, _I, _I, _I,
        _P, _P, _P, _P, _P, _P, _P,
    ),
    "pnr_frangi_smem_bytes": (_I, _I, _I, _I),
    "pnr_exact_sums_prepare": (_I, _I, _I, _I, _I, _I, _I, _I),
    "pnr_exact_sums": (
        _P, _I, _I, _I, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
    ),
    "pnr_tube_corr": (_P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P),
    "pnr_tube_params_size": (),
    "pnr_conv1d_axis": (_P, _I, _P, _I, _I, _I, _I, _P, _I, _I, _P),
    "pnr_conv1d_plan": (_I, _I, _I, _I, _I, _I, _P),
    "pnr_conv_yx": (_P, _I, _P, _I, _I, _I, _P, _I, _P, _I, _P),
    "pnr_conv_yx_plan": (_I, _I, _I, _I, _I, _I, _P),
    "pnr_probe": (_P, _P, _I, _P),
    "pnr_threefry_uniforms": (_P, _P, _I, _I, _I, _P, _P, _P),
}

#: held while a wrapper adds to its module's launch counter, so that
#: counts from several threads are exact
COUNT_LOCK = threading.Lock()
_LIBRARY_LOCK = threading.Lock()

#: CUDA launches of K7's counterpart (`pnr_probe`, through `probe` and
#: `self_check`)
PROBE_LAUNCHES = 0


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))) + sorted(
        glob.glob(os.path.join(CSRC, "*.cuh"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpnr_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu into the hashed shared library (if absent)."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cu = [p for p in _sources() if p.endswith(".cu")]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


_library = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (once, whichever
    thread asks first; the others wait for it)."""
    global _library
    if _library is None:
        with _LIBRARY_LOCK:
            if _library is None:
                lib = ctypes.CDLL(build())
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                _library = lib
    return _library


def probe(x: torch.Tensor) -> torch.Tensor:
    """K7's kernel: 2 * x for a 2-D float32 `x`. A CPU tensor runs the
    plain version (`probe_plain`), a CUDA tensor `pnr_probe` or raises."""
    if x.device.type == "cpu":
        return probe_plain(x)
    return _probe_cuda(x)


def _probe_cuda(x: torch.Tensor) -> torch.Tensor:
    # one cheap test of everything the kernel needs; the full check only
    # to name what is wrong
    global PROBE_LAUNCHES
    dev = x.get_device()
    if dev < 0 or x.dtype is not torch.float32 or x.dim() != 2 or not x.is_contiguous():
        require_cuda_tensor(x, "x", torch.float32, 2)
    out = torch.empty_like(x)
    err = library().pnr_probe(x.data_ptr(), out.data_ptr(), x.numel(), raw_stream(dev))
    if err:
        check(err, "pnr_probe")
    with COUNT_LOCK:
        PROBE_LAUNCHES += 1
    return out


def probe_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


def self_check(device="cuda") -> None:
    """K7's counterpart: build the library, launch `pnr_probe` on an
    (8, 128) float32 block of ones on `device`, and raise unless every
    value is 2.0. JAX's `mosaic_available` probe returns False and routes
    around Pallas; this never returns False and is never caught: the
    pipeline routes by the tensor's device and does not call it."""
    out = _probe_cuda(torch.ones((8, 128), dtype=torch.float32, device=device))
    if not bool((out == 2.0).all()):
        raise RuntimeError("pnr_probe: the kernel library launched but computed wrong values")


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def raw_stream(device_index: int) -> int:
    """The current CUDA stream of a device as an int, without building a
    torch.cuda.Stream object (about a twentieth of the host time of
    `torch.cuda.current_stream(device).cuda_stream`)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def require_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
