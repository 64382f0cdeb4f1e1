"""Build and load the port's CUDA kernels.

``nvcc`` compiles ``csrc/rssm_step.cu`` for ``sm_90a`` into a shared library
with a plain C interface under ``build/torch_kernels/`` at the repository root,
the first time a kernel is launched; the library's name carries a hash of the
source, so an edited source is rebuilt and a stale library is never loaded.
Nothing here runs at import time, and nothing falls back: a missing ``nvcc``
or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "ops", "csrc", "rssm_step.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the last build took (0.0 when a built library was reused)
build_seconds = 0.0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA RSSM kernels cannot be built")
    return path


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"librssm_step_{digest}.so")


def build() -> str:
    """Compile the kernels unless the library of this source exists; returns its path."""
    global build_seconds
    out = library_path()
    if os.path.isfile(out):
        build_seconds = 0.0
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    with open(os.path.join(BUILD_DIR, "ptxas.log"), "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name in ("rssm_dyn_step", "rssm_imag_step"):
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.rssm_error_string.argtypes = [ctypes.c_int]
            lib.rssm_error_string.restype = ctypes.c_char_p
            lib.rssm_smem_optin.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            lib.rssm_smem_optin.restype = ctypes.c_int
            _lib = lib
        return _lib


def error_string(code: int) -> str:
    return load().rssm_error_string(code).decode()


def smem_optin(device_index: int) -> int:
    """Opt-in shared memory per block of the device, in bytes
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``)."""
    out = ctypes.c_int(0)
    rc = load().rssm_smem_optin(device_index, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"cudaDeviceGetAttribute(MaxSharedMemoryPerBlockOptin): error {rc} ({error_string(rc)})")
    return out.value
