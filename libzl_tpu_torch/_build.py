"""Build and load the port's CUDA kernels (`csrc/*.cu`).

The kernels expose a plain C interface and are loaded with ctypes; nothing
includes PyTorch's headers, so a build takes seconds. The shared library is
built on first use into `build/libzl_tpu_torch/` under the repository root and
named after a hash of the sources and flags, so a stale build never loads.
A failed build raises with nvcc's output; there is no fallback.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/libzl_tpu_torch/libzl_tpu_torch_<hash>.so \
         libzl_tpu_torch/csrc/*.cu
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "libzl_tpu_torch"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default home

# -fmad stays at nvcc's default (true): the lerp's FMA contraction stays well
# inside the fetch tolerance (atol 2e-6) against the plain version
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# nvcc's output and wall seconds of the last build in this process (the
# ptxas register/spill report; both stay empty/0 when a cached .so loads)
build_log = ""
build_seconds = 0.0


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then PATH, then the default toolkit location."""
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").is_file():
        return str(Path(cuda_home) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    if DEFAULT_NVCC.is_file():
        return str(DEFAULT_NVCC)
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the CUDA "
        "kernels of libzl_tpu_torch cannot be built"
    )


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libzl_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a build of these exact sources exists."""
    global build_log, build_seconds
    so = library_path()
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sources()]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{build_log}"
        )
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        for name in ("zl_fetch_interp_f32", "zl_fetch_interp_i16"):
            fn = getattr(lib, name)
            # sound, n, pos_local, alpha, win_a, win_b, out, V, B, region,
            # stream
            fn.argtypes = [ptr, i64, ptr, ptr, ptr, ptr, ptr, i64, i64, i64,
                           ptr]
            fn.restype = ctypes.c_int
        lib.zl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.zl_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if code != 0:
        msg = lib.zl_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
