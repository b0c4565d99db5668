"""Build and load the port's native code: the CUDA kernels and libzl.so.

The kernels (`csrc/*.cu`) expose a plain C interface and are loaded with
ctypes; nothing includes PyTorch's headers, so a build takes seconds. The
shared library is built on first use into `build/libzl_tpu_torch/` under the
repository root and named after a hash of the sources and flags, so a stale
build never loads. Each source compiles in its own nvcc process, all started
together, and one more links the objects. A failed build raises with the
compiler's output; there is no fallback.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <source>.o libzl_tpu_torch/csrc/<source>.cu
    nvcc -shared -o build/libzl_tpu_torch/libzl_tpu_torch_<hash>.so *.o

The port's C ABI library (`build_shim`) is `native/libzl_shim.cpp`, compiled
unchanged through `csrc/libzl_shim_torch.cpp`, with the host C++ compiler and
the flags of native/Makefile, into `build/libzl_tpu_torch/libzl_<hash>.so`.
It needs the repository checkout (native/) and Python's headers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
NATIVE = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "libzl_tpu_torch"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default home

# -fmad stays at nvcc's default (true); every kernel rounds each product and
# sum that must match a plain version itself (__fmul_rn, __fadd_rn, ...), so
# no contraction into an FMA changes a bit
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
# native/Makefile's CXXFLAGS for libzl.so
SHIM_CXX_FLAGS = ["-O2", "-fPIC", "-Wall", "-std=c++17", "-shared"]
SHIM_SOURCE = CSRC / "libzl_shim_torch.cpp"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_held: Optional[ctypes.PyDLL] = None
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


def _hashed(stem: str, files: list, flags: list,
            build_dir: Optional[Path] = None) -> Path:
    """`<build_dir or BUILD_DIR>/<stem>_<hash>.so`, the hash over the files
    and flags."""
    h = hashlib.sha256()
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return Path(build_dir or BUILD_DIR) / f"{stem}_{h.hexdigest()[:16]}.so"


def _compile(command, so: Path, what: str) -> tuple:
    """Run `command(tmp)` (the compiler line writing `tmp`) and move `tmp`
    to `so` atomically: a concurrent loader never sees half a file.
    Returns (compiler output, wall seconds); raises on failure."""
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = command(str(tmp))
    so.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{what} failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, so)
    return log, seconds


def library_path() -> Path:
    return _hashed("libzl_tpu_torch", sources(), NVCC_FLAGS)


def build() -> Path:
    """Compile the kernels unless a build of these exact sources exists:
    one `nvcc -c` a source, all running at once, then one link."""
    global build_log, build_seconds
    so = library_path()
    if so.is_file():
        return so
    nvcc = find_nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.objs")
    objs.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        jobs = []
        for src in sources():
            cmd = [nvcc, *compile_flags, "-c", "-o",
                   str(objs / f"{src.stem}.o"), str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, proc in jobs:
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{logs[-1]}")
        if failed:
            raise RuntimeError("\n".join(failed))
        link_log, _ = _compile(
            lambda out: [nvcc, "-shared", "-o", out,
                         *sorted(str(o) for o in objs.glob("*.o"))],
            so, "nvcc link")
    finally:
        shutil.rmtree(objs, ignore_errors=True)
    build_log = "".join(logs) + link_log
    build_seconds = time.perf_counter() - t0
    return so


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = bind_fetch(ctypes.CDLL(str(build())))
        bind_mixdown(lib)
        bind_render(lib)
        # B, region, int16 bank -> staged samples per channel and voice
        lib.zl_fetch_interp_stage_cap.argtypes = [ctypes.c_int64,
                                                  ctypes.c_int64,
                                                  ctypes.c_int]
        lib.zl_fetch_interp_stage_cap.restype = ctypes.c_int
        _lib = lib
        return _lib


def load_held() -> ctypes.PyDLL:
    """The kernels' library again, bound with ctypes.PyDLL: its calls keep
    the interpreter lock (ctypes.CDLL's let go of it). For calls shorter
    than another thread's turn with the lock: zl_host_copy (capi/bridge.py's
    staging ring), zl_graph_replay (engine/graphs.py's replays)."""
    global _held
    with _lock:
        if _held is None:
            lib = ctypes.PyDLL(str(build()))
            ptr, i64 = ctypes.c_void_p, ctypes.c_int64
            # dst, src, bytes, stream, event
            lib.zl_host_copy.argtypes = [ptr, ptr, i64, ptr, ptr]
            lib.zl_host_copy.restype = ctypes.c_int
            # exec, stream, done, prog, staging, prog bytes, copied, dst,
            # src, out bytes, device
            lib.zl_graph_replay.argtypes = [ptr, ptr, ptr, ptr, ptr, i64,
                                            ptr, ptr, ptr, i64, ctypes.c_int]
            lib.zl_graph_replay.restype = ctypes.c_int
            _held = lib
        return _held


def bind_fetch(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the windows fetch's C entry points of a loaded library."""
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for name in ("zl_fetch_interp_f32", "zl_fetch_interp_i16"):
        fn = getattr(lib, name)
        # sound, n, pos_local, alpha, win_a, win_b, out, V, B, region, stream
        fn.argtypes = [ptr, i64, ptr, ptr, ptr, ptr, ptr, i64, i64, i64, ptr]
        fn.restype = ctypes.c_int
    lib.zl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.zl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def bind_mixdown(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the lane mixdown's C entry points of a loaded library."""
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    # contrib, lane, lane stride, init, out, H, V, E, L, stream
    lib.zl_lane_mixdown.argtypes = [ptr, ptr, i64, ptr, ptr, i64, i64, i64,
                                    i64, ptr]
    lib.zl_lane_mixdown.restype = ctypes.c_int
    if hasattr(lib, "zl_lane_mixdown_as"):   # not in every --compare source
        # the same with the copy width (0: the widest; 4, 2 or 1 floats)
        # before the stream
        lib.zl_lane_mixdown_as.argtypes = [ptr, ptr, i64, ptr, ptr, i64, i64,
                                           i64, i64, ctypes.c_int, ptr]
        lib.zl_lane_mixdown_as.restype = ctypes.c_int
        # H, E, L, stream: an empty kernel on the mixdown's grid
        lib.zl_lane_mixdown_empty.argtypes = [i64, i64, i64, ptr]
        lib.zl_lane_mixdown_empty.restype = ctypes.c_int
    return lib


def bind_render(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of the kernels around the fetch and the
    mixdown: voice prep, voice post and the finish."""
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    outs = [ptr] * 6  # pos_local, alpha, g, valid, win_a, win_b
    # columns (a PrepColumns by reference), S, W, outputs, V, B, region,
    # stream
    lib.zl_voice_prep.argtypes = [ptr, i64, i64, *outs, i64, i64, i64, ptr]
    # the same with the dynamics, their row stride and slice h's offset
    # after the columns
    lib.zl_voice_prep_slice.argtypes = [ptr, ptr, i64, i64, i64, i64, *outs,
                                        i64, i64, i64, ptr]
    # interp, g, valid, pan, pan stride, contrib, peak, V, B, stream
    lib.zl_voice_post.argtypes = [ptr, ptr, ptr, ptr, i64, ptr, ptr, i64,
                                  i64, ptr]
    # mix, strips, strips out, meters, master peak, partial (scratch), H, L,
    # B, stream
    lib.zl_finish_block.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, i64,
                                    i64, ptr]
    for fn in (lib.zl_voice_prep, lib.zl_voice_prep_slice, lib.zl_voice_post,
               lib.zl_finish_block):
        fn.restype = ctypes.c_int
    # H, L, B -> the floats of scratch the finish needs
    lib.zl_finish_block_scratch.argtypes = [i64, i64, i64]
    lib.zl_finish_block_scratch.restype = i64
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if code != 0:
        msg = lib.zl_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


# ------------------------------------------------------------ libzl.so


def python_include() -> Path:
    """The directory holding this interpreter's Python.h; raises when the
    headers are not installed (the shim cannot be built then)."""
    inc = Path(sysconfig.get_paths()["include"])
    if not (inc / "Python.h").is_file():
        raise FileNotFoundError(
            f"Python.h not found in {inc}: the port's libzl.so needs "
            f"Python's development headers")
    return inc


def _python_embed_ldflags() -> list:
    """`python3-config --ldflags --embed` of this interpreter."""
    cv = sysconfig.get_config_var
    flags = [f"-L{cv('LIBDIR')}"]
    if not cv("Py_ENABLE_SHARED"):
        flags.insert(0, f"-L{cv('LIBPL')}")
    flags.append(f"-lpython{cv('VERSION')}{sys.abiflags}")
    flags += (cv("LIBS") or "").split() + (cv("SYSLIBS") or "").split()
    return flags


def shim_path() -> Path:
    return _hashed("libzl", [SHIM_SOURCE, NATIVE / "libzl_shim.cpp",
                             NATIVE / "libzl.h"],
                   SHIM_CXX_FLAGS + _python_embed_ldflags())


def build_shim() -> Path:
    """The port's libzl.so (the libzl.h C ABI over
    libzl_tpu_torch.capi.bridge), built with the host C++ compiler unless a
    build of these exact sources exists."""
    so = shim_path()
    if so.is_file():
        return so
    cxx = os.environ.get("CXX") or "g++"
    inc = python_include()
    _compile(lambda out: [cxx, *SHIM_CXX_FLAGS, f"-I{inc}", f"-I{NATIVE}",
                          "-o", out, str(SHIM_SOURCE),
                          *_python_embed_ldflags()], so, cxx)
    return so
