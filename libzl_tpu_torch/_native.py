"""Loader for the host-side native libraries (native/*.cpp).

The counterpart of libzl_tpu/_native.py, serving the host core
(engine/hostcore.py), the WSOLA stretcher (ops/stretch_native.py) and the
FLAC decoder (io/flac.py). Each library is built on first request with the
reference's compiler line and cached per process:

    g++ <opt> -fPIC -shared -std=c++17 -o <tmp> native/<stem>.cpp

The output is `build/libzl_tpu_torch/<stem>_<hash>.so`, named after a hash of
the source and flags, and the compiler writes a temporary file that
`os.replace` moves into place (`_build._compile`): processes that build the
same library at once each load a whole file, and nothing is written under
native/. When the library cannot be built or fails its ABI check,
`load_native` returns None, as the reference's does, and `failure(stem)`
says why; callers gate on availability.
"""

from __future__ import annotations

import ctypes
import shutil
import threading
from pathlib import Path
from typing import Optional

from . import _build

NATIVE_DIR = _build.NATIVE
CXX = "g++"

_cache: dict = {}
_failures: dict = {}
_lock = threading.Lock()


def _flags(opt: str) -> list:
    return [opt, "-fPIC", "-shared", "-std=c++17"]


def library_path(stem: str, opt: str = "-O2",
                 build_dir: Optional[Path] = None) -> Path:
    """Where the build of native/<stem>.cpp with these flags lands."""
    return _build._hashed(stem, [NATIVE_DIR / f"{stem}.cpp"], _flags(opt),
                          build_dir)


def _build_lib(stem: str, opt: str, build_dir: Optional[Path]) -> Path:
    src = NATIVE_DIR / f"{stem}.cpp"
    if not src.is_file():
        raise FileNotFoundError(f"{src} not found")
    so = library_path(stem, opt, build_dir)
    if so.is_file():
        return so
    if shutil.which(CXX) is None:
        raise FileNotFoundError(f"no C++ compiler ({CXX} is not on PATH)")
    _build._compile(lambda out: [CXX, *_flags(opt), "-o", out, str(src)],
                    so, CXX)
    return so


def load_native(stem: str, abi_symbol: str, abi_version: int,
                opt: str = "-O2",
                build_dir: Optional[Path] = None) -> Optional[ctypes.CDLL]:
    """Build (unless a build of this source exists) and load <stem>'s
    library; check that `<abi_symbol>()` returns `abi_version`. Returns None
    when it cannot be built or loaded or fails the check, and records the
    cause for `failure(stem)`. The result, failure included, is cached per
    (stem, build_dir) for the process. `build_dir` defaults to
    build/libzl_tpu_torch/."""
    key = (stem, str(build_dir) if build_dir else None)
    with _lock:
        if key in _cache:
            return _cache[key]
        lib = None
        try:
            candidate = ctypes.CDLL(str(_build_lib(stem, opt, build_dir)))
            got = getattr(candidate, abi_symbol)()
            if got != abi_version:
                raise RuntimeError(
                    f"{abi_symbol}() returned {got}, expected {abi_version}")
            lib = candidate
            _failures.pop(stem, None)
        except (OSError, AttributeError, RuntimeError) as e:
            _failures[stem] = f"{type(e).__name__}: {e}"
        _cache[key] = lib
        return lib


def failure(stem: str) -> Optional[str]:
    """Why the last `load_native(stem, ...)` returned None (None if it
    loaded or was never asked)."""
    return _failures.get(stem)
