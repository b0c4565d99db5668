"""ctypes binding for the native WSOLA stretcher (native/zl_stretch.cpp).

The reference's time-stretch is tracktion's TimeStretcher with the
SoundTouch backend (reference CMakeLists.txt:86) — a time-domain WSOLA.
This binding exposes the native reimplementation as the fast path behind
`ops/resample.render_playback`; the numpy phase vocoder in `ops/resample`
remains the portable fallback (and is still selectable via
LIBZL_TPU_STRETCH=vocoder).

Builds on demand with g++ (same pattern as engine/hostcore.py) and degrades
gracefully: `available()` is False when no compiler/library exists.

A copy of libzl_tpu/ops/stretch_native.py, verbatim apart from this note:
the port keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

_lib: Optional[ctypes.CDLL] = None


def load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    from .._native import load_native

    lib = load_native("zl_stretch", "zl_stretch_abi_version", 1, opt="-O3")
    if lib is None:
        return None
    lib.zl_stretch_out_len.restype = ctypes.c_int64
    lib.zl_stretch_out_len.argtypes = [ctypes.c_int64, ctypes.c_double]
    lib.zl_stretch_process.restype = ctypes.c_int64
    lib.zl_stretch_process.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def time_stretch_wsola(
    samples: np.ndarray, stretch: float, sample_rate: int
) -> np.ndarray:
    """WSOLA time stretch of [T, C] (or [T]) by `stretch` (output duration =
    input * stretch), pitch preserved. Requires `available()`.
    """
    lib = load()
    assert lib is not None, "native stretcher unavailable"
    x = np.asarray(samples, np.float32)
    mono_in = x.ndim == 1
    if mono_in:
        x = x[:, None]
    x = np.ascontiguousarray(x)
    n_in, n_ch = x.shape
    if n_in == 0:
        # match the vocoder's empty-input contract: one silent frame
        out = np.zeros((1, n_ch), np.float32)
        return out[:, 0] if mono_in else out
    n_out = int(lib.zl_stretch_out_len(n_in, float(stretch)))
    out = np.empty((n_out, n_ch), np.float32)
    wrote = lib.zl_stretch_process(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_in, n_ch, float(stretch), int(sample_rate),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_out,
    )
    if wrote != n_out:
        raise RuntimeError(f"zl_stretch_process failed (rc={wrote})")
    return out[:, 0] if mono_in else out
