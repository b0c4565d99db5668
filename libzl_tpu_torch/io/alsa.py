"""Shared ctypes binding for libasound (ALSA): rawmidi, PCM, enumeration.

The reference reaches hardware through the JACK server (ports appear in the
graph, lib/MidiRouter.cpp:607-693) and plays audio by connecting to
system:playback_1/2 (lib/SamplerSynth.cpp:101-102). This build has no JACK;
hardware access is gated on libasound being present and loadable. Hosts
without a sound stack (CI containers, TPU pods) use the virtual ports /
file+null sinks instead.

All entry points used anywhere in the package are declared here with full
restype/argtypes so calls are correct on 64-bit platforms (pointer-sized
handles, ssize_t returns). Tests inject a fake implementation with
`set_alsa_lib_for_testing` — the fake only needs the attributes it drives.

A copy of libzl_tpu/io/alsa.py, verbatim apart from this note: the port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

# SND_PCM_* constants (alsa-lib pcm.h)
SND_PCM_STREAM_PLAYBACK = 0
SND_PCM_STREAM_CAPTURE = 1
SND_PCM_FORMAT_FLOAT_LE = 14
SND_PCM_ACCESS_RW_INTERLEAVED = 3
SND_PCM_NONBLOCK = 1
# rawmidi.h: APPEND is 0x0001, NONBLOCK is 0x0002 (distinct from the PCM
# open-mode value above) — passing 1 here would open rawmidi ports in
# APPEND mode and make the pump's per-block read() poll block forever
SND_RAWMIDI_NONBLOCK = 2

_override = None
_real: Optional[ctypes.CDLL] = None
_real_checked = False


def set_alsa_lib_for_testing(lib) -> None:
    """Inject a fake libasound object (or None to restore the real one)."""
    global _override
    _override = lib


def get_alsa():
    """The libasound handle, or None when unavailable on this host."""
    global _real, _real_checked
    if _override is not None:
        return _override
    if not _real_checked:
        _real_checked = True
        path = ctypes.util.find_library("asound")
        if path is not None:
            try:
                _real = _declare(ctypes.CDLL(path))
            except OSError:
                _real = None
    return _real


def available() -> bool:
    return get_alsa() is not None


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    # rawmidi
    lib.snd_rawmidi_open.restype = c.c_int
    lib.snd_rawmidi_open.argtypes = [
        c.POINTER(c.c_void_p), c.POINTER(c.c_void_p), c.c_char_p, c.c_int,
    ]
    lib.snd_rawmidi_read.restype = c.c_ssize_t
    lib.snd_rawmidi_read.argtypes = [c.c_void_p, c.c_void_p, c.c_size_t]
    lib.snd_pcm_readi.restype = c.c_long
    lib.snd_pcm_readi.argtypes = [c.c_void_p, c.c_void_p, c.c_ulong]
    lib.snd_rawmidi_write.restype = c.c_ssize_t
    lib.snd_rawmidi_write.argtypes = [c.c_void_p, c.c_void_p, c.c_size_t]
    lib.snd_rawmidi_close.restype = c.c_int
    lib.snd_rawmidi_close.argtypes = [c.c_void_p]
    # device hints (enumeration)
    lib.snd_device_name_hint.restype = c.c_int
    lib.snd_device_name_hint.argtypes = [
        c.c_int, c.c_char_p, c.POINTER(c.POINTER(c.c_void_p)),
    ]
    lib.snd_device_name_get_hint.restype = c.c_void_p  # char* we must free
    lib.snd_device_name_get_hint.argtypes = [c.c_void_p, c.c_char_p]
    lib.snd_device_name_free_hint.restype = c.c_int
    lib.snd_device_name_free_hint.argtypes = [c.POINTER(c.c_void_p)]
    # PCM playback
    lib.snd_pcm_open.restype = c.c_int
    lib.snd_pcm_open.argtypes = [
        c.POINTER(c.c_void_p), c.c_char_p, c.c_int, c.c_int,
    ]
    lib.snd_pcm_set_params.restype = c.c_int
    lib.snd_pcm_set_params.argtypes = [
        c.c_void_p, c.c_int, c.c_int, c.c_uint, c.c_uint, c.c_int, c.c_uint,
    ]
    lib.snd_pcm_writei.restype = c.c_long
    lib.snd_pcm_writei.argtypes = [c.c_void_p, c.c_void_p, c.c_ulong]
    lib.snd_pcm_recover.restype = c.c_int
    lib.snd_pcm_recover.argtypes = [c.c_void_p, c.c_int, c.c_int]
    lib.snd_pcm_drain.restype = c.c_int
    lib.snd_pcm_drain.argtypes = [c.c_void_p]
    lib.snd_pcm_close.restype = c.c_int
    lib.snd_pcm_close.argtypes = [c.c_void_p]
    try:
        lib.free.restype = None
        lib.free.argtypes = [c.c_void_p]
    except AttributeError:
        pass
    return lib


def _hint_str(lib, hint, key: bytes) -> Optional[str]:
    ptr = lib.snd_device_name_get_hint(hint, key)
    if not ptr:
        return None
    try:
        return ctypes.cast(ptr, ctypes.c_char_p).value.decode(
            "utf-8", "replace"
        )
    finally:
        try:
            lib.free(ptr)
        except AttributeError:
            pass  # fake libs without free()


def enumerate_rawmidi() -> list[dict]:
    """List rawmidi endpoints as dicts {name, desc, ioid}.

    ioid is "Input", "Output" or "" (both directions). The JACK
    port-registration-callback equivalent (lib/MidiRouter.cpp:788-793) —
    here callers poll this and diff (midi/devices.HardwareScanner).
    """
    lib = get_alsa()
    if lib is None:
        return []
    if hasattr(lib, "py_enumerate_rawmidi"):  # test fake
        return [dict(d) for d in lib.py_enumerate_rawmidi()]
    hints = ctypes.POINTER(ctypes.c_void_p)()
    if lib.snd_device_name_hint(-1, b"rawmidi", ctypes.byref(hints)) != 0:
        return []
    out = []
    try:
        i = 0
        while hints[i]:
            name = _hint_str(lib, hints[i], b"NAME")
            if name:
                out.append(
                    dict(
                        name=name,
                        desc=_hint_str(lib, hints[i], b"DESC") or name,
                        ioid=_hint_str(lib, hints[i], b"IOID") or "",
                    )
                )
            i += 1
    finally:
        lib.snd_device_name_free_hint(hints)
    return out


# ------------------------------------------------------------------ rawmidi
# Thin call wrappers so hardware classes stay ctypes-free and test fakes can
# implement the py_* hooks in plain Python.

def rawmidi_open(device: str, direction: str):
    """Open a rawmidi endpoint non-blocking; returns an opaque handle."""
    lib = get_alsa()
    if lib is None:
        raise RuntimeError("libasound not available on this host")
    if hasattr(lib, "py_rawmidi_open"):
        return lib.py_rawmidi_open(device, direction)
    handle = ctypes.c_void_p()
    if direction == "in":
        err = lib.snd_rawmidi_open(
            ctypes.byref(handle), None, device.encode(), SND_RAWMIDI_NONBLOCK
        )
    else:
        err = lib.snd_rawmidi_open(
            None, ctypes.byref(handle), device.encode(), SND_RAWMIDI_NONBLOCK
        )
    if err < 0:
        raise RuntimeError(f"snd_rawmidi_open({device}, {direction}): {err}")
    return handle


def rawmidi_read(handle, maxlen: int = 256) -> bytes:
    lib = get_alsa()
    if lib is None:
        return b""
    if hasattr(lib, "py_rawmidi_read"):
        return lib.py_rawmidi_read(handle, maxlen)
    buf = (ctypes.c_char * maxlen)()
    n = lib.snd_rawmidi_read(handle, buf, maxlen)
    return bytes(buf[: n]) if n > 0 else b""


def rawmidi_write(handle, data: bytes) -> int:
    """Write a full message, retrying -EAGAIN/partial writes briefly.

    Ports are opened NONBLOCK; a burst can overflow the kernel rawmidi
    buffer, and a silently-dropped note-off leaves stuck notes on external
    synths. Returns the number of bytes actually written (callers may
    count drops)."""
    lib = get_alsa()
    if lib is None:
        return 0
    if hasattr(lib, "py_rawmidi_write"):
        lib.py_rawmidi_write(handle, data)
        return len(data)
    import time as _time

    written = 0
    deadline = _time.monotonic() + 0.05  # bounded: never stall the pump
    while written < len(data):
        rc = lib.snd_rawmidi_write(
            handle, data[written:], len(data) - written
        )
        if rc > 0:
            written += rc
            continue
        if rc == -11 and _time.monotonic() < deadline:  # -EAGAIN
            _time.sleep(0.001)
            continue
        break  # hard error or deadline: give up on the remainder
    return written


def rawmidi_close(handle) -> None:
    lib = get_alsa()
    if lib is None:
        return
    if hasattr(lib, "py_rawmidi_close"):
        lib.py_rawmidi_close(handle)
        return
    lib.snd_rawmidi_close(handle)


# --------------------------------------------------------------------- PCM

def pcm_open_playback(device: str, rate: int, channels: int = 2,
                      latency_us: int = 20000):
    """Open + configure a float32 interleaved playback PCM; returns handle."""
    lib = get_alsa()
    if lib is None:
        raise RuntimeError("libasound not available on this host")
    if hasattr(lib, "py_pcm_open_playback"):
        return lib.py_pcm_open_playback(device, rate, channels, latency_us)
    handle = ctypes.c_void_p()
    err = lib.snd_pcm_open(
        ctypes.byref(handle), device.encode(), SND_PCM_STREAM_PLAYBACK, 0
    )
    if err < 0:
        raise RuntimeError(f"snd_pcm_open({device}): {err}")
    err = lib.snd_pcm_set_params(
        handle, SND_PCM_FORMAT_FLOAT_LE, SND_PCM_ACCESS_RW_INTERLEAVED,
        channels, rate, 1, latency_us,
    )
    if err < 0:
        lib.snd_pcm_close(handle)
        raise RuntimeError(f"snd_pcm_set_params({device}): {err}")
    return handle


def pcm_write(handle, interleaved) -> int:
    """Write float32 interleaved [frames, channels]; xrun-recovering.
    Returns frames written (after any recovery)."""
    import numpy as np

    lib = get_alsa()
    if lib is None:
        return 0
    block = np.ascontiguousarray(interleaved, dtype=np.float32)
    if hasattr(lib, "py_pcm_write"):
        return lib.py_pcm_write(handle, block)
    frames = block.shape[0]
    n = lib.snd_pcm_writei(handle, block.ctypes.data_as(ctypes.c_void_p),
                           frames)
    if n < 0:
        # xrun/suspend: recover once and retry (standard ALSA idiom)
        if lib.snd_pcm_recover(handle, int(n), 1) == 0:
            n = lib.snd_pcm_writei(
                handle, block.ctypes.data_as(ctypes.c_void_p), frames
            )
    return int(n) if n > 0 else 0


def pcm_drain_close(handle) -> None:
    lib = get_alsa()
    if lib is None:
        return
    if hasattr(lib, "py_pcm_drain_close"):
        lib.py_pcm_drain_close(handle)
        return
    lib.snd_pcm_drain(handle)
    lib.snd_pcm_close(handle)


def pcm_open_capture(device: str, rate: int, channels: int = 2,
                     latency_us: int = 40000):
    """Open + configure a float32 interleaved capture PCM; returns handle."""
    lib = get_alsa()
    if lib is None:
        raise RuntimeError("libasound not available on this host")
    if hasattr(lib, "py_pcm_open_capture"):
        return lib.py_pcm_open_capture(device, rate, channels, latency_us)
    handle = ctypes.c_void_p()
    err = lib.snd_pcm_open(
        ctypes.byref(handle), device.encode(), SND_PCM_STREAM_CAPTURE, 0
    )
    if err < 0:
        raise RuntimeError(f"snd_pcm_open capture({device}): {err}")
    err = lib.snd_pcm_set_params(
        handle, SND_PCM_FORMAT_FLOAT_LE, SND_PCM_ACCESS_RW_INTERLEAVED,
        channels, rate, 1, latency_us,
    )
    if err < 0:
        lib.snd_pcm_close(handle)
        raise RuntimeError(f"snd_pcm_set_params capture({device}): {err}")
    return handle


def pcm_read(handle, frames: int, channels: int = 2):
    """Read float32 interleaved [<=frames, channels]; xrun-recovering."""
    import numpy as np

    lib = get_alsa()
    if lib is None:
        return np.zeros((0, channels), np.float32)
    if hasattr(lib, "py_pcm_read"):
        return lib.py_pcm_read(handle, frames, channels)
    buf = np.empty((frames, channels), np.float32)
    n = lib.snd_pcm_readi(handle, buf.ctypes.data_as(ctypes.c_void_p), frames)
    if n < 0:
        if lib.snd_pcm_recover(handle, int(n), 1) == 0:
            n = lib.snd_pcm_readi(
                handle, buf.ctypes.data_as(ctypes.c_void_p), frames
            )
    return buf[: max(int(n), 0)]


def pcm_close(handle) -> None:
    lib = get_alsa()
    if lib is None:
        return
    if hasattr(lib, "py_pcm_close"):
        lib.py_pcm_close(handle)
        return
    lib.snd_pcm_close(handle)
