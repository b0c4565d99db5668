"""A ctypes client of the port's libzl.so: the C ABI end to end.

    python -m libzl_tpu_torch.capi.abi_client [path/to/libzl.so]

Builds the library when no path is given (`_build.build_shim`), loads it
into this interpreter (the reference's ctypes test-client pattern), writes a
1 s sine clip, and drives it through the ABI: initJuce, clip creation and
lookup, a progress callback, global-playback recording while the clip plays
for 400 blocks and rings out for 120, a short wall-clock pump run, a
passthrough round trip, dBFromVolume, shutdownJuce. Blocks are stepped
deterministically (LIBZL_TPU_NO_PUMP=1 is set here); the device is
LIBZL_TPU_BACKEND (cuda by default). Prints
`CAPI-OK device=<device> frames=<n> peak=<x> progress_hits=<n>` and exits 0;
any failed check raises.
"""

from __future__ import annotations

import ctypes
import os
import sys
import tempfile
import time

import numpy as np

from ..io.wav import read_wav, write_wav

SR = 48000
STEP_PLAY, STEP_TAIL = 400, 120


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"abi_client: {msg}")


def _declare(zl) -> None:
    cp = ctypes.c_void_p
    for name, res, args in (
        ("ClipAudioSource_new", cp, [ctypes.c_char_p, ctypes.c_bool]),
        ("ClipAudioSource_byID", cp, [ctypes.c_int]),
        ("ClipAudioSource_getDuration", ctypes.c_float, [cp]),
        ("ClipAudioSource_getFileName", ctypes.c_char_p, [cp]),
        ("ClipAudioSource_id", ctypes.c_int, [cp]),
        ("ClipAudioSource_play", None, [cp, ctypes.c_bool]),
        ("ClipAudioSource_stop", None, [cp]),
        ("ClipAudioSource_setProgressCallback", None, [cp, cp]),
        ("dBFromVolume", ctypes.c_float, [ctypes.c_float]),
        ("JackPassthrough_setDryAmount", None, [ctypes.c_int, ctypes.c_float]),
        ("JackPassthrough_getDryAmount", ctypes.c_float, [ctypes.c_int]),
        ("AudioLevels_setRecordGlobalPlayback", None, [ctypes.c_bool]),
        ("AudioLevels_setGlobalPlaybackFilenamePrefix", None,
         [ctypes.c_char_p]),
        ("AudioLevels_isRecording", ctypes.c_bool, []),
        ("SyncTimer_startTimer", None, [ctypes.c_int]),
    ):
        fn = getattr(zl, name)
        fn.restype = res
        fn.argtypes = args


def run(so: str, tmp: str) -> str:
    wav, rec = os.path.join(tmp, "in.wav"), os.path.join(tmp, "rec.wav")
    t = np.arange(SR) / SR
    write_wav(wav, (0.5 * np.sin(2 * np.pi * 330 * t)).astype(np.float32), SR)

    zl = ctypes.CDLL(so)
    _declare(zl)
    zl.initJuce()
    clip = zl.ClipAudioSource_new(wav.encode(), False)
    _check(bool(clip), "clip creation failed")
    cid = zl.ClipAudioSource_id(clip)
    _check(zl.ClipAudioSource_byID(cid) == clip, "byID mismatch")
    dur = zl.ClipAudioSource_getDuration(clip)
    _check(abs(dur - 1.0) < 1e-3, f"duration {dur}")
    name = zl.ClipAudioSource_getFileName(clip).decode()
    _check(name == "in.wav", f"file name {name!r}")

    progress_hits = []

    @ctypes.CFUNCTYPE(None, ctypes.c_float)
    def on_progress(v):
        progress_hits.append(v)

    zl.ClipAudioSource_setProgressCallback(
        clip, ctypes.cast(on_progress, ctypes.c_void_p))

    zl.AudioLevels_setRecordGlobalPlayback(True)
    zl.AudioLevels_setGlobalPlaybackFilenamePrefix(rec.encode())
    zl.AudioLevels_startRecording()
    _check(zl.AudioLevels_isRecording(), "not recording")
    zl.SyncTimer_startTimer(120)  # the argument is a BPM
    zl.ClipAudioSource_play(clip, True)

    # the shim shares this interpreter: its bridge module is this one
    from libzl_tpu_torch.capi import bridge

    rt = bridge._rt()
    _check(rt._pump is None, "LIBZL_TPU_NO_PUMP is not in effect")
    device = str(rt.engine.device)
    rt.step_blocks(STEP_PLAY)
    zl.ClipAudioSource_stop(clip)
    rt.step_blocks(STEP_TAIL)
    zl.AudioLevels_stopRecording()
    zl.SyncTimer_stopTimer()

    # a short wall-clock pump run (on the card its start warms every shape)
    rt.start_pump()
    time.sleep(0.2)
    rt.stop_pump()
    _check(rt.pump_error is None, f"pump error {rt.pump_error!r}")

    zl.JackPassthrough_setDryAmount(3, 0.5)
    _check(abs(zl.JackPassthrough_getDryAmount(3) - 0.5) < 1e-6,
           "passthrough round trip")
    _check(abs(zl.dBFromVolume(1.0)) < 1e-6, "dBFromVolume(1.0)")

    out = read_wav(rec)
    peak = float(np.abs(out.samples).max())
    frames = (STEP_PLAY + STEP_TAIL) * rt.engine.block_frames
    _check(out.num_frames == frames, f"{out.num_frames} frames recorded, "
           f"expected {frames}")
    _check(peak > 0.05, f"recording peak {peak}")
    _check(bool(progress_hits), "no progress callbacks fired")
    rt.engine.drain_speculation()
    zl.shutdownJuce()
    return (f"CAPI-OK device={device} frames={out.num_frames} "
            f"peak={peak:.3f} progress_hits={len(progress_hits)}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        so = argv[0]
    else:
        from libzl_tpu_torch import _build

        so = str(_build.build_shim())
    os.environ["LIBZL_TPU_NO_PUMP"] = "1"
    with tempfile.TemporaryDirectory() as tmp:
        print(run(so, tmp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
