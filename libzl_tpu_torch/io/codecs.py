"""OGG Vorbis and MP3 codec bindings (typed ctypes over system libraries).

The reference loads clips through juce's basic formats — WAV, AIFF, FLAC,
OGG Vorbis and (where available) MP3 (lib/WaveFormItem.cpp:29
registerBasicFormats; tracktion uses the same manager for clip sources).
WAV/AIFF are parsed natively in io/wav.py; this module covers the
compressed formats by binding the system codec libraries where they exist
(the same gated pattern as io/alsa.py):

- OGG Vorbis read: libvorbisfile (`ov_fopen`/`ov_read_float`)
- OGG Vorbis write: libvorbisenc (used by tests; also a public feature —
  the reference's recorder is WAV-only)
- MP3 read: libmpg123 (forced float32 output)
- MP3 write: libmp3lame

Every binding is optional: `*_available()` reports presence and callers
raise a clear "convert first" error when a codec is absent. FLAC has no
system library in this environment and stays unsupported (io/wav.read_audio
raises with a clear message).

Struct-layout note: the vorbis encode API fills caller-allocated structs
(vorbis_info, dsp state, blocks, ogg stream). We allocate generously
oversized opaque buffers and only read the three leading vorbis_info fields
(version:int, channels:int, rate:long — ABI-stable since libvorbis 1.0)
and the ogg_page/ogg_packet pointer+length fields.

A copy of libzl_tpu/io/codecs.py, verbatim apart from this note: the port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from pathlib import Path
from typing import Optional

import numpy as np

from .wav import AudioData

# ------------------------------------------------------------ lib loading

_libs: dict[str, Optional[ctypes.CDLL]] = {}
_overrides: dict[str, object] = {}


def set_codec_lib_for_testing(name: str, lib) -> None:
    """Inject a fake library (tests) or None to simulate absence."""
    _overrides[name] = lib
    _libs.pop(name, None)


def _lib(name: str, sonames: tuple[str, ...]) -> Optional[ctypes.CDLL]:
    if name in _overrides:
        return _overrides[name]  # type: ignore[return-value]
    if name not in _libs:
        lib = None
        for so in sonames:
            try:
                lib = ctypes.CDLL(so)
                break
            except OSError:
                continue
        _libs[name] = lib
    return _libs[name]


def _vorbisfile():
    return _lib("vorbisfile", ("libvorbisfile.so.3", "libvorbisfile.so"))


def _vorbis():
    return _lib("vorbis", ("libvorbis.so.0", "libvorbis.so"))


def _vorbisenc():
    return _lib("vorbisenc", ("libvorbisenc.so.2", "libvorbisenc.so"))


def _ogg():
    return _lib("ogg", ("libogg.so.0", "libogg.so"))


def _mpg123():
    return _lib("mpg123", ("libmpg123.so.0", "libmpg123.so"))


def _lame():
    return _lib("lame", ("libmp3lame.so.0", "libmp3lame.so"))


def ogg_read_available() -> bool:
    return _vorbisfile() is not None


def ogg_write_available() -> bool:
    return all(x is not None for x in (_vorbis(), _vorbisenc(), _ogg()))


def mp3_read_available() -> bool:
    return _mpg123() is not None


def mp3_write_available() -> bool:
    return _lame() is not None


# ------------------------------------------------------------- OGG decode

# generous opaque allocations (real sizes: OggVorbis_File ~944B,
# dsp_state ~160B, block ~200B, stream_state ~408B, comment 32B, info 64B)
_OVF_SIZE = 4096


class _VorbisInfoHead(ctypes.Structure):
    _fields_ = [
        ("version", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("rate", ctypes.c_long),
    ]


def read_ogg(path: str | Path) -> AudioData:
    """Decode an OGG Vorbis file to float32 [frames, channels]."""
    vf_lib = _vorbisfile()
    if vf_lib is None:
        raise ValueError(
            f"OGG is not supported on this host (libvorbisfile not found); "
            f"convert to WAV/AIFF first: {path}"
        )
    vf_lib.ov_fopen.restype = ctypes.c_int
    vf_lib.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    vf_lib.ov_info.restype = ctypes.POINTER(_VorbisInfoHead)
    vf_lib.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
    vf_lib.ov_read_float.restype = ctypes.c_long
    vf_lib.ov_read_float.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.POINTER(ctypes.c_float))),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
    ]
    vf_lib.ov_clear.restype = ctypes.c_int
    vf_lib.ov_clear.argtypes = [ctypes.c_void_p]

    vf = ctypes.create_string_buffer(_OVF_SIZE)
    rc = vf_lib.ov_fopen(str(path).encode(), vf)
    if rc != 0:
        raise ValueError(f"not a decodable OGG Vorbis file (rc={rc}): {path}")
    try:
        info = vf_lib.ov_info(vf, -1)
        if not info:
            raise ValueError(f"ov_info failed: {path}")
        channels = info.contents.channels
        rate = int(info.contents.rate)
        if channels <= 0 or rate <= 0:
            raise ValueError(f"bad OGG stream params: {path}")
        pcm = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))()
        bitstream = ctypes.c_int(0)
        chunks = []
        OV_HOLE = -3
        while True:
            n = vf_lib.ov_read_float(
                vf, ctypes.byref(pcm), 4096, ctypes.byref(bitstream)
            )
            if n == 0:
                break
            if n == OV_HOLE:  # gap in data: skip (vorbisfile guidance)
                continue
            if n < 0:  # OV_EBADLINK/OV_EINVAL etc. can repeat forever
                raise ValueError(
                    f"corrupt OGG Vorbis stream (ov_read_float={n}): {path}"
                )
            # chained streams: each link can declare its own layout; the
            # pcm[c] pointers below are only valid up to the CURRENT
            # link's channel count — indexing with a stale count reads
            # past the decoder's pointer array
            li = vf_lib.ov_info(vf, bitstream.value)
            if li and (li.contents.channels != channels
                       or int(li.contents.rate) != rate):
                raise ValueError(
                    f"chained OGG changes format mid-stream "
                    f"({rate} Hz/{channels}ch -> {int(li.contents.rate)} "
                    f"Hz/{li.contents.channels}ch): {path}"
                )
            frames = np.empty((n, channels), np.float32)
            for c in range(channels):
                frames[:, c] = np.ctypeslib.as_array(pcm[c], shape=(n,))
            chunks.append(frames)
        samples = (
            np.concatenate(chunks, axis=0)
            if chunks else np.zeros((0, channels), np.float32)
        )
        return AudioData(samples, rate)
    finally:
        vf_lib.ov_clear(vf)


# ------------------------------------------------------------- OGG encode

class _OggPacket(ctypes.Structure):
    _fields_ = [
        ("packet", ctypes.POINTER(ctypes.c_ubyte)),
        ("bytes", ctypes.c_long),
        ("b_o_s", ctypes.c_long),
        ("e_o_s", ctypes.c_long),
        ("granulepos", ctypes.c_int64),
        ("packetno", ctypes.c_int64),
    ]


class _OggPage(ctypes.Structure):
    _fields_ = [
        ("header", ctypes.POINTER(ctypes.c_ubyte)),
        ("header_len", ctypes.c_long),
        ("body", ctypes.POINTER(ctypes.c_ubyte)),
        ("body_len", ctypes.c_long),
    ]


def write_ogg(
    path: str | Path, samples: np.ndarray, sample_rate: int,
    quality: float = 0.4,
) -> None:
    """Encode float32 [frames, channels] (or [frames]) to OGG Vorbis.

    Beyond the reference (whose recorder writes WAV only); primarily the
    self-test producer for read_ogg."""
    if not ogg_write_available():
        raise ValueError(
            "OGG encoding is not supported on this host "
            "(libvorbis/vorbisenc/ogg not found)"
        )
    x = np.asarray(samples, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    n_frames, channels = x.shape

    vb, ve, og = _vorbis(), _vorbisenc(), _ogg()
    vi = ctypes.create_string_buffer(256)
    vc = ctypes.create_string_buffer(256)
    vd = ctypes.create_string_buffer(1024)
    vblk = ctypes.create_string_buffer(1024)
    os_ = ctypes.create_string_buffer(2048)
    op = _OggPacket()
    h1, h2, h3 = _OggPacket(), _OggPacket(), _OggPacket()
    pg = _OggPage()

    ve.vorbis_encode_init_vbr.restype = ctypes.c_int
    ve.vorbis_encode_init_vbr.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_float
    ]
    vb.vorbis_analysis_buffer.restype = ctypes.POINTER(
        ctypes.POINTER(ctypes.c_float)
    )
    vb.vorbis_analysis_buffer.argtypes = [ctypes.c_void_p, ctypes.c_int]

    vb.vorbis_info_init(vi)
    rc = ve.vorbis_encode_init_vbr(
        vi, channels, int(sample_rate), ctypes.c_float(quality)
    )
    if rc != 0:
        vb.vorbis_info_clear(vi)
        raise ValueError(f"vorbis_encode_init_vbr failed (rc={rc})")
    vb.vorbis_comment_init(vc)
    vb.vorbis_analysis_init(vd, vi)
    vb.vorbis_block_init(vd, vblk)
    og.ogg_stream_init(os_, 0x5A4C)

    out = bytearray()

    def drain(flush: bool) -> None:
        fn = og.ogg_stream_flush if flush else og.ogg_stream_pageout
        while fn(os_, ctypes.byref(pg)) != 0:
            out.extend(ctypes.string_at(pg.header, pg.header_len))
            out.extend(ctypes.string_at(pg.body, pg.body_len))

    vb.vorbis_analysis_headerout(
        vd, vc, ctypes.byref(h1), ctypes.byref(h2), ctypes.byref(h3)
    )
    try:
        for h in (h1, h2, h3):
            og.ogg_stream_packetin(os_, ctypes.byref(h))
        drain(flush=True)

        CHUNK = 4096
        pos = 0
        while True:
            n = min(CHUNK, n_frames - pos)
            if n > 0:
                buf = vb.vorbis_analysis_buffer(vd, n)
                for c in range(channels):
                    # keep the contiguous copy referenced until memmove
                    # returns: `arr.ctypes.data` alone drops the
                    # temporary's last reference before the call
                    # (use-after-free, process-dependent corruption)
                    col = np.ascontiguousarray(x[pos : pos + n, c])
                    ctypes.memmove(buf[c], col.ctypes.data, n * 4)
                    del col
            vb.vorbis_analysis_wrote(vd, n)
            while vb.vorbis_analysis_blockout(vd, vblk) == 1:
                vb.vorbis_analysis(vblk, None)
                vb.vorbis_bitrate_addblock(vblk)
                while vb.vorbis_bitrate_flushpacket(vd, ctypes.byref(op)) == 1:
                    og.ogg_stream_packetin(os_, ctypes.byref(op))
                    drain(flush=False)
            if n == 0:
                break
            pos += n
        drain(flush=True)
    finally:
        # mirror read_ogg's ov_clear discipline: a mid-encode failure in a
        # long-lived process must not leak native allocations
        og.ogg_stream_clear(os_)
        vb.vorbis_block_clear(vblk)
        vb.vorbis_dsp_clear(vd)
        vb.vorbis_comment_clear(vc)
        vb.vorbis_info_clear(vi)

    Path(path).write_bytes(bytes(out))


# ------------------------------------------------------------- MP3 decode

_MPG123_ADD_FLAGS = 2
_MPG123_FORCE_FLOAT = 0x400
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11


def read_mp3(path: str | Path) -> AudioData:
    """Decode an MP3 file to float32 [frames, channels] via libmpg123."""
    m = _mpg123()
    if m is None:
        raise ValueError(
            f"MP3 is not supported on this host (libmpg123 not found); "
            f"convert to WAV/AIFF first: {path}"
        )
    m.mpg123_init()
    m.mpg123_new.restype = ctypes.c_void_p
    m.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    err = ctypes.c_int(0)
    # keep the handle wrapped in c_void_p everywhere: a raw Python int
    # passed to a function without argtypes is truncated to 32 bits
    h = ctypes.c_void_p(m.mpg123_new(None, ctypes.byref(err)))
    if not h:
        raise ValueError(f"mpg123_new failed (err={err.value})")
    m.mpg123_close.argtypes = [ctypes.c_void_p]
    m.mpg123_delete.argtypes = [ctypes.c_void_p]
    m.mpg123_param.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_double
    ]
    m.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    m.mpg123_getformat.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    m.mpg123_read.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    try:
        m.mpg123_param(h, _MPG123_ADD_FLAGS, _MPG123_FORCE_FLOAT, 0.0)
        if m.mpg123_open(h, str(path).encode()) != _MPG123_OK:
            raise ValueError(f"not a decodable MP3 file: {path}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        rc = m.mpg123_getformat(
            h, ctypes.byref(rate), ctypes.byref(channels),
            ctypes.byref(encoding),
        )
        if rc != _MPG123_OK or channels.value <= 0 or rate.value <= 0:
            raise ValueError(f"mpg123_getformat failed (rc={rc}): {path}")
        buf = ctypes.create_string_buffer(1 << 16)
        done = ctypes.c_size_t(0)
        out = bytearray()
        while True:
            rc = m.mpg123_read(
                h, buf, ctypes.sizeof(buf), ctypes.byref(done)
            )
            out.extend(buf.raw[: done.value])
            if rc == _MPG123_DONE:
                break
            if rc == _MPG123_NEW_FORMAT:
                new_rate = ctypes.c_long(0)
                new_ch = ctypes.c_int(0)
                m.mpg123_getformat(
                    h, ctypes.byref(new_rate), ctypes.byref(new_ch),
                    ctypes.byref(encoding),
                )
                if out and (new_rate.value != rate.value
                            or new_ch.value != channels.value):
                    # PCM already decoded under the OLD layout would be
                    # reshaped with the new one below — garbled audio.
                    # Raise, per this function's no-silent-corruption rule.
                    raise ValueError(
                        f"MP3 changes format mid-stream "
                        f"({rate.value} Hz/{channels.value}ch -> "
                        f"{new_rate.value} Hz/{new_ch.value}ch): {path}"
                    )
                rate, channels = new_rate, new_ch
                continue
            if rc != _MPG123_OK:
                # mid-stream decoder error: raise rather than silently
                # returning a truncated clip
                raise ValueError(
                    f"corrupt MP3 stream (mpg123_read rc={rc}): {path}"
                )
        data = np.frombuffer(bytes(out), "<f4")
        if not np.isfinite(data).all() or (
            data.size and np.abs(data).max() > 64.0
        ):
            raise ValueError(
                f"mpg123 did not produce float32 output (encoding="
                f"{encoding.value:#x}): {path}"
            )
        n_ch = channels.value
        samples = data[: data.size - data.size % n_ch].reshape(-1, n_ch)
        return AudioData(np.array(samples), int(rate.value))
    finally:
        m.mpg123_close(h)
        m.mpg123_delete(h)


# ------------------------------------------------------------- MP3 encode

def write_mp3(
    path: str | Path, samples: np.ndarray, sample_rate: int,
    bitrate_kbps: int = 192,
) -> None:
    """Encode float32 [frames, channels<=2] to MP3 via libmp3lame.

    Beyond the reference; primarily the self-test producer for read_mp3."""
    lame = _lame()
    if lame is None:
        raise ValueError(
            "MP3 encoding is not supported on this host (libmp3lame "
            "not found)"
        )
    x = np.asarray(samples, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    n_frames, channels = x.shape
    if channels > 2:
        raise ValueError("MP3 supports at most 2 channels")
    lame.lame_init.restype = ctypes.c_void_p
    gfp = ctypes.c_void_p(lame.lame_init())
    if not gfp:
        raise ValueError("lame_init failed")
    try:
        lame.lame_set_num_channels(gfp, channels)
        lame.lame_set_in_samplerate(gfp, int(sample_rate))
        lame.lame_set_brate(gfp, int(bitrate_kbps))
        lame.lame_set_quality(gfp, 2)
        if lame.lame_init_params(gfp) < 0:
            raise ValueError("lame_init_params failed")
        left = np.ascontiguousarray(x[:, 0])
        right = np.ascontiguousarray(x[:, 1] if channels == 2 else x[:, 0])
        mp3buf = ctypes.create_string_buffer(int(1.25 * n_frames + 7200))
        lame.lame_encode_buffer_ieee_float.restype = ctypes.c_int
        lame.lame_encode_buffer_ieee_float.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
        ]
        n = lame.lame_encode_buffer_ieee_float(
            gfp, left.ctypes.data, right.ctypes.data, n_frames,
            mp3buf, ctypes.sizeof(mp3buf),
        )
        if n < 0:
            raise ValueError(f"lame_encode_buffer failed (rc={n})")
        out = bytearray(mp3buf.raw[:n])
        n = lame.lame_encode_flush(gfp, mp3buf, ctypes.sizeof(mp3buf))
        if n > 0:
            out.extend(mp3buf.raw[:n])
    finally:
        # error paths must not leak the native encoder state in a
        # long-lived engine process (same discipline as write_ogg)
        lame.lame_close(gfp)
    Path(path).write_bytes(bytes(out))
