"""Audio file reading/writing with NumPy (no external deps).

Replaces the reference's use of juce audio formats for both sample loading
(lib/SamplerSynthSound.cpp:28-59, formats registered at
lib/WaveFormItem.cpp:29 registerBasicFormats) and disk recording
(lib/AudioLevels.cpp:44-67). Read support via `read_audio` (sniffed by
container magic, not extension): WAV (PCM 8/16/24/32-bit, IEEE float32,
extensible) and AIFF/AIFC (PCM big/little-endian 'sowt', float
'fl32'/'fl64') parsed natively here; OGG Vorbis and MP3 through the system
codec libraries where present (io/codecs.py, gated like the ALSA binding).
FLAC has no codec library in this environment; loading one raises with a
clear convert-first message. Mono or stereo (more channels pass through
unchanged). All engine-internal audio is float32 in [-1, 1).

A copy of libzl_tpu/io/wav.py, verbatim apart from this note: the port keeps
its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import struct
import wave
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class AudioData:
    """Decoded audio: samples [frames, channels] float32 + sample rate."""

    samples: np.ndarray
    sample_rate: int

    @property
    def num_frames(self) -> int:
        return self.samples.shape[0]

    @property
    def num_channels(self) -> int:
        return self.samples.shape[1]

    @property
    def duration_seconds(self) -> float:
        return self.num_frames / self.sample_rate


def _decode_pcm(raw: bytes, sampwidth: int, n_channels: int) -> np.ndarray:
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        data = ints.astype(np.float32) / float(1 << 23)
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / float(1 << 31)
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported PCM sample width: {sampwidth}")
    return data.reshape(-1, n_channels)


def read_wav(path: str | Path) -> AudioData:
    """Read a WAV file to float32 [frames, channels]."""
    path = Path(path)
    # wave module handles PCM; float WAVs need manual RIFF parsing.
    try:
        with wave.open(str(path), "rb") as w:
            n_channels = w.getnchannels()
            sampwidth = w.getsampwidth()
            framerate = w.getframerate()
            raw = w.readframes(w.getnframes())
        return AudioData(_decode_pcm(raw, sampwidth, n_channels), framerate)
    except (wave.Error, EOFError):
        # stdlib wave raises EOFError (not wave.Error) for files truncated
        # mid-chunk — the RIFF fallback still decodes partial data or
        # raises a clear missing-chunk error
        return _read_wav_riff(path)


def _read_wav_riff(path: Path) -> AudioData:
    """Minimal RIFF parser for IEEE-float and extensible WAVs."""
    blob = path.read_bytes()
    if blob[:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {path}")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(blob):
        cid = blob[pos : pos + 4]
        (size,) = struct.unpack_from("<I", blob, pos + 4)
        body = blob[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError(f"missing fmt/data chunk: {path}")
    audio_format, n_channels, framerate, _, _, bits = fmt
    if audio_format == 3 or (audio_format == 0xFFFE and bits in (32, 64)):
        # IEEE float: dispatch on the declared width — a float64 WAV
        # (scipy writes them) reinterpreted as f4 would silently load as
        # twice the frames of noise
        if bits == 32:
            samples = (
                np.frombuffer(data, dtype="<f4").reshape(-1, n_channels).copy()
            )
        elif bits == 64:
            samples = (
                np.frombuffer(data, dtype="<f8").reshape(-1, n_channels)
                .astype(np.float32)
            )
        else:
            raise ValueError(f"unsupported float WAV width: {bits}")
    elif audio_format in (1, 0xFFFE):
        samples = _decode_pcm(data, bits // 8, n_channels)
    else:
        raise ValueError(f"unsupported WAV format code: {audio_format}")
    return AudioData(samples.astype(np.float32), framerate)


def _read_f80(b: bytes) -> float:
    """80-bit IEEE 754 extended float (the AIFF COMM sampleRate field)."""
    (se,) = struct.unpack_from(">H", b, 0)
    (mant,) = struct.unpack_from(">Q", b, 2)
    sign = -1.0 if se & 0x8000 else 1.0
    exp = se & 0x7FFF
    if exp == 0 and mant == 0:
        return 0.0
    return sign * mant * 2.0 ** (exp - 16383 - 63)


def read_aiff(path: str | Path) -> AudioData:
    """Read AIFF / AIFC to float32 [frames, channels].

    Supports PCM ('NONE'/'twos' big-endian, 'sowt' little-endian) at
    8/16/24/32 bits and float ('fl32'/'FL32'/'fl64') — the uncompressed
    variants of juce's AiffAudioFormat."""
    path = Path(path)
    blob = path.read_bytes()
    if blob[:4] != b"FORM" or blob[8:12] not in (b"AIFF", b"AIFC"):
        raise ValueError(f"not an AIFF/AIFC file: {path}")
    is_aifc = blob[8:12] == b"AIFC"
    pos = 12
    comm = None
    ssnd = None
    comp = b"NONE"
    while pos + 8 <= len(blob):
        cid = blob[pos : pos + 4]
        (size,) = struct.unpack_from(">I", blob, pos + 4)
        body = blob[pos + 8 : pos + 8 + size]
        if cid == b"COMM":
            n_channels, n_frames, bits = struct.unpack_from(">hLh", body, 0)
            rate = _read_f80(body[8:18])
            if is_aifc and len(body) >= 22:
                comp = body[18:22]
            comm = (n_channels, n_frames, bits, rate)
        elif cid == b"SSND":
            offset, _block = struct.unpack_from(">LL", body, 0)
            ssnd = body[8 + offset :]
        pos += 8 + size + (size & 1)
    if comm is None or ssnd is None:
        raise ValueError(f"missing COMM/SSND chunk: {path}")
    n_channels, n_frames, bits, rate = comm
    if comp in (b"NONE", b"twos", b"sowt"):
        # sampleSize may be any 1..32 bits (AIFF-C spec); samples are
        # left-justified in ceil(bits/8) bytes, so decoding at the storage
        # width with a storage-width scale is exact (e.g. 20-bit in 3 bytes
        # decodes as 24-bit)
        sampwidth = (bits + 7) // 8
        raw = ssnd[: n_frames * n_channels * sampwidth]
        if comp == b"sowt":  # little-endian PCM: _decode_pcm's native order
            if sampwidth == 1:  # AIFF 8-bit is signed (unlike WAV's u8)
                data = (
                    np.frombuffer(raw, np.int8).astype(np.float32) / 128.0
                ).reshape(-1, n_channels)
            else:
                data = _decode_pcm(raw, sampwidth, n_channels)
        elif sampwidth == 3:
            b3 = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            ints = (
                (b3[:, 0].astype(np.int32) << 16)
                | (b3[:, 1].astype(np.int32) << 8)
                | b3[:, 2].astype(np.int32)
            )
            ints = (ints ^ 0x800000) - 0x800000  # sign-extend 24-bit
            data = (ints.astype(np.float32) / float(1 << 23)).reshape(
                -1, n_channels
            )
        else:
            dt = {1: ">i1", 2: ">i2", 4: ">i4"}.get(sampwidth)
            if dt is None:
                raise ValueError(f"unsupported AIFF sample width: {sampwidth}")
            scale = float(1 << (8 * sampwidth - 1))
            data = (
                np.frombuffer(raw, dt).astype(np.float32) / scale
            ).reshape(-1, n_channels)
    elif comp in (b"fl32", b"FL32"):
        data = (
            np.frombuffer(ssnd[: n_frames * n_channels * 4], ">f4")
            .astype(np.float32)
            .reshape(-1, n_channels)
        )
    elif comp in (b"fl64", b"FL64"):
        data = (
            np.frombuffer(ssnd[: n_frames * n_channels * 8], ">f8")
            .astype(np.float32)
            .reshape(-1, n_channels)
        )
    else:
        raise ValueError(
            f"compressed AIFC ({comp!r}) is not supported — no codec "
            f"library in this environment; convert to PCM first: {path}"
        )
    return AudioData(data, int(round(rate)))


def read_audio(path: str | Path) -> AudioData:
    """Read any supported audio file, sniffed by container magic (the
    juce AudioFormatManager analog): RIFF/WAVE, FORM/AIFF-AIFC natively;
    OGG Vorbis and MP3 via system codec libraries where present
    (io/codecs.py). FLAC has no codec library in this environment."""
    path = Path(path)
    with open(path, "rb") as f:
        magic = f.read(12)
    if magic[:4] == b"RIFF" and magic[8:12] == b"WAVE":
        return read_wav(path)
    if magic[:4] == b"FORM" and magic[8:12] in (b"AIFF", b"AIFC"):
        return read_aiff(path)
    if magic[:4] == b"OggS":
        from .codecs import read_ogg

        return read_ogg(path)  # raises clearly when libvorbisfile absent
    if magic[:4] == b"fLaC":
        from .flac import read_flac

        return read_flac(path)  # raises clearly if the decoder can't build
    if magic[:3] == b"ID3" or (
        len(magic) >= 2 and magic[0] == 0xFF and (magic[1] & 0xE0) == 0xE0
    ):
        from .codecs import read_mp3

        return read_mp3(path)  # raises clearly when libmpg123 absent
    # fall through: let the WAV parser produce its error for near-WAVs
    return read_wav(path)


def write_wav(
    path: str | Path,
    samples: np.ndarray,
    sample_rate: int,
    bit_depth: int = 16,
) -> None:
    """Write float32 [frames, channels] (or [frames]) to a PCM WAV.

    The reference records 16-bit WAV at the engine rate
    (lib/AudioLevels.cpp:44-58); bit_depth 16/24/32 supported.
    """
    samples = np.asarray(samples, dtype=np.float32)
    if samples.ndim == 1:
        samples = samples[:, None]
    clipped = np.clip(samples, -1.0, 1.0)
    n_channels = clipped.shape[1]
    if bit_depth == 16:
        ints = np.round(clipped * 32767.0).astype("<i2")
        raw = ints.tobytes()
        sampwidth = 2
    elif bit_depth == 24:
        # f64 like the 32-bit path: f32 spacing is 1.0 at magnitude 2^23,
        # so scaling in f32 costs 1 LSB on ~17% of samples
        ints = np.round(
            clipped.astype(np.float64) * float((1 << 23) - 1)
        ).astype(np.int32)
        b = np.empty((ints.size, 3), dtype=np.uint8)
        flat = ints.reshape(-1)
        b[:, 0] = flat & 0xFF
        b[:, 1] = (flat >> 8) & 0xFF
        b[:, 2] = (flat >> 16) & 0xFF
        raw = b.tobytes()
        sampwidth = 3
    elif bit_depth == 32:
        ints = np.round(clipped.astype(np.float64) * float((1 << 31) - 1)).astype("<i4")
        raw = ints.tobytes()
        sampwidth = 4
    else:
        raise ValueError(f"unsupported bit depth: {bit_depth}")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(n_channels)
        w.setsampwidth(sampwidth)
        w.setframerate(int(sample_rate))
        w.writeframes(raw)


def to_stereo(samples: np.ndarray) -> np.ndarray:
    """[frames] or [frames, 1] -> duplicated stereo; >=2ch -> first two.

    The voice kernel always operates on 2-channel sample memory: the reference
    computes the mono right channel from the same expression as the left
    (lib/SamplerSynthVoice.cpp:205), so duplicating mono up front is exact.
    """
    if samples.ndim == 1:
        samples = samples[:, None]
    if samples.shape[1] == 1:
        return np.repeat(samples, 2, axis=1)
    return samples[:, :2]
