"""FLAC support: native decoder binding + pure-Python encoder.

Completes the juce basic-formats matrix (reference lib/WaveFormItem.cpp:29
registerBasicFormats — WAV, AIFF, FLAC, OGG, MP3). This environment ships
no libFLAC, so both sides are implemented from the FLAC specification
(RFC 9639):

- `read_flac`: ctypes binding over native/zl_flac.cpp (built on demand with
  g++, the same pattern as ops/stretch_native.py) — full subframe coverage
  (CONSTANT/VERBATIM/FIXED/LPC, Rice partitions, wasted bits, all stereo
  decorrelation modes).
- `write_flac`: a compact lossless encoder (16-bit, FIXED order-2
  predictor, single-partition Rice residuals, optional mid/side and
  left/side stereo, correct CRC-8/CRC-16) — a real feature (the reference
  records WAV only) and the spec-independent producer for the decoder's
  roundtrip tests: encode->decode must be bit-exact.

A copy of libzl_tpu/io/flac.py, verbatim apart from this note: the port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path
from typing import Optional

import numpy as np

from .wav import AudioData

_lib: Optional[ctypes.CDLL] = None


def load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    from .._native import load_native

    lib = load_native("zl_flac", "zl_flac_abi_version", 1)
    if lib is None:
        return None
    lib.zl_flac_probe.restype = ctypes.c_int
    lib.zl_flac_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.zl_flac_decode.restype = ctypes.c_int64
    lib.zl_flac_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def read_flac(path: str | Path) -> AudioData:
    """Decode a FLAC file to float32 [frames, channels]."""
    lib = load()
    if lib is None:
        raise ValueError(
            f"FLAC is not supported on this host (native decoder failed to "
            f"build); convert to WAV/AIFF first: {path}"
        )
    blob = Path(path).read_bytes()
    rate = ctypes.c_int32(0)
    channels = ctypes.c_int32(0)
    bits = ctypes.c_int32(0)
    total = ctypes.c_int64(0)
    if lib.zl_flac_probe(blob, len(blob), ctypes.byref(rate),
                         ctypes.byref(channels), ctypes.byref(bits),
                         ctypes.byref(total)) != 0:
        raise ValueError(f"not a decodable FLAC file: {path}")
    # cap the allocation guess against the COMPRESSED size: total_samples
    # is an untrusted 36-bit header field, and a corrupt value of 2^36-1
    # would np.empty ~550 GB before any decoding. FLAC compresses 16-bit
    # PCM at best ~8:1 in practice; 16 bytes of PCM per compressed byte is
    # a generous ceiling, and the doubling retry below recovers if a
    # legitimate stream ever exceeds it (treated like total==0).
    alloc_limit = max(len(blob) * 16 // max(channels.value, 1), 65536)
    cap = int(total.value) if total.value > 0 else max(
        len(blob) * 4 // max(channels.value, 1), 65536
    )
    header_overclaims = cap > alloc_limit
    if header_overclaims:
        cap = alloc_limit
    while True:
        out = np.empty((cap, channels.value), np.float32)
        n = lib.zl_flac_decode(
            blob, len(blob),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap,
        )
        if n == -11 and (total.value == 0 or header_overclaims):
            # capacity guess too small — grow, but bounded: hyper-
            # compressed silence is legitimate, a runaway corrupt stream
            # is not
            if cap >= 1 << 30:
                raise ValueError(
                    f"FLAC stream exceeds the 2^30-sample decode ceiling "
                    f"({total.value} declared): {path}"
                )
            cap *= 2
            continue
        if n < 0:
            raise ValueError(f"corrupt FLAC stream (rc={n}): {path}")
        if 0 < total.value != n:
            # the decoder stops at a corrupt mid-stream frame; a silent
            # half-length clip is worse than an error when STREAMINFO
            # declares the true length
            raise ValueError(
                f"truncated FLAC stream: decoded {n} of "
                f"{total.value} declared samples: {path}"
            )
        return AudioData(np.array(out[:n]), int(rate.value))


# ------------------------------------------------------------------ encoder

class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, bits: int) -> None:
        if bits <= 0:
            return
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.nbits += bits
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def align(self) -> None:
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _make_crc8_table() -> list[int]:
    table = []
    for b in range(256):
        crc = b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
        table.append(crc)
    return table


def _make_crc16_table() -> list[int]:
    table = []
    for b in range(256):
        crc = b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
        table.append(crc)
    return table


_CRC8_TABLE = _make_crc8_table()
_CRC16_TABLE = _make_crc16_table()


def _crc8(data: bytes) -> int:
    # table-driven: the bit-at-a-time loop was ~8 Python ops per frame byte
    # on the encoder's hot path (long recordings transcode post-roll)
    crc = 0
    for b in data:
        crc = _CRC8_TABLE[crc ^ b]
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = _CRC16_TABLE[((crc >> 8) ^ b) & 0xFF] ^ ((crc << 8) & 0xFFFF)
    return crc


def _utf8_number(n: int) -> bytes:
    """FLAC's UTF-8-like coded number (RFC 9639 §9.1.5): the UTF-8 framing
    with no surrogate gap and widths up to 36 bits — chr().encode() would
    reject 0xD800-0xDFFF and anything past 0x10FFFF."""
    if n < 0x80:
        return bytes([n])
    for k, prefix, bits in ((1, 0xC0, 11), (2, 0xE0, 16), (3, 0xF0, 21),
                            (4, 0xF8, 26), (5, 0xFC, 31), (6, 0xFE, 36)):
        if n < (1 << bits):
            lead_bits = bits - 6 * k
            out = [prefix | ((n >> (6 * k)) & ((1 << lead_bits) - 1))]
            for i in range(k - 1, -1, -1):
                out.append(0x80 | ((n >> (6 * i)) & 0x3F))
            return bytes(out)
    raise ValueError(f"coded number out of range: {n}")


# quotient cap above which a partition is written as an escape (raw bits)
# partition; tests lower it to force the decoder's escape path
_ESCAPE_QUOTIENT_LIMIT = 4096


def _write_residual(bw: _BitWriter, res: np.ndarray, order: int,
                    blocksize: int, partition_order: int) -> None:
    """Partitioned Rice residual (method 0, 4-bit params)."""
    partitions = 1 << partition_order
    psize = blocksize >> partition_order
    bw.write(0, 2)                  # residual method: 4-bit Rice
    bw.write(partition_order, 4)
    pos = 0
    for p in range(partitions):
        count = psize - (order if p == 0 else 0)
        part = res[pos : pos + count]
        pos += count
        zz = (np.abs(part) * 2 - (part < 0)).astype(np.uint64)
        mean = float(zz.mean()) if len(zz) else 0.0
        k = min(max(int(mean).bit_length() - 1, 0), 14)
        if len(zz) and int((zz >> k).max()) > _ESCAPE_QUOTIENT_LIMIT:
            # escape partition: raw fixed-width residuals
            raw = int(max(int(zz.max()).bit_length(), 1)) + 1
            bw.write(0xF, 4)
            bw.write(raw, 5)
            for v in part.tolist():
                bw.write(int(v) & ((1 << raw) - 1), raw)
            continue
        bw.write(k, 4)
        mask = (1 << k) - 1
        for q, r in zip((zz >> k).tolist(), (zz & mask).tolist()):
            bw.write(1, int(q) + 1)  # unary: q zeros then a 1
            if k:
                bw.write(int(r), k)


_LPC_ORDER = 4
_LPC_PRECISION = 12
_LPC_SHIFT = 10


def _write_subframe(bw: _BitWriter, sig: np.ndarray, bps: int,
                    predictor: str = "fixed",
                    partition_order: int = 0) -> None:
    """One subframe: CONSTANT where possible, else FIXED order-2 or LPC
    order-4 with partitioned Rice residuals, VERBATIM as overflow fallback.
    Detects and encodes wasted bits (common trailing zero bits)."""
    n = len(sig)
    if n and (sig == sig[0]).all():
        bw.write(0, 1)
        bw.write(0, 6)          # CONSTANT
        bw.write(0, 1)          # no wasted bits
        bw.write(int(sig[0]) & ((1 << bps) - 1), bps)
        return
    # wasted bits: common trailing zeros across the block (spec 9.2.2)
    wasted = 0
    if n and sig.any():
        ored = int(np.bitwise_or.reduce(np.abs(sig).astype(np.int64)))
        while wasted < 8 and ored and not (ored >> wasted) & 1:
            wasted += 1
    if wasted:
        sig = sig >> wasted
        bps -= wasted

    order = 0
    if predictor == "lpc" and n > 2 * _LPC_ORDER:
        order = _LPC_ORDER
        # least-squares LPC on the float signal, quantized; exactness comes
        # from computing the residual with the SAME integer formula the
        # decoder inverts
        f = sig.astype(np.float64)
        A = np.stack([f[order - 1 - j : n - 1 - j] for j in range(order)], 1)
        coefs, *_ = np.linalg.lstsq(A, f[order:], rcond=None)
        qc = np.clip(
            np.round(coefs * (1 << _LPC_SHIFT)),
            -(1 << (_LPC_PRECISION - 1)), (1 << (_LPC_PRECISION - 1)) - 1,
        ).astype(np.int64)
        pred = np.zeros(n - order, np.int64)
        for j in range(order):
            pred += qc[j] * sig[order - 1 - j : n - 1 - j].astype(np.int64)
        res = sig[order:].astype(np.int64) - (pred >> _LPC_SHIFT)
    elif n > 2:
        order = 2
        res = sig[2:].astype(np.int64) - 2 * sig[1:-1].astype(np.int64) \
            + sig[:-2].astype(np.int64)
    else:
        res = sig.astype(np.int64)

    if (1 << partition_order) > 1 and (
        n % (1 << partition_order) != 0
        or (n >> partition_order) <= order
    ):
        partition_order = 0

    zz_all = np.abs(res) * 2
    # keep escape-partition raw widths within the 5-bit field (<= 31)
    if len(res) and int(zz_all.max()) > (1 << 28):
        bw.write(0, 1)
        bw.write(1, 6)          # VERBATIM
        bw.write(1 if wasted else 0, 1)
        if wasted:
            bw.write(1, wasted)  # unary(wasted-1): zeros then 1
        for v in sig.tolist():
            bw.write(int(v) & ((1 << bps) - 1), bps)
        return

    bw.write(0, 1)
    if order and predictor == "lpc" and order == _LPC_ORDER:
        bw.write(0b100000 | (order - 1), 6)   # LPC
    else:
        bw.write(0b001000 | order, 6)         # FIXED
    if wasted:
        bw.write(1, 1)
        bw.write(1, wasted)     # unary-coded wasted-1: (w-1) zeros then 1
    else:
        bw.write(0, 1)
    for v in sig[:order].tolist():  # warmup
        bw.write(int(v) & ((1 << bps) - 1), bps)
    if order and predictor == "lpc" and order == _LPC_ORDER:
        bw.write(_LPC_PRECISION - 1, 4)
        bw.write(_LPC_SHIFT, 5)
        for c in qc.tolist():
            bw.write(int(c) & ((1 << _LPC_PRECISION) - 1), _LPC_PRECISION)
    _write_residual(bw, res, order, n, partition_order)


def write_flac(
    path: str | Path, samples: np.ndarray, sample_rate: int,
    stereo_mode: str = "independent", block_size: int = 4096,
    predictor: str = "fixed", partition_order: int = 0,
) -> None:
    """Encode float32 [frames, channels<=2] (or [frames]) to 16-bit FLAC.

    stereo_mode: independent | mid-side | left-side | right-side (the
    decorrelation variants; all decode back bit-exactly)."""
    if not 16 <= int(block_size) <= 65535:
        # RFC 9639: STREAMINFO min/max blocksize are 16-bit, >= 16; out of
        # range silently wrapped in the header and broke external decoders
        raise ValueError(f"block_size must be within 16..65535: {block_size}")
    if not 1 <= int(sample_rate) < (1 << 20):
        # same wrap class: STREAMINFO's rate field is 20-bit — an
        # out-of-range rate silently truncates (1500000 -> 451424 Hz) and
        # 0 produces a stream our own reader rejects
        raise ValueError(
            f"sample_rate must be within 1..{(1 << 20) - 1}: {sample_rate}"
        )
    x = np.asarray(samples, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    n_frames, channels = x.shape
    if channels > 2:
        raise ValueError("FLAC encoder supports at most 2 channels")
    pcm = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int32)

    out = bytearray(b"fLaC")
    # STREAMINFO (last metadata block)
    si = _BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(int(sample_rate), 20)
    si.write(channels - 1, 3)
    si.write(16 - 1, 5)
    si.write(n_frames, 36)
    # STREAMINFO MD5: over the raw interleaved little-endian 16-bit samples
    # (lets external FLAC tools verify our streams; our decoder doesn't)
    import hashlib

    md5 = hashlib.md5(
        np.ascontiguousarray(pcm.astype("<i2")).tobytes()
    ).digest()
    body = si.bytes() + md5
    out += bytes([0x80]) + struct.pack(">I", len(body))[1:] + bytes(body)

    mode_code = {
        "independent": None, "left-side": 8, "right-side": 9, "mid-side": 10,
    }[stereo_mode]
    if channels == 1:
        mode_code = None

    for fi, lo in enumerate(range(0, n_frames, block_size)):
        blk = pcm[lo : lo + block_size]
        bs = blk.shape[0]
        bw = _BitWriter()
        bw.write(0x3FFE, 14)        # sync
        bw.write(0, 1)              # reserved
        bw.write(0, 1)              # fixed blocksize strategy
        bw.write(7, 4)              # blocksize: 16-bit at end of header
        bw.write(0, 4)              # sample rate: from STREAMINFO
        ch_code = (channels - 1) if mode_code is None else mode_code
        bw.write(ch_code, 4)
        bw.write(4, 3)              # sample size: 16-bit
        bw.write(0, 1)              # reserved
        for b in _utf8_number(fi):
            bw.write(b, 8)
        bw.write(bs - 1, 16)
        bw.align()
        header = bw.bytes()
        header += bytes([_crc8(header)])

        fw = _BitWriter()
        if mode_code is None:
            subs = [(blk[:, c].astype(np.int64), 16)
                    for c in range(channels)]
        else:
            left = blk[:, 0].astype(np.int64)
            right = blk[:, 1].astype(np.int64)
            side = left - right
            if mode_code == 8:
                subs = [(left, 16), (side, 17)]
            elif mode_code == 9:
                subs = [(side, 17), (right, 16)]
            else:
                mid = (left + right) >> 1
                subs = [(mid, 16), (side, 17)]
        for sig, bps in subs:
            _write_subframe(fw, sig, bps, predictor=predictor,
                            partition_order=partition_order)
        fw.align()
        frame = header + fw.bytes()
        frame += struct.pack(">H", _crc16(frame))
        out += frame

    Path(path).write_bytes(bytes(out))
