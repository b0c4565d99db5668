"""The windows sample fetch (counterpart of libzl_tpu/ops/fetch_pallas.py).

For each voice the host anchors two fetch regions on 512-sample boundaries of
the planar bank: region A around the current playback segment and region B
around the loop-reset target (engine/voicestate.build_program). The render
addresses them with window-relative positions `pos_local`: [0, region) is
region A, [region, 2*region) is region B. `fetch_interp` returns the pre-gain
linearly interpolated stereo pair [V, 2, B]; gain, envelope, pan and mixdown
stay outside it.

Two implementations of one contract (see csrc/fetch_interp.cu):
- `fetch_interp_plain`: plain PyTorch indexing on the absolute tap indices;
  the CPU path, and the kernel's oracle on the card;
- the CUDA kernel, launched by `fetch_interp` for CUDA tensors.
"""

from __future__ import annotations

import torch

from ..constants import MAX_PITCH_RATIO, WINDOW_ANCHOR_BLOCK
from ..engine.soundbank import region_tail_guard
from . import launch_tally

SOUND_BLOCK = 512     # window anchor granularity (samples)
R_MAX = 4.0           # max pitch ratio (span per block = R_MAX * B)
assert SOUND_BLOCK == WINDOW_ANCHOR_BLOCK
assert R_MAX == MAX_PITCH_RATIO

_INT16_DEQUANT = 1.0 / 32767.0  # the gather path's rule (ops/voice.py)

# The reference's suffix grammar (fetch_pallas.parse_suffix). Every token
# only steers the Mosaic schedule of the TPU kernel — dot precision, chunk
# variant, chunk size, slab alignment, voice group — so the port parses and
# validates them exactly as the reference does, then ignores them: one CUDA
# kernel serves every variant.
_PRECISIONS = ("highest", "default")
_VARIANTS = ("loop", "fusedw", "batchdot", "grid", "auto")


def region_rows(block_frames: int, r_max: float = R_MAX) -> int:
    """Samples per fetch region: anchor slack + max span, 512-aligned (the
    same value as the bank's tail guard)."""
    return region_tail_guard(block_frames, r_max)


def parse_suffix(suffix: str):
    """Parse a `fetch="windows:..."` suffix exactly as the reference does;
    returns (precision, variant, chunk, align, group). Unknown tokens and
    out-of-range values raise ValueError."""
    precision, variant = "highest", "auto"
    chunk, align, group = 128, 128, 8
    for tok in filter(None, suffix.split(",")):
        if tok in _PRECISIONS:
            precision = tok
        elif tok in _VARIANTS:
            variant = tok
        elif tok[:1] == "c" and tok[1:].isdigit():
            chunk = int(tok[1:])
            if chunk not in (32, 64, 128, 256):
                raise ValueError(f"chunk {chunk} not in (32, 64, 128, 256)")
        elif tok[:1] == "a" and tok[1:].isdigit():
            align = int(tok[1:])
            if align not in (8, 16, 32, 64, 128):
                raise ValueError(f"align {align} not in (8..128, pow2)")
        elif tok[:1] == "g" and tok[1:].isdigit():
            group = int(tok[1:])
            if group not in (8, 16, 32):
                raise ValueError(f"group {group} not in (8, 16, 32)")
        else:
            raise ValueError(
                f"unknown windows fetch suffix token {tok!r}: precision in "
                f"{sorted(_PRECISIONS)}, variant in {list(_VARIANTS)}, "
                f"chunk 'c<n>', alignment 'a<n>' or group 'g<n>'"
            )
    return precision, variant, chunk, align, group


def _tap_index(q, base_a, base_b, region: int):
    """Window-relative tap q -> absolute bank index (int64)."""
    return torch.where(q < region, base_a + q, base_b + (q - region))


def fetch_interp_plain(sound_data, pos_local, alpha, win_blk_a, win_blk_b,
                       r_max: float = R_MAX):
    """Plain PyTorch version of the windows fetch: [V, 2, B] f32.

    sound_data [2, N] f32 or int16 (planar); pos_local [V, B] int32;
    alpha [V, B] f32; win_blk_a / win_blk_b [V] int32 (512-sample block
    indices). Frames outside 0 <= p < 2*region - 1 give exactly 0, and a tap
    outside [0, N) reads 0."""
    B = pos_local.shape[1]
    region = region_rows(B, r_max)
    n = sound_data.shape[1]
    p = pos_local.long()
    valid = (p >= 0) & (p < 2 * region - 1)
    base_a = win_blk_a.long()[:, None] * SOUND_BLOCK
    base_b = win_blk_b.long()[:, None] * SOUND_BLOCK

    def tap(q):
        i = _tap_index(q, base_a, base_b, region)
        ok = (i >= 0) & (i < n)
        s = sound_data[:, i.clamp(0, n - 1)]          # [2, V, B]
        if s.dtype == torch.int16:
            s = s.to(torch.float32) * _INT16_DEQUANT
        return torch.where(ok, s, 0.0)

    out = tap(p) * (1.0 - alpha) + tap(p + 1) * alpha
    out = torch.where(valid, out, 0.0)
    return out.permute(1, 0, 2).contiguous()


def _check_cuda_args(sound_data, pos_local, alpha, win_blk_a, win_blk_b):
    dev = sound_data.device
    V, B = pos_local.shape
    want = (
        (sound_data, (torch.float32, torch.int16), None),
        (pos_local, (torch.int32,), (V, B)),
        (alpha, (torch.float32,), (V, B)),
        (win_blk_a, (torch.int32,), (V,)),
        (win_blk_b, (torch.int32,), (V,)),
    )
    for name, (t, dtypes, shape) in zip(
            ("sound_data", "pos_local", "alpha", "win_blk_a", "win_blk_b"),
            want):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, sound_data on {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sound_data.dim() != 2 or sound_data.shape[0] != 2:
        raise ValueError(
            f"sound_data must be planar [2, N], got {tuple(sound_data.shape)}")


def fetch_interp(sound_data, pos_local, alpha, win_blk_a, win_blk_b,
                 r_max: float = R_MAX):
    """Windows fetch: [V, 2, B] f32 linear-interpolated, pre-gain samples.

    CPU tensors take `fetch_interp_plain`. CUDA tensors launch the kernel
    (csrc/fetch_interp.cu) on the calling thread's current stream, or
    raise: a CUDA tensor never reaches the plain version.
    `fetch_interp.launches` counts kernel launches from every thread."""
    if sound_data.device.type == "cpu":
        return fetch_interp_plain(sound_data, pos_local, alpha, win_blk_a,
                                  win_blk_b, r_max=r_max)
    if sound_data.device.type != "cuda":
        raise ValueError(f"fetch_interp: unsupported device "
                         f"{sound_data.device}")
    from .. import _build

    _check_cuda_args(sound_data, pos_local, alpha, win_blk_a, win_blk_b)
    V, B = pos_local.shape
    out = torch.empty((V, 2, B), dtype=torch.float32,
                      device=sound_data.device)
    if V * B == 0:
        return out
    lib = _build.load()
    fn = (lib.zl_fetch_interp_i16 if sound_data.dtype == torch.int16
          else lib.zl_fetch_interp_f32)
    with torch.cuda.device(sound_data.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(sound_data.data_ptr(), sound_data.shape[1],
                  pos_local.data_ptr(), alpha.data_ptr(),
                  win_blk_a.data_ptr(), win_blk_b.data_ptr(), out.data_ptr(),
                  V, B, region_rows(B, r_max), stream)
    _build.check(lib, code, "fetch_interp launch")
    _count_launch()
    return out


def _count_launch() -> None:
    launch_tally.count("fetch_interp")


fetch_interp = launch_tally.register("fetch_interp", fetch_interp)
