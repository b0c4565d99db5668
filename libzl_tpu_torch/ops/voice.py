"""The voice render: its numpy host half and its torch device half.

The counterpart of libzl_tpu/ops/voice.py. All sampler voices for one block
over a [V voices, B frames] grid: segment positions, closed-form ADSR, the
interpolated sample fetch (gather or the windows kernel), gain, M/S pan,
per-voice peaks and the lane mixdown. The formulas, their f32 order and the
reference's routing rules are the reference's; see its module docstring for
the semantics. The one exception is the mixdown: the reference's one-hot
product leaves its summation order to the library, the port's
(ops/mixdown.py) sums each lane's voices in pool order, so a mesh gives the
unsharded engine's bits.

The host half is the reference's numpy code, copied verbatim: the packed
program layout (`VoiceProgram`, `pack_program`, `fuse_packed`,
`unpack_program`, which only slices columns and so unpacks tensors too),
the host half of the compact lookahead horizon (`pack_horizon_dynamics`,
`horizon_dyn_cols`), `pack_strips` and `empty_program`. The device half
(`split_fused`, `unpack_horizon_slice`, `horizon_programs`,
`HorizonSlice`, `horizon_sources`, `voice_contrib`, `render_voices`) runs
on tensors; the per-frame body around the fetch (positions, envelope,
gain, masks, pan, peaks, and a horizon slice's unpack on the windows path)
is ops/voice_render.py's, whose `positions_block` this module re-exports.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..constants import (
    MAX_SEGMENTS_PER_BLOCK,
    NUM_SAMPLER_CHANNELS,
    WINDOW_ANCHOR_BLOCK,
)
from . import adsr as adsr_ops
from .fetch_windows import _INT16_DEQUANT, fetch_interp, parse_suffix
from .mixdown import lane_mixdown
from .voice_render import (  # noqa: F401 (positions_block: this module's API)
    pan_and_peak,
    positions_block,
    voice_fields,
    voice_post,
    voice_prep,
    voice_prep_slice,
)

# ----------------------------------------------------------- host half


class VoiceProgram(NamedTuple):
    """Per-voice render program for one block.

    Arrays are [V] unless noted. Segment arrays are [V, S] with
    S = MAX_SEGMENTS_PER_BLOCK; unused segments carry seg_start == B (never
    selected). Segment 0 starts at `start_frame`.
    """

    active: Any          # int32 0/1: voice renders this block
    base: Any            # int32: sound base offset in the flat sample array
    len_minus1: Any      # int32: sound length - 1 ("sampleDuration")
    win_blk_a: Any       # int32: fetch window A anchor (512-sample block index)
    win_blk_b: Any       # int32: fetch window B anchor (loop-reset target)
    seg_start: Any       # int32 [V, S]: first frame of each segment
    seg_pos_int: Any     # int32 [V, S]: whole sample position at segment start
    seg_pos_frac: Any    # f32   [V, S]: fractional sample position at segment start
    rate_int: Any        # int32: whole part of pitchRatio
    rate_frac: Any       # f32: fractional part of pitchRatio
    start_frame: Any     # int32: first frame to render (sample-accurate starts)
    stop_frame: Any      # int32: first frame NOT to render (B if none)
    gain: Any            # f32: lgain == rgain (velocityToGain == identity)
    clip_volume: Any     # f32: clip volumeAbsolute
    pan: Any             # f32: clip pan in [-1, 1]
    lane: Any            # int32: sampler channel lane 0..11
    loop_period: Any     # int32: frames between positional resets; 0 = n/a.
                         #   Containment past the segment horizon: the wrap
                         #   schedule expresses at most S-1 wraps per block,
                         #   but the reference wraps per sample without
                         #   limit (lib/SamplerSynthVoice.cpp:243-247).
                         #   Positional loops repeat every loop_period
                         #   FRAMES (each reset discards the fractional
                         #   overshoot and restarts at the integer loop
                         #   start = the wrap segment's seg_pos), so frames
                         #   in a wrap segment use j mod period — exact for
                         #   any number of wraps.
    bq_reset: Any        # int32 [V, W]: beat-quantized reset frames past
                         #   the segment horizon (wraps S..S-1+W), B when
                         #   unused. Beat-quantized loops wrap on the WALL
                         #   CLOCK (lib/SamplerSynthVoice.cpp:225-242) and
                         #   legitimately play past the loop stop between
                         #   boundaries, so no modulo containment applies;
                         #   instead the host precomputes EVERY in-block
                         #   reset frame in float64 (the wrap count per
                         #   block is bounded by the BPM ceiling — see
                         #   constants.bq_extra_resets; W = 0 at the live
                         #   geometry) and the kernel applies them as
                         #   integer `k >= r` rebases — exact for any
                         #   number of wraps.
    env: adsr_ops.AdsrProgram


_INT_SCALARS = [
    "active", "base", "len_minus1", "win_blk_a", "win_blk_b", "rate_int",
    "start_frame", "stop_frame", "lane",
]
_INT_ENV = ["stage0", "release_frame", "rel_mode"]
# trailing int columns (packed AFTER the segment arrays so the native host
# core's earlier column indices stay stable — native/zl_hostcore.cpp)
_INT_TRAILER = ["loop_period"]
_F32_SCALARS = ["rate_frac", "gain", "clip_volume", "pan"]
_F32_ENV = [
    "env0", "a_rate", "d_rate", "sustain", "rel_rate", "inv_rel", "rel_log2",
]


def pack_program(prog: VoiceProgram):
    """Pack a VoiceProgram into two dense arrays: (i32 [V, Ki], f32 [V, Kf]).

    The host builds ~27 small per-voice arrays per block; shipping them to the
    device individually costs one transfer latency each (expensive over a
    remote PJRT link). Packing makes the per-block host->device traffic
    exactly two contiguous buffers; `unpack_program` runs inside the jitted
    graph where slicing is free.
    """
    ints = [np.asarray(getattr(prog, n), np.int32)[:, None] for n in _INT_SCALARS]
    ints += [np.asarray(getattr(prog.env, n), np.int32)[:, None] for n in _INT_ENV]
    ints += [np.asarray(prog.seg_start, np.int32),
             np.asarray(prog.seg_pos_int, np.int32)]
    ints += [np.asarray(getattr(prog, n), np.int32)[:, None]
             for n in _INT_TRAILER]
    # trailing variable-width block: W beat-quantized reset columns (the
    # count is static per engine geometry; unpack infers it from the shape)
    ints += [np.asarray(prog.bq_reset, np.int32)]
    floats = [np.asarray(getattr(prog, n), np.float32)[:, None]
              for n in _F32_SCALARS]
    floats += [np.asarray(getattr(prog.env, n), np.float32)[:, None]
               for n in _F32_ENV]
    floats += [np.asarray(prog.seg_pos_frac, np.float32)]
    return np.concatenate(ints, axis=1), np.concatenate(floats, axis=1)


def fuse_packed(prog_i: np.ndarray, prog_f: np.ndarray) -> np.ndarray:
    """Fuse the packed program pair into ONE int32 matrix [V, Ki+Kf] (f32
    columns bit-cast). On relay-attached TPUs every per-block host->device
    buffer costs a ~1 ms transfer round trip regardless of size (probe
    tpu_probe1_r3: two-array upload 2.1 ms, device-resident args 1.2 ms) —
    one buffer halves the live path's dominant cost. `split_fused` undoes
    it inside the jit where slicing and bitcasts are free."""
    return np.concatenate([prog_i, prog_f.view(np.int32)], axis=1)


def fused_cols(n_bq_extra: int = 0) -> int:
    """Width of a fuse_packed program [V, Ki+Kf] at the given bq tail
    (the pack_program layout above) — the static split point when a
    horizon ships base+dynamics as one concatenated buffer."""
    S = MAX_SEGMENTS_PER_BLOCK
    return (len(_INT_SCALARS) + len(_INT_ENV) + 2 * S + len(_INT_TRAILER)
            + n_bq_extra + len(_F32_SCALARS) + len(_F32_ENV) + S)


def active_high_water(prog_i) -> int:
    """Highest packed-program row with the active flag set, plus one
    (0 when no row is active). The program's `active` column is the
    authoritative per-block render mask: it includes voices that die
    DURING this block (they still render their final partial frames),
    unlike pool.active which the native host core has already advanced
    past the kill by dispatch time."""
    col = _INT_SCALARS.index("active")
    nz = np.flatnonzero(np.asarray(prog_i[:, col]))
    return int(nz[-1]) + 1 if nz.size else 0


def unpack_program(ints, floats) -> VoiceProgram:
    """Inverse of pack_program; works on numpy or traced jax arrays."""
    S = MAX_SEGMENTS_PER_BLOCK
    ni, ne = len(_INT_SCALARS), len(_INT_ENV)
    nf, nfe = len(_F32_SCALARS), len(_F32_ENV)
    int_cols = {n: ints[:, i] for i, n in enumerate(_INT_SCALARS)}
    env_int = {n: ints[:, ni + i] for i, n in enumerate(_INT_ENV)}
    seg_start = ints[:, ni + ne : ni + ne + S]
    seg_pos_int = ints[:, ni + ne + S : ni + ne + 2 * S]
    trailer = {n: ints[:, ni + ne + 2 * S + i]
               for i, n in enumerate(_INT_TRAILER)}
    bq_reset = ints[:, ni + ne + 2 * S + len(_INT_TRAILER):]
    f_cols = {n: floats[:, i] for i, n in enumerate(_F32_SCALARS)}
    env_f = {n: floats[:, nf + i] for i, n in enumerate(_F32_ENV)}
    seg_pos_frac = floats[:, nf + nfe : nf + nfe + S]
    env = adsr_ops.AdsrProgram(
        stage0=env_int["stage0"],
        release_frame=env_int["release_frame"],
        rel_mode=env_int["rel_mode"],
        **env_f,
    )
    return VoiceProgram(
        seg_start=seg_start,
        seg_pos_int=seg_pos_int,
        seg_pos_frac=seg_pos_frac,
        bq_reset=bq_reset,
        env=env,
        **int_cols,
        **trailer,
        **f_cols,
    )


# --- compact lookahead-horizon dynamics -------------------------------
# Packed-layout column indices (the pack_program contract above; the native
# host core emits the same layout — native/zl_hostcore.cpp).
PI_ACTIVE = _INT_SCALARS.index("active")
PI_START = _INT_SCALARS.index("start_frame")
PI_STOP = _INT_SCALARS.index("stop_frame")
PI_STAGE0 = len(_INT_SCALARS) + _INT_ENV.index("stage0")
PI_RELEASE = len(_INT_SCALARS) + _INT_ENV.index("release_frame")
PI_RELMODE = len(_INT_SCALARS) + _INT_ENV.index("rel_mode")
PI_SEG_START = len(_INT_SCALARS) + len(_INT_ENV)
PI_SEG_POS = PI_SEG_START + MAX_SEGMENTS_PER_BLOCK
PI_BQ = PI_SEG_POS + MAX_SEGMENTS_PER_BLOCK + len(_INT_TRAILER)
PF_ENV0 = len(_F32_SCALARS) + _F32_ENV.index("env0")
PF_REL_RATE = len(_F32_SCALARS) + _F32_ENV.index("rel_rate")
PF_SEG_FRAC = len(_F32_SCALARS) + len(_F32_ENV)

# "no release this block": engine/voicestate._BIG as int32 — pinned equal by
# tests/test_lookahead.py so the 16-bit sentinel below round-trips exactly
RELEASE_NONE = np.int32(1 << 30)
_RF16 = 0xFFFF  # 16-bit release-frame field; max value = the sentinel


def horizon_dyn_cols(n_bq_extra: int = 0) -> int:
    """int32 columns per horizon slice in the compact dynamics matrix."""
    S = MAX_SEGMENTS_PER_BLOCK
    return 4 + (S + 1) // 2 + 1 + (n_bq_extra + 1) // 2


def pack_horizon_dynamics(tail, istart) -> "np.ndarray | None":
    """Compact per-slice dynamics for a lookahead horizon.

    `tail` is [(prog_i, prog_f)] for slices 1..H-1 — slice 0 ships as the
    full fused base program. Across a CLEAN horizon (no events by
    construction — engine._start_horizon preempts/rebuilds on any event)
    the per-block program builder (engine/voicestate.build_program) can
    only vary: position anchors, envelope anchors (stage0 / env0 /
    release_frame / rel_mode / rel_rate — rel_rate because a slice-0
    note_off's linear release fixes its rate at the trigger,
    voicestate.advance), wrap-segment frames, the stop frame, the active
    mask (mid-horizon voice deaths), and the derived fetch-window anchor.
    Everything else is command-driven, and commands preempt horizons.

    Each slice packs to horizon_dyn_cols() int32 columns instead of the
    full K=36 program: a full [V, H*K] stack measured 2.36 MB and ~25 ms
    of relay H2D per horizon at V=1024, H=16 (tools/tpu_probe2_r4.py) —
    the dominant live-path cost; the compact matrix is ~4.5x smaller.
    Values are EXTRACTED from the host-built per-block programs, never
    recomputed, so reconstruction (unpack_horizon_slice) is bit-exact.

    Layout: col 0 = istart (loop restart sample, the one extra static the
    reconstruction needs); then per slice h>=1: pos_int, pos_frac(bits),
    env0(bits), rel_rate(bits), (S+1)//2 cols of 16-bit pairs
    [wrap_1..wrap_{S-1}, stop_frame], one flags col
    (release_frame | active<<16 | stage0<<17 | rel_mode<<20), and
    ceil(W/2) cols of 16-bit beat-quantized reset pairs.

    Returns None when a program exceeds the encoding (a release frame
    neither in-block nor "none", a pending start past slice 0, or a
    negative position anchor) — the engine then skips this horizon and
    dispatches per-block.
    """
    S = MAX_SEGMENTS_PER_BLOCK
    npack = (S + 1) // 2
    if not tail:
        return np.asarray(istart, np.int32)[:, None].copy()
    V = tail[0][0].shape[0]
    W = tail[0][0].shape[1] - PI_BQ
    D = horizon_dyn_cols(W)
    dyn = np.empty((V, 1 + len(tail) * D), np.int32)
    dyn[:, 0] = istart
    dyn_f32 = dyn.view(np.float32)  # same-itemsize alias for bit columns
    for t, (prog_i, prog_f) in enumerate(tail):
        rf = prog_i[:, PI_RELEASE]
        if ((rf >= _RF16) & (rf != RELEASE_NONE)).any():
            return None
        if (prog_i[:, PI_START] != 0).any():
            return None
        pos_int = prog_i[:, PI_SEG_POS]
        if (pos_int < 0).any():
            return None
        # every 16-bit-packed field carries an in-block frame number; a
        # block size beyond 0xFFFF (or any out-of-range value) cannot ride
        # the compact encoding — fall back to per-block dispatch instead
        # of silently wrapping bits in the lo|hi<<16 packs below
        for pk in (prog_i[:, PI_SEG_START + 1:PI_SEG_START + S],
                   prog_i[:, PI_STOP:PI_STOP + 1],
                   prog_i[:, PI_BQ:PI_BQ + W]):
            if ((pk < 0) | (pk > _RF16)).any():
                return None
        off = 1 + t * D
        dyn[:, off] = pos_int
        dyn_f32[:, off + 1] = prog_f[:, PF_SEG_FRAC]
        dyn_f32[:, off + 2] = prog_f[:, PF_ENV0]
        dyn_f32[:, off + 3] = prog_f[:, PF_REL_RATE]
        fields = [prog_i[:, PI_SEG_START + s] for s in range(1, S)]
        fields.append(prog_i[:, PI_STOP])
        for c in range(npack):
            lo = fields[2 * c]
            hi = (fields[2 * c + 1] if 2 * c + 1 < len(fields)
                  else np.int32(0))
            dyn[:, off + 4 + c] = lo | (hi << 16)
        dyn[:, off + 4 + npack] = (
            np.minimum(rf, np.int32(_RF16))
            | (prog_i[:, PI_ACTIVE] << 16)
            | (prog_i[:, PI_STAGE0] << 17)
            | (prog_i[:, PI_RELMODE] << 20)
        )
        for c in range((W + 1) // 2):
            lo = prog_i[:, PI_BQ + 2 * c]
            hi = (prog_i[:, PI_BQ + 2 * c + 1] if 2 * c + 1 < W
                  else np.int32(0))
            dyn[:, off + 5 + npack + c] = lo | (hi << 16)
    return dyn


def pack_strips(strips) -> np.ndarray:
    """StripParams -> one [5, K] f32 array (order: dry, wet1, wet2, pan, muted)."""
    return np.stack(
        [np.asarray(f, np.float32) for f in strips], axis=0
    )


def unpack_strips(packed):
    from .mixer import StripParams

    return StripParams(
        dry=packed[0], wet1=packed[1], wet2=packed[2],
        pan=packed[3], muted=packed[4],
    )


def empty_program(num_voices: int, block_frames: int,
                  n_bq_extra: int = 0) -> VoiceProgram:
    """An all-idle program (host fills in active voices per block)."""
    V, S = num_voices, MAX_SEGMENTS_PER_BLOCK
    zi = lambda *s: np.zeros(s or (V,), np.int32)  # noqa: E731
    zf = lambda *s: np.zeros(s or (V,), np.float32)  # noqa: E731
    return VoiceProgram(
        active=zi(),
        base=zi(),
        len_minus1=np.ones(V, np.int32),
        win_blk_a=zi(),
        win_blk_b=zi(),
        seg_start=np.full((V, S), block_frames, np.int32),
        seg_pos_int=zi(V, S),
        loop_period=zi(),
        bq_reset=np.full((V, n_bq_extra), block_frames, np.int32),
        seg_pos_frac=zf(V, S),
        rate_int=zi(),
        rate_frac=zf(),
        start_frame=zi(),
        stop_frame=np.full(V, block_frames, np.int32),
        gain=zf(),
        clip_volume=zf(),
        pan=zf(),
        lane=zi(),
        env=adsr_ops.AdsrProgram(
            stage0=zi(),
            env0=zf(),
            a_rate=zf(),
            d_rate=zf(),
            sustain=zf(),
            rel_rate=zf(),
            inv_rel=zf(),
            rel_log2=zf(),
            release_frame=np.full(V, block_frames, np.int32),
            rel_mode=zi(),
        ),
    )


# --------------------------------------------------------- device half

# torch.where takes a Python scalar, not a numpy one
_RELEASE_NONE = int(RELEASE_NONE)


_F32 = torch.float32


def split_fused(fused):
    """Inverse of fuse_packed: int32 [V, Ki+Kf] -> (ints [V, Ki] int32,
    floats [V, Kf] f32 bit-cast)."""
    ki = fused.shape[1] - (len(_F32_SCALARS) + len(_F32_ENV)
                           + MAX_SEGMENTS_PER_BLOCK)
    return fused[:, :ki], fused[:, ki:].view(torch.float32)


def _pairs16(col):
    """One int32 column of two 16-bit fields -> (lo, hi); `>>` on int32 is
    the arithmetic shift, as in the reference."""
    return col & 0xFFFF, (col >> 16) & 0xFFFF


def unpack_horizon_slice(base: VoiceProgram, dyn, h: int,
                         block_frames: int) -> VoiceProgram:
    """Slice h (h >= 1) of a compact lookahead horizon: the reference's
    unpack_horizon_slice (libzl_tpu/ops/voice.py) on tensors. Dynamic
    columns are the host's own values round-tripped through
    pack_horizon_dynamics; the window anchor repeats the host's integer
    floor division on non-negative int32. Rows that die mid-horizon keep
    base statics with active=0 and render as silence."""
    S = base.seg_start.shape[1]
    W = base.bq_reset.shape[1]
    npack = (S + 1) // 2
    D = horizon_dyn_cols(W)
    off = 1 + (h - 1) * D
    istart = dyn[:, 0]
    pos_int = dyn[:, off]
    # the f32 columns are bit-casts of the int32 ones
    pos_frac, env0, rel_rate = (
        dyn[:, off + i].view(torch.float32) for i in (1, 2, 3))
    f16 = []
    for c in range(npack):
        f16.extend(_pairs16(dyn[:, off + 4 + c]))
    wraps, stop = f16[: S - 1], f16[S - 1]
    flags = dyn[:, off + 4 + npack]
    rf = flags & _RF16
    rf = torch.where(rf == _RF16, _RELEASE_NONE, rf)
    zero_i = torch.zeros_like(pos_int)
    seg_start = torch.stack([zero_i] + wraps, dim=1)
    seg_pos_int = torch.stack(
        [pos_int] + [torch.where(w < block_frames, istart, 0) for w in wraps],
        dim=1,
    )
    zf = torch.zeros_like(pos_frac)
    seg_pos_frac = torch.stack([pos_frac] + [zf] * (S - 1), dim=1)
    win_a = torch.clamp_min(
        torch.floor_divide(base.base + pos_int, WINDOW_ANCHOR_BLOCK), 0)
    if W:
        g = []
        for c in range((W + 1) // 2):
            g.extend(_pairs16(dyn[:, off + 5 + npack + c]))
        bq = torch.stack(g[:W], dim=1)
    else:
        bq = base.bq_reset
    return base._replace(
        active=(flags >> 16) & 1,
        win_blk_a=win_a,
        seg_start=seg_start,
        seg_pos_int=seg_pos_int,
        seg_pos_frac=seg_pos_frac,
        start_frame=zero_i,
        stop_frame=stop,
        bq_reset=bq,
        env=base.env._replace(
            stage0=(flags >> 17) & 7,
            release_frame=rf,
            rel_mode=(flags >> 20) & 3,
            env0=env0,
            rel_rate=rel_rate,
        ),
    )


def horizon_programs(base_fused, dyn, slices: int,
                     block_frames: int) -> list:
    """All H per-block VoicePrograms of a compact horizon: slice 0 from the
    fused base program, slices 1..H-1 rebuilt from the dynamics."""
    base, *rest = horizon_sources(base_fused, dyn, slices)
    return [base] + [src.program(block_frames) for src in rest]


class HorizonSlice(NamedTuple):
    """Slice h >= 1 of a compact horizon as a render's program source: the
    base program (slice 0's, whose statics and lanes every slice shares) and
    the compact dynamics [V, 1+(H-1)*D]. The windows path reads it straight
    into the voice prep (ops/voice_render.voice_prep_slice: on a card no
    slice program is built); the gather path unpacks it (`program`)."""

    base: VoiceProgram
    dyn: Any
    h: int

    @property
    def lane(self):
        return self.base.lane

    @property
    def pan(self):
        return self.base.pan

    def program(self, block_frames: int) -> VoiceProgram:
        return unpack_horizon_slice(self.base, self.dyn, self.h,
                                    block_frames)


def horizon_sources(base_fused, dyn, slices: int) -> list:
    """A compact horizon's H program sources: slice 0's program from the
    fused base program, then a HorizonSlice for each of slices 1..H-1."""
    base = unpack_program(*split_fused(base_fused))
    return [base] + [HorizonSlice(base, dyn, h) for h in range(1, slices)]


def _gather_taps(sound_data, safe_pos0, safe_pos1):
    """(t0l, t0r, t1l, t1r) f32 from a planar [2, N] or interleaved [N, 2]
    bank, int16 dequantized x/32767."""
    i0, i1 = safe_pos0.long(), safe_pos1.long()
    if sound_data.shape[0] == 2:
        taps = (sound_data[0, i0], sound_data[1, i0],
                sound_data[0, i1], sound_data[1, i1])
    else:
        tap0, tap1 = sound_data[i0], sound_data[i1]
        taps = (tap0[..., 0], tap0[..., 1], tap1[..., 0], tap1[..., 1])
    if sound_data.dtype == torch.int16:
        taps = tuple(t.to(_F32) * _INT16_DEQUANT for t in taps)
    return taps


def render_voices(
    sound_data,           # [2, N] planar or [N, 2] interleaved, f32|int16
    prog,                 # a VoiceProgram or a HorizonSlice
    block_frames: int,
    quirk_gain: bool = False,
    num_lanes: int = NUM_SAMPLER_CHANNELS,
    return_contrib: bool = False,
    fetch: str = "gather",
    max_pitch_ratio: float = 4.0,
):
    """Render all voices for one block: `voice_contrib`, then the in-order
    lane mixdown (ops/mixdown.lane_mixdown: the CUDA kernel for CUDA
    tensors, its plain version on the CPU).
    Returns (mix [C, B, 2] f32, voice_peak [V] f32[, contrib [V, B, 2]])."""
    voice_peak, contrib = voice_contrib(
        sound_data, prog, block_frames, quirk_gain=quirk_gain, fetch=fetch,
        max_pitch_ratio=max_pitch_ratio)
    mix = lane_mixdown(contrib, prog.lane.contiguous(), num_lanes)
    if return_contrib:
        return mix, voice_peak, contrib
    return mix, voice_peak


def voice_contrib(
    sound_data,
    prog,
    block_frames: int,
    quirk_gain: bool = False,
    fetch: str = "gather",
    max_pitch_ratio: float = 4.0,
    out=None,
):
    """Every voice's stereo contribution to one block, before the mixdown.

    fetch: "gather" (tensor indexing, plain PyTorch) or "windows[:suffix]":
    ops/voice_render.voice_prep, fetch_interp, then voice_post (three CUDA
    kernels for CUDA tensors, their plain versions on the CPU; the windows
    path needs the planar bank with the region tail guard).
    `out` ([V, B, 2] f32, contiguous) receives contrib, as one slice of a
    horizon's stacked contributions does.
    Returns (voice_peak [V] f32, contrib [V, B, 2] f32). `prog` is a
    VoiceProgram or a HorizonSlice."""
    B = block_frames
    if fetch.startswith("windows") and quirk_gain:
        # the reference-exact parity expression needs the taps separately;
        # parity testing is not a hot path — use the gather fetch
        fetch = "gather"
    if fetch.startswith("windows"):
        # the suffix only steers the TPU kernel's Mosaic schedule: validate
        # it like the reference, then ignore it
        parse_suffix(fetch.partition(":")[2])
        if isinstance(prog, HorizonSlice):
            prep = voice_prep_slice(prog.base, prog.dyn, prog.h, B,
                                    max_pitch_ratio)
        else:
            prep = voice_prep(prog, B, max_pitch_ratio)
        pos_local, alpha, g, valid, win_a, win_b = prep
        interp = fetch_interp(sound_data, pos_local, alpha, win_a, win_b,
                              r_max=max_pitch_ratio)  # [V, 2, B] planar
        return voice_post(interp, g, valid, prog.pan, out=out)

    if isinstance(prog, HorizonSlice):
        prog = prog.program(B)
    pos_int, alpha, _, g, valid = voice_fields(prog, B)
    inv_alpha = 1.0 - alpha
    # Both taps are clamped into the sound's own region; lanes where the
    # clamp changed anything are masked off by `valid`.
    lm1 = prog.len_minus1[:, None]
    base = prog.base[:, None]
    safe_pos0 = torch.minimum(torch.clamp_min(pos_int, 0), lm1) + base
    safe_pos1 = torch.minimum(torch.clamp_min(pos_int + 1, 0), lm1) + base
    t0l, t0r, t1l, t1r = _gather_taps(sound_data, safe_pos0, safe_pos1)
    if quirk_gain:
        # Reference-exact expression: gain chain on the second tap only
        # (lib/SamplerSynthVoice.cpp:204-205).
        l = t0l * inv_alpha + t1l * alpha * g
        r = t0r * inv_alpha + t1r * alpha * g
    else:
        l = (t0l * inv_alpha + t1l * alpha) * g
        r = (t0r * inv_alpha + t1r * alpha) * g
    return pan_and_peak(l, r, valid, prog.pan, out)
