"""The voice render's body around the windows fetch: voice prep and voice
post, each a CUDA kernel with its plain PyTorch version beside it.

The reference renders a block as one XLA program (libzl_tpu/ops/voice.py::
render_voices): positions, closed-form ADSR, masks, the windows fetch, gain,
M/S pan and peaks fuse there. The port's windows path is three launches:

    voice_prep   program -> pos_local, alpha (the fetch's inputs), g, valid,
                 the window anchors win_a, win_b
    fetch_interp pos_local, alpha, win_a, win_b -> interpolated taps
                 [V, 2, B] (ops/fetch_windows.py, csrc/fetch_interp.cu)
    voice_post   taps, g, valid, pan -> contributions [V, B, 2], peaks [V]

The voice prep reads a block's program (`voice_prep`) or slice h >= 1 of a
compact lookahead horizon straight from the base program and the compact
dynamics (`voice_prep_slice`: the reference's unpack_horizon_slice folded
into the prep, so no slice program is built on the card).

Two implementations of each contract:
- `voice_prep_plain`, `voice_prep_slice_plain`, `voice_post_plain`: plain
  PyTorch ops, the reference's formulas in its f32 order (the code
  ops/voice.py ran before the kernels); the CPU path, and each kernel's
  oracle on the card;
- the CUDA kernels csrc/voice_prep.cu and csrc/voice_post.cu, launched by
  `voice_prep`, `voice_prep_slice` and `voice_post` for CUDA tensors. They
  round every product, sum and quotient on its own (no contraction into
  FMAs), so they are bit-equal to the plain versions on the card.

`voice_fields` (positions, envelope, gain and the valid mask) and
`pan_and_peak` serve the gather fetch too (ops/voice.voice_contrib), which
stays plain PyTorch: it is an explicit option for parity, not the engine's
path on a card.
"""

from __future__ import annotations

import ctypes

import torch

from . import adsr as adsr_ops
from . import launch_tally
from .fetch_windows import R_MAX, SOUND_BLOCK, region_rows

_F32 = torch.float32
_I32 = torch.int32

# the program columns voice_prep reads, in the order of csrc/voice_prep.cu's
# `Col` enum; the last four are [V, S] or [V, W] blocks of columns
PREP_COLUMNS = (
    "active", "base", "len_minus1", "win_blk_a", "win_blk_b", "rate_int",
    "rate_frac", "start_frame", "stop_frame", "gain", "clip_volume",
    "loop_period", "env.stage0", "env.release_frame", "env.rel_mode",
    "env.env0", "env.a_rate", "env.d_rate", "env.sustain", "env.rel_rate",
    "env.inv_rel", "env.rel_log2", "seg_start", "seg_pos_int",
    "seg_pos_frac", "bq_reset",
)
_FLOAT_COLUMNS = {"rate_frac", "gain", "clip_volume", "env.env0",
                  "env.a_rate", "env.d_rate", "env.sustain", "env.rel_rate",
                  "env.inv_rel", "env.rel_log2", "seg_pos_frac"}
MAX_SEGMENTS = 8      # csrc/voice_prep.cu's bound on S


class PrepColumns(ctypes.Structure):
    """csrc/voice_prep.cu's `PrepColumns`: each column's address and row
    stride in elements (a column block's own columns are adjacent)."""

    _fields_ = [("ptr", ctypes.c_void_p * len(PREP_COLUMNS)),
                ("stride", ctypes.c_int64 * len(PREP_COLUMNS))]


def _column(prog, name: str):
    obj = prog
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


# ------------------------------------------------------------ plain versions


def positions_block(prog, block_frames: int):
    """Per-frame sample positions. Returns (pos_int [V,B] i32, alpha [V,B]
    f32, seg_idx [V,B] i32)."""
    k = torch.arange(block_frames, dtype=_I32,
                     device=prog.seg_start.device)[None, :]
    # segment index: count of segments whose start <= k, minus one
    seg_started = prog.seg_start[:, :, None] <= k[:, None, :]
    seg_idx = torch.clamp_min(seg_started.sum(dim=1, dtype=_I32) - 1, 0)
    # select the segment fields with masked sums over the (tiny, static) S
    # axis, as the reference does
    S = prog.seg_start.shape[1]
    m = seg_idx == 0
    s_start = prog.seg_start[:, 0:1] * m
    s_int = prog.seg_pos_int[:, 0:1] * m
    s_frac = prog.seg_pos_frac[:, 0:1] * m.to(_F32)
    for s in range(1, S):
        m = seg_idx == s
        s_start = s_start + prog.seg_start[:, s: s + 1] * m
        s_int = s_int + prog.seg_pos_int[:, s: s + 1] * m
        s_frac = s_frac + prog.seg_pos_frac[:, s: s + 1] * m.to(_F32)
    j = k - s_start  # frames into segment (>= 0 for frames >= start_frame)
    jc = torch.clamp_min(j, 0)
    # positional-loop containment past the segment horizon: wrap segments
    # repeat every loop_period frames, so j mod period is exact
    per = prog.loop_period[:, None]
    wrapseg = (seg_idx >= 1) & (per > 0)
    jc = torch.where(wrapseg, jc % torch.clamp_min(per, 1), jc)
    # beat-quantized containment: integer reset frames, applied in order
    # (later columns overwrite earlier ones)
    for e in range(prog.bq_reset.shape[1]):
        r_e = prog.bq_reset[:, e: e + 1]             # [V, 1], == B if unused
        jc = torch.where(k >= r_e, k - r_e, jc)
    frac_full = s_frac + jc.to(_F32) * prog.rate_frac[:, None]
    carry = torch.floor(frac_full)
    pos_int = s_int + jc * prog.rate_int[:, None] + carry.to(_I32)
    alpha = (frac_full - carry).to(_F32)
    return pos_int.to(_I32), alpha, seg_idx


def voice_fields(prog, block_frames: int) -> tuple:
    """Everything of a voice and frame before the fetch: (pos_int, alpha,
    seg_idx, g, valid), [V, B] each. g = gain * envelope * clip volume;
    valid: the voice renders the frame and its position lies in the sound
    (the reference's bounds rule)."""
    B = block_frames
    k = torch.arange(B, dtype=_I32, device=prog.seg_start.device)[None, :]
    pos_int, alpha, seg_idx = positions_block(prog, B)
    env = adsr_ops.envelope_block(
        prog.env, B, start_frame=prog.start_frame
    )  # [V, B], voice-local frame origin

    renders = (
        (prog.active[:, None] > 0)
        & (k >= prog.start_frame[:, None])
        & (k < prog.stop_frame[:, None])
    )
    # reference bounds rule: fetch only when sampleDuration > pos
    # (lib/SamplerSynthVoice.cpp:204); otherwise the frame contributes 0.
    valid = renders & (pos_int >= 0) & (pos_int < prog.len_minus1[:, None])

    g = (prog.gain[:, None] * env * prog.clip_volume[:, None]).to(_F32)
    return pos_int, alpha, seg_idx, g, valid


def voice_prep_plain(prog, block_frames: int, max_pitch_ratio: float = R_MAX):
    """The voice prep in plain PyTorch: (pos_local [V,B] i32, alpha [V,B]
    f32, g [V,B] f32, valid [V,B] bool, win_a [V] i32, win_b [V] i32).
    pos_local is the window-relative address fetch_interp takes: segment 0
    in region A ([0, region)), wrap segments in region B (offset by
    region); win_a and win_b are the program's window anchors, contiguous
    (the fetch's other inputs)."""
    B = block_frames
    pos_int, alpha, seg_idx, g, valid = voice_fields(prog, B)
    region = region_rows(B, max_pitch_ratio)
    in_a = seg_idx == 0
    anchor = torch.where(in_a, prog.win_blk_a[:, None],
                         prog.win_blk_b[:, None])
    pos_local = (
        pos_int
        + prog.base[:, None]
        - anchor * SOUND_BLOCK
        + torch.where(in_a, 0, region)
    ).to(_I32)
    return (pos_local, alpha, g, valid, prog.win_blk_a.contiguous(),
            prog.win_blk_b.contiguous())


def voice_prep_slice_plain(base, dyn, h: int, block_frames: int,
                           max_pitch_ratio: float = R_MAX):
    """The voice prep of slice h >= 1 of a compact horizon in plain
    PyTorch: ops/voice.unpack_horizon_slice(base, dyn, h), then
    voice_prep_plain. base: slice 0's program; dyn: the compact dynamics
    [V, 1+(H-1)*D] int32 (ops/voice.pack_horizon_dynamics)."""
    from .voice import unpack_horizon_slice  # ops/voice imports this module

    return voice_prep_plain(
        unpack_horizon_slice(base, dyn, h, block_frames), block_frames,
        max_pitch_ratio)


def pan_and_peak(l, r, valid, pan, out=None) -> tuple:
    """Masked stereo [V, B] -> (voice_peak [V], contrib [V, B, 2]): the
    valid mask as a select, the M/S pan and the peak max(l + r), floored
    at 0. `out` ([V, B, 2] f32, contiguous) receives contrib."""
    l = torch.where(valid, l, 0.0)
    r = torch.where(valid, r, 0.0)

    # M/S panning (lib/SamplerSynthVoice.cpp:207-211)
    pan = pan[:, None]
    l_pan = 0.5 * (1.0 + pan)
    r_pan = 0.5 * (1.0 - pan)
    m_sig = 0.5 * (l + r)
    s_sig = l - r
    l = l_pan * m_sig + s_sig
    r = r_pan * m_sig - s_sig

    # per-voice peak: max of (l + r), floored at 0
    # (lib/SamplerSynthVoice.cpp:213)
    voice_peak = torch.clamp_min(torch.amax(l + r, dim=1), 0.0)

    contrib = torch.stack([l, r], dim=-1, out=out)  # [V, B, 2]
    return voice_peak, contrib


def voice_post_plain(interp, g, valid, pan, out=None) -> tuple:
    """The voice post in plain PyTorch: interp [V, 2, B] f32 (pre-gain
    taps), g [V, B] f32, valid [V, B] bool, pan [V] f32 ->
    (voice_peak [V] f32, contrib [V, B, 2] f32)."""
    l = interp[:, 0, :] * g
    r = interp[:, 1, :] * g
    return pan_and_peak(l, r, valid, pan, out)


# ----------------------------------------------------------------- wrappers


def prep_columns(prog) -> tuple:
    """The program's columns as csrc/voice_prep.cu takes them: (PrepColumns,
    S, W), each column checked for its dtype, shape, device (the `active`
    column's) and layout (a column block's columns adjacent; any row
    stride). Any number W of beat-quantized resets; 1..MAX_SEGMENTS
    segments. Raises ValueError on what the kernel does not take; needs no
    card."""
    dev = prog.active.device
    V = prog.active.shape[0]
    S, W = prog.seg_start.shape[1], prog.bq_reset.shape[1]
    if not 0 < S <= MAX_SEGMENTS:
        raise ValueError(f"voice_prep: {S} segments; the kernel takes "
                         f"1..{MAX_SEGMENTS}")
    cols = PrepColumns()
    for i, name in enumerate(PREP_COLUMNS):
        t = _column(prog, name)
        dtype = _F32 if name in _FLOAT_COLUMNS else _I32
        width = {"seg_start": S, "seg_pos_int": S, "seg_pos_frac": S,
                 "bq_reset": W}.get(name)
        want = (V,) if width is None else (V, width)
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != want:
            raise ValueError(f"voice_prep: column {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{dtype} {want} on {dev}")
        if width is not None and width > 1 and t.stride(1) != 1:
            raise ValueError(f"voice_prep: column block {name} is not "
                             f"adjacent (stride {t.stride()})")
        cols.ptr[i] = t.data_ptr()
        cols.stride[i] = t.stride(0)
    return cols, S, W


def slice_offset(base, dyn, h: int) -> int:
    """Where slice h's words start in a row of the compact dynamics `dyn`
    (1 + (h-1) * D, D = ops/voice.horizon_dyn_cols(W)), after checking
    `dyn`: int32 [V, >= 1 + h*D] on the base program's device, its words
    adjacent in a row. Raises ValueError on what the kernel does not take;
    needs no card."""
    from .voice import horizon_dyn_cols  # ops/voice imports this module

    V, W = base.active.shape[0], base.bq_reset.shape[1]
    D = horizon_dyn_cols(W)
    off = 1 + (h - 1) * D
    if h < 1 or dyn.dim() != 2 or dyn.dtype != _I32 \
            or dyn.device != base.active.device or dyn.shape[0] != V \
            or dyn.shape[1] < off + D or dyn.stride(1) != 1:
        raise ValueError(f"voice_prep_slice: slice {h} of dynamics "
                         f"{dyn.dtype} {tuple(dyn.shape)} (strides "
                         f"{dyn.stride()}) on {dyn.device}; expected h >= 1 "
                         f"and int32 [{V}, >= {off + D}] with adjacent "
                         f"words on {base.active.device}")
    return off


def _device(t, what: str):
    """The device a wrapper runs on: None for the CPU (the plain version),
    a CUDA device; raises for any other."""
    if t.device.type == "cpu":
        return None
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device


def _launch_prep(dev, entry: str, args: tuple, V: int, B: int,
                 max_pitch_ratio: float) -> tuple:
    """Launch one of the voice prep's C entry points, `args` before its
    outputs; returns the outputs."""
    from .. import _build

    out = (torch.empty((V, B), dtype=_I32, device=dev),
           torch.empty((V, B), dtype=_F32, device=dev),
           torch.empty((V, B), dtype=_F32, device=dev),
           torch.empty((V, B), dtype=torch.bool, device=dev),
           torch.empty((V,), dtype=_I32, device=dev),
           torch.empty((V,), dtype=_I32, device=dev))
    if V * B == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, entry)(*args, *(t.data_ptr() for t in out), V,
                                   B, region_rows(B, max_pitch_ratio),
                                   stream)
    _build.check(lib, code, "voice_prep launch")
    launch_tally.count("voice_prep")
    return out


def voice_prep(prog, block_frames: int, max_pitch_ratio: float = R_MAX):
    """The voice prep of a block's program: (pos_local, alpha, g, valid)
    [V, B] each and the window anchors (win_a, win_b) [V].

    A program on the CPU takes `voice_prep_plain`. On a card it launches
    the kernel (csrc/voice_prep.cu) on the calling thread's current stream,
    or raises: a CUDA tensor never reaches the plain version. The columns
    may be strided views (a block's fused program) or tensors of their own;
    a column block's columns must be adjacent. `voice_prep.launches` counts
    kernel launches from every thread (of this and `voice_prep_slice`)."""
    dev = _device(prog.active, "voice_prep")
    if dev is None:
        return voice_prep_plain(prog, block_frames, max_pitch_ratio)
    cols, S, W = prep_columns(prog)
    return _launch_prep(dev, "zl_voice_prep", (ctypes.byref(cols), S, W),
                        prog.active.shape[0], block_frames, max_pitch_ratio)


def voice_prep_slice(base, dyn, h: int, block_frames: int,
                     max_pitch_ratio: float = R_MAX):
    """The voice prep of slice h >= 1 of a compact horizon, straight from
    the base program (slice 0's, whose statics every slice shares) and the
    compact dynamics `dyn` ([V, 1+(H-1)*D] int32, any row stride): the
    outputs of `voice_prep` on ops/voice.unpack_horizon_slice(base, dyn, h).

    On the CPU `voice_prep_slice_plain`; on a card the voice prep kernel
    with the slice as its column source (no slice program is built), or a
    ValueError. Counts in `voice_prep.launches`."""
    dev = _device(base.active, "voice_prep_slice")
    if dev is None:
        return voice_prep_slice_plain(base, dyn, h, block_frames,
                                      max_pitch_ratio)
    cols, S, W = prep_columns(base)
    off = slice_offset(base, dyn, h)
    return _launch_prep(
        dev, "zl_voice_prep_slice",
        (ctypes.byref(cols), dyn.data_ptr(), dyn.stride(0), off, S, W),
        base.active.shape[0], block_frames, max_pitch_ratio)


def voice_post(interp, g, valid, pan, out=None) -> tuple:
    """The voice post: (voice_peak [V] f32, contrib [V, B, 2] f32), contrib
    written into `out` ([V, B, 2] f32, contiguous) when given.

    CPU tensors take `voice_post_plain`. CUDA tensors launch the kernel
    (csrc/voice_post.cu) on the calling thread's current stream, or raise.
    `pan` may be a strided column. `voice_post.launches` counts kernel
    launches from every thread."""
    dev = _device(interp, "voice_post")
    if dev is None:
        return voice_post_plain(interp, g, valid, pan, out)
    from .. import _build

    if interp.dim() != 3 or interp.shape[1] != 2:
        raise ValueError(f"voice_post: interp must be [V, 2, B], got "
                         f"{tuple(interp.shape)}")
    V, B = interp.shape[0], interp.shape[2]
    want = (
        ("interp", interp, _F32, (V, 2, B)), ("g", g, _F32, (V, B)),
        ("valid", valid, torch.bool, (V, B)), ("pan", pan, _F32, (V,)),
    ) + ((("out", out, _F32, (V, B, 2)),) if out is not None else ())
    for name, t, dtype, shape in want:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"voice_post: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{dtype} {shape} on {dev}")
        if name != "pan" and not t.is_contiguous():
            raise ValueError(f"voice_post: {name} must be contiguous")
    if out is None:
        out = torch.empty((V, B, 2), dtype=_F32, device=dev)
    if out.data_ptr() % 8:
        raise ValueError("voice_post: out must be 8-byte aligned")
    peak = torch.empty((V,), dtype=_F32, device=dev)
    if V * B == 0:
        return peak.zero_(), out
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.zl_voice_post(
            interp.data_ptr(), g.data_ptr(), valid.data_ptr(), pan.data_ptr(),
            pan.stride(0), out.data_ptr(), peak.data_ptr(), V, B, stream)
    _build.check(lib, code, "voice_post launch")
    launch_tally.count("voice_post")
    return peak, out


voice_prep = launch_tally.register("voice_prep", voice_prep)
voice_post = launch_tally.register("voice_post", voice_post)
