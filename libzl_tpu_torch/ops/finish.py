"""Everything downstream of the lane mixdown, in one spelled-out order: the
master bus, the 11 channel strips and the block meters (a CUDA kernel and
its plain PyTorch version).

The counterpart of the tail of libzl_tpu/engine/render.py::finish_block,
which XLA fuses into the block's one program. The reference leaves the order
of its two sums to the library; the port fixes it, so the kernel and its
plain version give the same bits:

- the master bus: lane 0, then + lane 1, ..., + lane 11: one chain of f32
  adds an element;
- each lane's RMS: the squares over the block's B frames, zero-padded to
  the next power of two P, summed in a halving tree (level by level,
  element i + element i + P/2^j), divided by B (a rounded division),
  square-rooted (on the card a rounded root; PyTorch's CPU root may differ
  from it by an ulp).

Peaks are maxima, exact in any order; the strips are elementwise
(ops/mixer.apply_strips: (input * pan-and-mute scale) * amount).

Two implementations of one contract:
- `finish_plain`: plain PyTorch ops; the CPU path and the kernel's oracle
  on the card;
- the CUDA kernel csrc/finish_block.cu, launched by `finish` for CUDA
  tensors.

Both take a stacked horizon: lane_mix [H, L, B, 2] with L = 12 lanes (lane
0 global uneffected, 1 global effected, 2..11 the channels) and the packed
strips [5, L - 1] (dry, wet1, wet2, pan, muted; strip 0 acts on the master,
strip k >= 1 on lane k + 1).
"""

from __future__ import annotations

import torch

from ..constants import NUM_SAMPLER_CHANNELS
from . import launch_tally
from . import meters as meter_ops
from . import mixer as mixer_ops

FIRST_CHANNEL_LANE = 2
LANES = NUM_SAMPLER_CHANNELS  # the kernel's lane count, a constant there


def _tree_sum(x):
    """x [..., B, 2] summed over B: zero-padded to a power of two, then
    halved level by level (element i + element i + half)."""
    n = 1
    while n < x.shape[-2]:
        n *= 2
    if n > x.shape[-2]:
        x = torch.cat([x, x.new_zeros(x.shape[:-2] + (n - x.shape[-2], 2))],
                      dim=-2)
    while n > 1:
        n //= 2
        x = x[..., :n, :] + x[..., n:, :]
    return x[..., 0, :]


def finish_plain(lane_mix, strips_packed) -> tuple:
    """The finish in plain PyTorch ops. lane_mix [H, L, B, 2] f32,
    strips_packed [5, L - 1] f32 -> (strip_dry, strip_wet1, strip_wet2
    [H, L - 1, B, 2], lane_peaks [H, L, 2], lane_rms [H, L, 2],
    master_peak [H, 2]); the master is strip_dry[:, 0]."""
    B = lane_mix.shape[-2]
    master_raw = lane_mix[:, 0]
    for lane in range(1, lane_mix.shape[1]):
        master_raw = master_raw + lane_mix[:, lane]
    strip_in = torch.cat(
        [master_raw[:, None], lane_mix[:, FIRST_CHANNEL_LANE:]], dim=1)
    dry, wet1, wet2 = mixer_ops.apply_strips(
        strip_in, mixer_ops.StripParams(*strips_packed))
    squares = _tree_sum(lane_mix * lane_mix)
    # divided by a tensor: on the card PyTorch turns a division by a Python
    # number into a product with its rounded reciprocal
    lane_rms = torch.sqrt(squares / torch.full_like(squares, B))
    return (dry, wet1, wet2, meter_ops.block_peaks(lane_mix), lane_rms,
            meter_ops.block_peaks(dry[:, 0]))


def check_finish(lane_mix, strips_packed) -> tuple:
    """(H, L, B) of a finish the kernel takes: lane_mix float32 [H, L, B, 2]
    with L = 12 lanes (the engine's; the kernel is built for that count)
    and B >= 1 frames (any B: past 16384 the kernel splits each lane's tree
    across CTAs), strips_packed float32 [5, L - 1], both contiguous on
    lane_mix's device. Raises ValueError otherwise; needs no card."""
    dev = lane_mix.device
    if lane_mix.dim() != 4 or lane_mix.shape[3] != 2 \
            or lane_mix.shape[1] != LANES or lane_mix.shape[2] < 1:
        raise ValueError(f"finish: lane_mix must be [H, {LANES}, B, 2] with "
                         f"B > 0, got {tuple(lane_mix.shape)}")
    H, L, B = lane_mix.shape[:3]
    for name, t, shape in (("lane_mix", lane_mix, (H, L, B, 2)),
                           ("strips_packed", strips_packed, (5, L - 1))):
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != shape:
            raise ValueError(f"finish: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"float32 {shape} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"finish: {name} must be contiguous")
    return H, L, B


def finish(lane_mix, strips_packed) -> tuple:
    """The finish of `finish_plain`'s contract.

    CPU tensors take `finish_plain`. CUDA tensors launch the kernel
    (csrc/finish_block.cu; past 1024 frames with a second pass that folds
    the master chunks' peaks and, past 16384, combines each lane's partial
    trees) on the calling thread's current stream, or raise: a CUDA tensor
    never reaches the plain version.
    `finish.launches` counts calls from every thread, one a call: a call
    runs one kernel at B <= 1024 and two past it (the second pass)."""
    dev = lane_mix.device
    if dev.type == "cpu":
        return finish_plain(lane_mix, strips_packed)
    if dev.type != "cuda":
        raise ValueError(f"finish: unsupported device {dev}")
    from .. import _build

    H, L, B = check_finish(lane_mix, strips_packed)
    strips = torch.empty((3, H, L - 1, B, 2), dtype=torch.float32,
                         device=dev)
    meters = torch.empty((2, H, L, 2), dtype=torch.float32, device=dev)
    master_peak = torch.empty((H, 2), dtype=torch.float32, device=dev)
    lib = _build.load()
    n = lib.zl_finish_block_scratch(H, L, B)
    partial = torch.empty((n,), dtype=torch.float32, device=dev) if n else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.zl_finish_block(
            lane_mix.data_ptr(), strips_packed.data_ptr(), strips.data_ptr(),
            meters.data_ptr(), master_peak.data_ptr(),
            None if partial is None else partial.data_ptr(), H, L, B, stream)
    _build.check(lib, code, "finish_block launch")
    launch_tally.count("finish_block")
    return strips[0], strips[1], strips[2], meters[0], meters[1], master_peak


finish = launch_tally.register("finish_block", finish)
