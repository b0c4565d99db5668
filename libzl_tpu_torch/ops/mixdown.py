"""The lane mixdown of the voice render, in one fixed summation order.

The reference sums each sampler-channel lane's voices with a one-hot
[12, V] x [V, 2B] product (libzl_tpu/ops/voice.py::render_voices), left to
XLA, and psums the shards' mixes under a mesh. A library product picks its
own order, and that order changes with V, so a mesh that splits the voices
would not reproduce the unsharded engine's bits. The port fixes the order:

    per lane, a left-to-right fold in global pool voice order. The
    accumulator starts at +0.0 (or `init`) and takes one IEEE f32 add per
    voice of that lane; a voice whose lane lies outside [0, num_lanes) adds
    nothing.

Under a mesh, shard i starts from shard i-1's result (`init`), so k shards
make the same adds in the same order as one call over the pool, for any k.
An inactive voice contributes +0.0 and an accumulator that starts at +0.0 is
never -0.0, so adding the idle tail of the pool changes no bit either: a
bucketed prefix and the full pool give the same mix.

Two implementations of one contract (see csrc/lane_mixdown.cu):
- `lane_mixdown_plain`: plain PyTorch ops; the CPU path and the kernel's
  oracle on the card;
- the CUDA kernel, launched by `lane_mixdown` for CUDA tensors.
"""

from __future__ import annotations

import torch

from ..constants import NUM_SAMPLER_CHANNELS
from . import launch_tally


def _stacked(contrib, init):
    """(contrib [H, V, B, 2], init [H, L, B, 2] or None, stacked?) from the
    one-block or the horizon form."""
    stacked = contrib.dim() == 4
    if not stacked:
        if contrib.dim() != 3:
            raise ValueError(f"contrib must be [V, B, 2] or [H, V, B, 2], got "
                             f"{tuple(contrib.shape)}")
        contrib = contrib[None]
        init = None if init is None else init[None]
    return contrib, init, stacked


def lane_mixdown_plain(contrib, lane, num_lanes: int = NUM_SAMPLER_CHANNELS,
                       init=None):
    """The fold in plain PyTorch ops: [num_lanes, B, 2] (or [H, num_lanes,
    B, 2] for a stacked horizon contrib [H, V, B, 2]).

    contrib f32 [V, B, 2] or [H, V, B, 2]; lane int [V] (or [H, V], or [V]
    shared by every slice); init like the output, zeros when None. Step r
    adds each lane's voice of rank r within that lane (if it has one), so
    every step adds at most one voice a lane, and the steps run in rank
    order: the adds of the fold, vectorised over lanes and frames."""
    c, init, stacked = _stacked(contrib, init)
    H, V = c.shape[0], c.shape[1]
    lane = lane.to(device=c.device, dtype=torch.long).expand(H, V)
    lanes = torch.arange(num_lanes, device=c.device)
    onehot = lane[:, None, :] == lanes[None, :, None]          # [H, L, V]
    rank = torch.cumsum(onehot, dim=2) - 1                      # exact ints
    count = onehot.sum(dim=2)                                   # [H, L]
    steps = int(count.max()) if count.numel() else 0
    # voice of rank r in lane l of slice h, V where the lane has fewer
    order = torch.full((H, num_lanes, max(steps, 1)), V, dtype=torch.long,
                       device=c.device)
    hh, ll, vv = onehot.nonzero(as_tuple=True)
    order[hh, ll, rank[hh, ll, vv]] = vv
    padded = torch.cat([c, c.new_zeros((H, 1) + c.shape[2:])], dim=1)
    acc = (c.new_zeros((H, num_lanes) + c.shape[2:]) if init is None
           else init.clone())
    rows = torch.arange(H, device=c.device)[:, None]
    for r in range(steps):
        v = order[:, :, r]                                      # [H, L]
        has = (v < V)[..., None, None]
        acc = torch.where(has, acc + padded[rows, v], acc)
    return acc if stacked else acc[0]


def _check_cuda_args(contrib, lane, init, num_lanes: int) -> None:
    dev = contrib.device
    H, V = contrib.shape[0], contrib.shape[1]
    if contrib.dtype != torch.float32:
        raise TypeError(f"contrib dtype {contrib.dtype} is not float32")
    if contrib.shape[3] != 2:
        raise ValueError(f"contrib's last axis must be 2 channels, got "
                         f"{tuple(contrib.shape)}")
    if lane.dtype != torch.int32:
        raise TypeError(f"lane dtype {lane.dtype} is not int32")
    if tuple(lane.shape) not in ((V,), (H, V)):
        raise ValueError(f"lane shape {tuple(lane.shape)} is neither ({V},) "
                         f"nor ({H}, {V})")
    want = (H, num_lanes) + tuple(contrib.shape[2:])
    if init is not None:
        if init.dtype != torch.float32 or tuple(init.shape) != want:
            raise ValueError(f"init {init.dtype} {tuple(init.shape)}, "
                             f"expected float32 {want}")
    for name, t in (("contrib", contrib), ("lane", lane), ("init", init)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, contrib on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def lane_mixdown(contrib, lane, num_lanes: int = NUM_SAMPLER_CHANNELS,
                 init=None):
    """The lane mixdown: [num_lanes, B, 2] f32, or [H, num_lanes, B, 2] for
    a stacked [H, V, B, 2] contrib (one launch for the H slices).

    CPU tensors take `lane_mixdown_plain`. CUDA tensors launch the kernel
    (csrc/lane_mixdown.cu) on the calling thread's current stream, or
    raise: a CUDA tensor never reaches the plain version.
    `lane_mixdown.launches` counts kernel launches from every thread."""
    if contrib.device.type == "cpu":
        return lane_mixdown_plain(contrib, lane, num_lanes, init)
    return launch_kernel(contrib, lane, num_lanes, init)


def launch_kernel(contrib, lane, num_lanes: int = NUM_SAMPLER_CHANNELS,
                  init=None, vec: int = 0):
    """`lane_mixdown` of CUDA tensors: one launch of the kernel. `vec` 0
    copies the rows in the widest chunks E = 2B and contrib's address allow
    (4, 2 or 1 floats), as `lane_mixdown` does; 4, 2 or 1 forces that path
    (the tests and timings of each) and raises where they do not allow
    it."""
    if contrib.device.type != "cuda":
        raise ValueError(f"lane_mixdown: unsupported device {contrib.device}")
    from .. import _build

    c, init4, stacked = _stacked(contrib, init)
    _check_cuda_args(c, lane, init4, num_lanes)
    H, V, B = c.shape[0], c.shape[1], c.shape[2]
    out = torch.empty((H, num_lanes, B, 2), dtype=torch.float32,
                      device=c.device)
    lib = _build.load()
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.zl_lane_mixdown_as(
            c.data_ptr(), lane.data_ptr(), V if lane.dim() == 2 else 0,
            None if init4 is None else init4.data_ptr(), out.data_ptr(),
            H, V, 2 * B, num_lanes, vec, stream)
    _build.check(lib, code, f"lane_mixdown launch (vec {vec})")
    _count_launch()
    return out if stacked else out[0]


def _count_launch() -> None:
    launch_tally.count("lane_mixdown")


lane_mixdown = launch_tally.register("lane_mixdown", lane_mixdown)
