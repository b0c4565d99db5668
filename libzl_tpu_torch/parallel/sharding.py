"""Voice sharding over a device mesh (counterpart of
libzl_tpu/parallel/sharding.py).

The reference shards the voice axis of the render over a jax Mesh with
shard_map: every device renders its V/n voices (the windows kernel per
shard), the additive lane mixdown is a psum, and the strip and meter tail
runs replicated. The port keeps the reference's single-controller design:
one process drives every device of the mesh, as one `AudioEngine(mesh=...)`
in the reference does (the C ABI's one runtime, examples/multichip_demo.py).

- A `Mesh` is an ordered tuple of torch devices of one type. A device may
  repeat: `make_mesh(devices=["cuda:0"] * 4)` splits the pool into four
  shards on one card, and `["cpu"] * 4` does the same on the CPU.
- Each shard's contiguous block of program rows is uploaded to its device
  and rendered there by `render_voices`, any fetch (the windows kernel
  included), inside `torch.cuda.device(d)`, on that device's current stream.
- The shards' lane mixes [12, B, 2] (a horizon: [H, 12, B, 2], one stacked
  reduction for its H slices) are copied to the first device and summed in
  shard order there; PyTorch's cross-device copy waits for the source
  device's current stream, so the sum sees every shard's render. The
  reduction is not torch.distributed or NCCL: their order is not the shard
  order. `finish_block` then runs once on the first device, and the voice
  peaks are concatenated in voice order and padded to the pool.
- The engine dispatches every render through these two functions. Its
  default mesh is its one device: one shard, nothing reduced, stacked or
  concatenated, so the launches are those of the render alone.

The reference's `make_sharded_render` / `make_sharded_packed_render` (a
jit with `in_shardings`, left to XLA's partitioner) have no counterpart:
eager PyTorch has no partitioner, and the engine dispatches the shard_map
forms, which these two functions port.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from .. import convert
from ..constants import DEFAULT_BLOCK_FRAMES
from ..device import resolve_device
from ..engine import render as render_mod
from ..ops import voice as voice_ops


def canonical_device(device) -> torch.device:
    """A torch.device with its index: "cuda" is the current CUDA device
    (the same card the engine's own "cuda" resolves to)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ordered devices the voice axis shards over (repeats allowed)."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> list:
        """The mesh's devices, each once, in mesh order."""
        return list(dict.fromkeys(self.devices))


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A mesh over `devices` (default: every visible CUDA device), cut to
    the first `n_devices`. Never picks the CPU by itself: without a card and
    without `devices`, or with fewer devices than `n_devices`, it raises.
    All devices are of one type."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise ValueError(
                "make_mesh: no CUDA device is visible; pass devices= "
                "explicitly (e.g. ['cpu'] * 4)")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"make_mesh: asked for {n_devices} devices, only "
                f"{len(devices)} available")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh: a mesh needs at least one device")
    types = {d.type for d in devices}
    if len(types) > 1:
        raise ValueError(f"make_mesh: mixed device types {sorted(types)}")
    return Mesh(tuple(canonical_device(d) for d in devices))


def _on(device: torch.device):
    """`device` as the calling thread's current device (a no-op on the
    CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _shard_rows(mesh: Mesh, rows: int) -> int:
    if rows % mesh.size:
        raise ValueError(
            f"{rows} program rows do not split evenly over the "
            f"{mesh.size}-device mesh")
    return rows // mesh.size


def _reduce(mesh: Mesh, parts: list) -> torch.Tensor:
    """Sum per-shard tensors on the mesh's first device, in shard order (one
    shard: its part as it is)."""
    dev0 = mesh.devices[0]
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev0, non_blocking=True)
    return total


def _concat(mesh: Mesh, parts: list, dim: int = 0) -> torch.Tensor:
    """Concatenate per-shard tensors on the mesh's first device, in shard
    order (one shard: its part as it is, no copy)."""
    if len(parts) == 1:
        return parts[0]
    dev0 = mesh.devices[0]
    return torch.cat([p.to(dev0, non_blocking=True) for p in parts], dim=dim)


def render_block_sharded(
    mesh: Mesh,
    sound_by_device: dict,
    prog_fused,
    strips_packed,
    block_frames: int = DEFAULT_BLOCK_FRAMES,
    quirk_gain: bool = False,
    fetch: str = "gather",
    max_pitch_ratio: float = 4.0,
    pad_voices_to: int = 0,
) -> render_mod.RenderOutputs:
    """One block over the mesh (make_shardmap_packed_render's
    counterpart). `prog_fused` is the host's fused program (numpy int32
    [V, K], ops/voice.fuse_packed) whose V rows split into mesh.size
    contiguous blocks; `sound_by_device` maps each mesh device to its copy
    of the bank; `strips_packed` lies on mesh.devices[0], where the outputs
    land."""
    s = _shard_rows(mesh, prog_fused.shape[0])
    mixes, peaks = [], []
    for i, dev in enumerate(mesh.devices):
        with _on(dev):
            fused = convert.upload(prog_fused[i * s:(i + 1) * s], dev)
            prog = voice_ops.unpack_program(*voice_ops.split_fused(fused))
            lane_mix, voice_peaks = voice_ops.render_voices(
                sound_by_device[dev], prog, block_frames,
                quirk_gain=quirk_gain, fetch=fetch,
                max_pitch_ratio=max_pitch_ratio,
            )
        mixes.append(lane_mix)
        peaks.append(voice_peaks)
    dev0 = mesh.devices[0]
    with _on(dev0):
        out = render_mod.finish_block(
            _reduce(mesh, mixes), voice_ops.unpack_strips(strips_packed),
            _concat(mesh, peaks))
    return render_mod.pad_voice_peaks(out, pad_voices_to,
                                      prog_fused.shape[0])


def render_horizon_sharded(
    mesh: Mesh,
    sound_by_device: dict,
    hz_fused,
    strips_packed,
    block_frames: int,
    slices: int,
    base_cols: int,
    quirk_gain: bool = False,
    fetch: str = "gather",
    max_pitch_ratio: float = 4.0,
    pad_voices_to: int = 0,
) -> tuple:
    """A lookahead horizon over the mesh (make_shardmap_horizon_render's
    counterpart, one-buffer layout): `hz_fused` is the host's base program
    and compact dynamics in one int32 [V, base_cols + 1+(H-1)*D] array; each
    shard uploads its rows and rebuilds its H slices' programs
    (ops/voice.horizon_programs); the H slices' lane mixes ride one stacked
    [H, 12, B, 2] reduction. Each slice is the per-block math on its own
    program, as in render_horizon_onebuf."""
    s = _shard_rows(mesh, hz_fused.shape[0])
    mixes, peaks = [], []
    for i, dev in enumerate(mesh.devices):
        with _on(dev):
            hz = convert.upload(hz_fused[i * s:(i + 1) * s], dev)
            progs = voice_ops.horizon_programs(
                hz[:, :base_cols], hz[:, base_cols:], slices, block_frames)
            lms, vps = [], []
            for prog in progs:
                lm, vp = voice_ops.render_voices(
                    sound_by_device[dev], prog, block_frames,
                    quirk_gain=quirk_gain, fetch=fetch,
                    max_pitch_ratio=max_pitch_ratio,
                )
                lms.append(lm)
                vps.append(vp)
        mixes.append(lms)
        peaks.append(vps)
    dev0 = mesh.devices[0]
    with _on(dev0):
        strips = voice_ops.unpack_strips(strips_packed)
        if mesh.size == 1:  # the slices as they are: nothing to reduce
            lane_mixes, voice_peaks = mixes[0], peaks[0]
        else:
            lane_mixes = _reduce(mesh, [torch.stack(m) for m in mixes])
            voice_peaks = _concat(mesh, [torch.stack(p) for p in peaks], 1)
        outs = tuple(
            render_mod.finish_block(lane_mixes[h], strips, voice_peaks[h])
            for h in range(slices)
        )
    return render_mod.pad_voice_peaks(outs, pad_voices_to,
                                      hz_fused.shape[0])
