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
  `segments(mesh)` is its runs of consecutive shards on one device.
- A render is three steps (`ShardedRender`), each a function of static
  tensors, so that a render graph can capture it (engine/graphs.py):
  *contrib*, a segment's rows of the program on its device -> each shard's
  contributions (`voice_contrib`, any fetch, the windows kernel included)
  and voice peaks; *fold*, the segment's shards' lane mixdowns; *tail*,
  `finish_block` once on the first device, the voice peaks concatenated in
  voice order and padded to the pool.
- The lane mix is a carried fold (ops/mixdown.py): shard 0's mixdown starts
  from zeros, and each later shard's starts from the previous shard's
  [12, B, 2] result (a horizon: [H, 12, B, 2], one launch for its H
  slices), copied to its device. Every segment's contributions are
  enqueued first, so the devices render in parallel and wait only at the
  folds; PyTorch's cross-device copy waits for both devices' current
  streams, so each fold sees every earlier shard's adds. The k shards then
  make the adds of one unsharded mixdown in the same order: the mesh is
  bit-equal to the unsharded engine for any k, repeated devices and cards
  alike. It is not torch.distributed or NCCL: their order is theirs.
- The engine dispatches every render through `ShardedRender`: eagerly
  through `render_block_sharded` / `render_horizon_sharded` (the steps
  chained over segments(mesh)), or as replays of the graphs captured from
  the same steps, which launch the same kernels in the same order. Its
  default mesh is its one device: one shard, nothing copied or
  concatenated, so the launches are those of the render alone.

The reference's `make_sharded_render` / `make_sharded_packed_render` (a
jit with `in_shardings`, left to XLA's partitioner) have no counterpart:
eager PyTorch has no partitioner, and the engine dispatches the shard_map
forms, which these two functions port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import convert
from ..constants import DEFAULT_BLOCK_FRAMES
from ..device import on_device, resolve_device
from ..engine import render as render_mod
from ..ops import voice as voice_ops
from ..ops.mixdown import lane_mixdown


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


def segments(mesh: Mesh) -> list:
    """The mesh's maximal runs of consecutive shards on one device, in mesh
    order: [(device, first_shard, n_shards)]. ["cuda:0"] * 4 is one
    segment, four cards are four, [cuda:0, cuda:0, cuda:1, cuda:1] two."""
    plan = []
    for i, dev in enumerate(mesh.devices):
        if plan and plan[-1][0] == dev:
            plan[-1] = (dev, plan[-1][1], plan[-1][2] + 1)
        else:
            plan.append((dev, i, 1))
    return plan


def _shard_rows(mesh: Mesh, rows: int) -> int:
    if rows % mesh.size:
        raise ValueError(
            f"{rows} program rows do not split evenly over the "
            f"{mesh.size}-device mesh")
    return rows // mesh.size


def _join(parts: list, dim: int):
    """Per-shard (or per-segment) tensors of one device joined in shard
    order (one part: as it is, no copy)."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def _carry(t, dev: torch.device):
    """A tensor of the shards before, on `dev` (None stays None; no copy on
    the same device). The copy is ordered after the source device's current
    stream, so it holds every add of the shards before."""
    return None if t is None else t.to(dev, non_blocking=True)


@dataclasses.dataclass(frozen=True)
class ShardedRender:
    """One render over the mesh, a block (`slices` 0) or a horizon of
    `slices` blocks (one-buffer layout, `base_cols` base program columns),
    split into three steps on static tensors, so that a render graph can
    capture each (engine/graphs.py):

    - `contrib(seg, rows)`: on the segment's device, its rows of the
      program -> each shard's (contributions, lanes) and the segment's
      voice peaks in voice order;
    - `fold(seg, parts, init)`: the segment's shards' lane mixdowns in
      shard order, the first from `init` (None: zeros);
    - `tail(mix, peaks, rows)`: on the mesh's first device, the lane mix
      carried over every shard and the segments' peaks -> finish_block
      (one call, a horizon's slices stacked), the voice peaks padded to
      the pool.

    Calling it is the eager render (render_block_sharded /
    render_horizon_sharded): `chain` of those steps over segments(mesh)."""

    mesh: Mesh
    sound_by_device: dict
    strips_packed: torch.Tensor
    block_frames: int = DEFAULT_BLOCK_FRAMES
    quirk_gain: bool = False
    fetch: str = "gather"
    max_pitch_ratio: float = 4.0
    pad_voices_to: int = 0
    slices: int = 0
    base_cols: int = 0

    def __call__(self, prog):
        """The eager render of `prog` (the host's program, or a device
        tensor), through this module's entry points."""
        kw = dict(block_frames=self.block_frames, quirk_gain=self.quirk_gain,
                  fetch=self.fetch, max_pitch_ratio=self.max_pitch_ratio,
                  pad_voices_to=self.pad_voices_to)
        if self.slices:
            return render_horizon_sharded(
                self.mesh, self.sound_by_device, prog, self.strips_packed,
                slices=self.slices, base_cols=self.base_cols, **kw)
        return render_block_sharded(
            self.mesh, self.sound_by_device, prog, self.strips_packed, **kw)

    def contrib(self, seg: tuple, rows) -> tuple:
        dev, _, n = seg
        s, B, H = rows.shape[0] // n, self.block_frames, self.slices
        kw = dict(quirk_gain=self.quirk_gain, fetch=self.fetch,
                  max_pitch_ratio=self.max_pitch_ratio)
        sound = self.sound_by_device[dev]
        parts, peaks = [], []
        with on_device(dev):
            rows = convert.upload(rows, dev)
            for i in range(n):
                shard = rows[i * s:(i + 1) * s]
                if not H:
                    prog = voice_ops.unpack_program(
                        *voice_ops.split_fused(shard))
                    vp, contrib = voice_ops.voice_contrib(sound, prog, B,
                                                          **kw)
                    parts.append((contrib, prog.lane.contiguous()))
                    peaks.append(vp)
                    continue
                # slices 1..H-1 straight from the dynamics (the windows
                # path's voice prep unpacks them in its kernel on a card)
                progs = voice_ops.horizon_sources(
                    shard[:, :self.base_cols], shard[:, self.base_cols:], H)
                contrib = torch.empty((H, s, B, 2), dtype=torch.float32,
                                      device=dev)
                vps = [voice_ops.voice_contrib(sound, prog, B, out=contrib[h],
                                               **kw)[0]
                       for h, prog in enumerate(progs)]
                # a horizon's slices share the base program's lanes
                parts.append((contrib, progs[0].lane.contiguous()))
                # one shard in all: the slices' peaks as they are
                peaks.append(vps if self.mesh.size == 1 else torch.stack(vps))
            return parts, _join(peaks, 1 if H else 0)

    def fold(self, seg: tuple, parts: list, init):
        mix = init
        with on_device(seg[0]):
            for contrib, lane in parts:
                mix = lane_mixdown(contrib, lane, init=mix)
        return mix

    def tail(self, mix, peaks: list, rows: int):
        with on_device(self.mesh.devices[0]):
            # one finish call a render: a horizon's [H, 12, B, 2] mix
            # finishes its H slices at once
            outs = render_mod.finish_block(
                mix, self.strips_packed,
                _join(peaks, 1 if self.slices else 0))
        return render_mod.pad_voice_peaks(outs, self.pad_voices_to, rows)

    def chain(self, plan: list, rows: list):
        """The three steps over `plan` (segments(mesh), or any split of the
        shards into runs on one device), `rows` each segment's rows of the
        program: every segment's contributions first, so the devices render
        in parallel, then the folds in mesh order, each from the mix carried
        from the segment before, then the tail."""
        done = [self.contrib(seg, r) for seg, r in zip(plan, rows)]
        mix = None
        for seg, (parts, _) in zip(plan, done):
            mix = self.fold(seg, parts, _carry(mix, seg[0]))
        dev0 = self.mesh.devices[0]
        peaks = [p if isinstance(p, list) else _carry(p, dev0)
                 for _, p in done]
        return self.tail(_carry(mix, dev0), peaks,
                         sum(r.shape[0] for r in rows))


def _eager(render: ShardedRender, prog):
    plan = segments(render.mesh)
    s = _shard_rows(render.mesh, prog.shape[0])
    return render.chain(plan, [prog[a * s:(a + n) * s] for _, a, n in plan])


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
    land. Each shard renders its voices' contributions, then folds them
    into the lane mix carried from the shard before (one mixdown launch a
    shard): ShardedRender's steps, chained."""
    return _eager(ShardedRender(
        mesh, sound_by_device, strips_packed, block_frames, quirk_gain,
        fetch, max_pitch_ratio, pad_voices_to), prog_fused)


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
    shard renders its H slices (slice 0 from the base program, the rest
    from ops/voice.HorizonSlice sources: on a card the voice prep kernel
    reads them from the dynamics), each slice's contributions into one
    stacked [H, V/k, B, 2] buffer, and folds them with one mixdown launch into the [H, 12, B, 2]
    lane mixes carried from the shard before (the counterpart of the
    reference's one stacked psum). Each slice is the per-block math on its
    own program, as in render_horizon_onebuf."""
    return _eager(ShardedRender(
        mesh, sound_by_device, strips_packed, block_frames, quirk_gain,
        fetch, max_pitch_ratio, pad_voices_to, slices, base_cols), hz_fused)
