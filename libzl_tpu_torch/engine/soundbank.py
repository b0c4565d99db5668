"""Device-resident sample memory (the SamplerSynthSound equivalent).

The reference keeps one decoded juce::AudioBuffer per clip
(lib/SamplerSynthSound.cpp:28-59, preferring a memory-mapped reader) and the
voice loop reads it with raw pointers. The TPU build packs every loaded sound
into ONE flat float32 array resident in HBM; each sound is a slot with a
base offset. Voices address samples as `base + position`, so the render
kernel does a single gather into one array regardless of how many sounds are
loaded — no per-sound control flow, no recompiles when sounds are added
(capacity is pre-allocated; growth doubles capacity and recompiles at most
O(log n) times).

The array is stored channel-major ("planar", shape [2, N]): on TPU the last
axis maps to the 128-lane dimension, so the fetch kernel's window DMAs and
slab slices are lane-aligned runs along the sample axis — an interleaved
[N, 2] layout would put the 2-wide channel axis on the lanes and violate
Mosaic's slice-alignment rules (and waste 126/128 of each lane fetch).

Mono sources are duplicated to stereo on load: the reference computes the
right channel of mono material from the identical expression as the left
(lib/SamplerSynthVoice.cpp:205), so duplication is exact.

A copy of libzl_tpu/engine/soundbank.py, verbatim apart from this note: the
port keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..io.wav import AudioData, to_stereo


@dataclasses.dataclass
class SoundSlot:
    """Host-side metadata for one loaded sound."""

    slot: int
    base: int           # first frame index in the flat array
    length: int         # frames
    sample_rate: float
    padded_length: int  # frames reserved (>= length + guard)


# One guard frame past the end so `pos+1` of the final valid fetch index is
# in-bounds without branching (the kernel masks `pos < length-1` anyway).
_GUARD_FRAMES = 8
# The Pallas fetch kernel DMAs whole fetch regions anchored at any allocated
# 512-row boundary; keep a tail covering the largest region so the DMA never
# runs off the array (ops/fetch_pallas.region_rows; 5120 rows at B=1024).
# Engines with larger windows blocks pass a bigger `tail_guard` (see
# region_tail_guard / AudioEngine.__init__).
_TAIL_GUARD = 6144


def region_tail_guard(block_frames: int, max_pitch_ratio: float) -> int:
    """Tail rows needed for the windows kernel's region DMAs — mirrors
    ops/fetch_pallas.region_rows without importing the pallas machinery."""
    span = int(max_pitch_ratio * block_frames) + 2
    return ((span + 511) // 512) * 512 + 512


class SoundBank:
    """Packs sounds into one planar [2, N] float32 buffer + slot table."""

    def __init__(self, capacity_frames: int = 1 << 22,
                 tail_guard: int = _TAIL_GUARD):
        self._tail_guard = max(int(tail_guard), _TAIL_GUARD)
        self._data = np.zeros((2, capacity_frames), dtype=np.float32)
        self._used = 0
        self._slots: list[SoundSlot] = []
        self._free: list[int] = []  # recycled slot ids
        self.version = 0            # bumped on every mutation

    @property
    def data(self) -> np.ndarray:
        """The planar sample array [2, capacity]; upload to device as-is."""
        return self._data

    @property
    def capacity_frames(self) -> int:
        return self._data.shape[1]

    def slot(self, slot_id: int) -> SoundSlot:
        return self._slots[slot_id]

    def _append_region(self, samples: np.ndarray) -> tuple[int, int]:
        """Append a fresh region (guard tail zeroed); returns (base, padded).
        Shared by load and replace so the guard-fill rule cannot drift."""
        length = samples.shape[0]
        padded = length + _GUARD_FRAMES
        if self._used + padded > self.capacity_frames - self._tail_guard:
            self._grow(self._used + padded + self._tail_guard)
        base = self._used
        self._data[:, base : base + length] = samples.T
        self._data[:, base + length : base + padded] = 0.0
        self._used += padded
        return base, padded

    def load(self, audio: AudioData) -> SoundSlot:
        """Add a decoded sound; returns its slot."""
        samples = to_stereo(np.asarray(audio.samples, dtype=np.float32))
        length = samples.shape[0]
        base, padded = self._append_region(samples)
        if self._free:
            slot_id = self._free.pop()
        else:
            slot_id = len(self._slots)
            self._slots.append(None)  # type: ignore[arg-type]
        s = SoundSlot(
            slot=slot_id,
            base=base,
            length=length,
            sample_rate=float(audio.sample_rate),
            padded_length=padded,
        )
        self._slots[slot_id] = s
        self.version += 1
        return s

    def replace(self, slot_id: int, audio: AudioData) -> SoundSlot:
        """Replace a slot's audio (the reference reloads on
        playbackFileChanged, lib/SamplerSynthSound.cpp:68). Reuses the region
        when the new sound fits, else appends a new region."""
        old = self._slots[slot_id]
        if old is None:
            # replacing an unloaded slot would resurrect an id still on
            # the free list — a later load() would then hand the same id
            # to a different sound. Surface the lifecycle bug.
            raise ValueError(
                f"replace() on unloaded slot {slot_id}; use load() for a "
                f"new sound"
            )
        samples = to_stereo(np.asarray(audio.samples, dtype=np.float32))
        length = samples.shape[0]
        if length + _GUARD_FRAMES <= old.padded_length:
            base, padded = old.base, old.padded_length
            self._data[:, base : base + length] = samples.T
            self._data[:, base + length : base + padded] = 0.0
        else:
            base, padded = self._append_region(samples)
        s = SoundSlot(
            slot=slot_id,
            base=base,
            length=length,
            sample_rate=float(audio.sample_rate),
            padded_length=padded,
        )
        self._slots[slot_id] = s
        self.version += 1
        return s

    def unload(self, slot_id: int) -> None:
        """Release a slot id (region is not compacted; ids are recycled).
        Idempotent: a double unload must not push the id onto the free
        list twice (two later load()s would then share one slot)."""
        if self._slots[slot_id] is None:
            return
        self._slots[slot_id] = None  # type: ignore[assignment]
        self._free.append(slot_id)
        self.version += 1

    def _grow(self, min_frames: int) -> None:
        new_cap = self.capacity_frames
        while new_cap < min_frames:
            new_cap *= 2
        # keep the flat array a multiple of the fetch-window block size
        new_cap = ((new_cap + 1023) // 1024) * 1024
        grown = np.zeros((2, new_cap), dtype=np.float32)
        grown[:, : self._used] = self._data[:, : self._used]
        self._data = grown
        self.version += 1
