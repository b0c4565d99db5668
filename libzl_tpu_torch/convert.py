"""Carry the reference's numpy state across to the port's device tensors.

The engine's "weights" are host state, the port's copy of the reference's
numpy code: the sound
bank (`engine/soundbank.SoundBank.data`, planar [2, N] f32), the packed
per-voice program (`ops/voice.pack_program` + `fuse_packed`) and the channel
strips (`ops/voice.pack_strips`). These helpers turn them into tensors on a
device, so both packages render the same thing from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.voice import pack_strips


def quantize_bank(data: np.ndarray, bank_dtype: str) -> np.ndarray:
    """int16 bank (bank_dtype="int16"): round(x * 32767), clipped — exactly
    the reference engine's rule (AudioEngine._quantize_bank)."""
    if bank_dtype == "float32":
        return data
    if bank_dtype != "int16":
        raise ValueError(f"bank_dtype must be float32|int16: {bank_dtype}")
    return np.clip(
        np.round(data * np.float32(32767.0)), -32768, 32767
    ).astype(np.int16)


def sound_bank_array(data: np.ndarray, bank_dtype: str = "float32",
                     layout: str = "planar") -> np.ndarray:
    """SoundBank.data (planar [2, N] f32) -> the contiguous host array the
    device holds: planar [2, N] (the windows fetch) or interleaved [N, 2]
    (the gather fetch: one row index reads the stereo pair), f32 or
    int16."""
    arr = quantize_bank(data, bank_dtype)
    if layout == "interleaved":
        arr = arr.T
    elif layout != "planar":
        raise ValueError(f"layout must be planar|interleaved: {layout}")
    return np.ascontiguousarray(arr)


def sound_bank_tensor(data: np.ndarray, device, bank_dtype: str = "float32",
                      layout: str = "planar") -> torch.Tensor:
    """sound_bank_array on `device`. Always a copy: the bank keeps mutating
    on the host while the device renders the last upload."""
    return torch.from_numpy(sound_bank_array(data, bank_dtype, layout)).to(
        device, copy=True)


def upload(arr, device) -> torch.Tensor:
    """A host array -> a device tensor. On CUDA the upload goes through
    pinned memory without blocking the host; on the CPU it is a copy, so
    the caller may reuse the array. A tensor (a program kept on the device
    and rendered again) goes to `device` as it is. The eager render's
    upload: a render graph stages its program through its own pinned
    buffers instead (engine/graphs.py)."""
    device = torch.device(device)
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)


def strips_tensor(strips, device) -> torch.Tensor:
    """StripParams -> one [5, K] f32 device tensor (ops/voice.pack_strips)."""
    return torch.from_numpy(pack_strips(strips)).to(device)
