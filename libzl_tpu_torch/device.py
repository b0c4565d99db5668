"""Device selection for the port: explicit, never a silent fallback."""

from __future__ import annotations

import contextlib
import os
import re

import torch

BACKEND_ENV = "LIBZL_TPU_BACKEND"


def device_from_env(default: str = "cuda") -> str:
    """The runtime's device: LIBZL_TPU_BACKEND when set, else `default`.
    Takes `cuda`, `cuda:N` or `cpu`; any other value raises a ValueError
    naming the variable. The C ABI runtime and the torch stretch both
    resolve their device here."""
    raw = os.environ.get(BACKEND_ENV, "").strip()
    if not raw:
        return default
    if raw in ("cuda", "cpu") or re.fullmatch(r"cuda:\d+", raw):
        return raw
    raise ValueError(
        f"{BACKEND_ENV}={raw!r}: the PyTorch port takes cuda, cuda:N or cpu"
    )


def resolve_device(device) -> torch.device:
    """`"cuda"`, `"cuda:N"`, `"cpu"` or a torch.device -> torch.device.

    Raises when CUDA is asked for and no CUDA device is present: a run that
    was meant for the card never lands on the CPU. On CUDA, TF32 matmuls are
    turned off and the float32 matmul precision must be "highest". The
    render itself runs no matmul (the lane mixdown is ops/mixdown's in-order
    kernel); the guard keeps any float32 product that a caller or a later
    path runs on the card at full precision, since TF32's ~3 decimal digits
    would break the reference's mix tolerance (rtol 1e-5).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda."
                f"is_available() is False"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        if torch.get_float32_matmul_precision() != "highest":
            raise RuntimeError(
                "torch.get_float32_matmul_precision() is "
                f"{torch.get_float32_matmul_precision()!r}; the render needs "
                "'highest' (full f32 lane mixdown)"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: cuda or cpu")
    return dev


def on_device(device: torch.device):
    """A context that makes `device` the calling thread's current CUDA
    device (it is per thread). A null context on the CPU, for "cuda"
    without an index (the current device already), and where the thread
    has it current: entering costs microseconds of host a call, and the
    engine, the bridge and the render all enter their device every
    block."""
    if (device.type == "cuda" and device.index is not None
            and torch.cuda.current_device() != device.index):
        return torch.cuda.device(device)
    return contextlib.nullcontext()
