"""Device selection for the port: explicit, never a silent fallback."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`"cuda"`, `"cuda:N"`, `"cpu"` or a torch.device -> torch.device.

    Raises when CUDA is asked for and no CUDA device is present: a run that
    was meant for the card never lands on the CPU. On CUDA, TF32 matmuls are
    turned off and the float32 matmul precision must be "highest": the lane
    mixdown is an f32 matmul, and TF32's ~3 decimal digits would break the
    mix tolerance (rtol 1e-5).
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
