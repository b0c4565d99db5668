"""libzl_tpu_torch — the libzl_tpu audio engine on PyTorch and CUDA.

A port of `libzl_tpu` (the JAX reference, which stays beside it) to PyTorch,
with the reference's Pallas TPU kernel rewritten by hand for NVIDIA Hopper.
The host half — voice pool, program builder, native host core, scheduler,
clip, MIDI and transport models — is the reference's own JAX-free code; this
package replaces the device half:

- `ops/`    — ADSR, positions, the voice render, the windows fetch (plain
              PyTorch version + CUDA kernel), strips and meters;
- `engine/` — the per-block render entry points and `AudioEngine`;
- `csrc/`   — the CUDA kernels, built on first use by `_build`;
- `convert` — the reference's numpy state (sound bank, packed programs,
              strips) as device tensors.

This package imports `torch` and never `jax`.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
