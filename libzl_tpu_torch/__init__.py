"""libzl_tpu_torch — the libzl_tpu audio engine on PyTorch and CUDA.

A port of `libzl_tpu` (the JAX reference, which stays beside it) to PyTorch,
with the reference's Pallas TPU kernel rewritten by hand for NVIDIA Hopper.
The host half — voice pool, program builder, native host core, scheduler,
clip, MIDI, transport and I/O models — is the port's own copy of the
reference's numpy code, under the reference's paths and names (each module
says which file it copies); the device half is new:

- `ops/`    — ADSR, positions, the voice render, the windows fetch (plain
              PyTorch version + CUDA kernel), strips and meters;
- `engine/` — the per-block render entry points and `AudioEngine`;
- `csrc/`   — the CUDA kernels, built on first use by `_build`;
- `convert` — the reference's numpy state (sound bank, packed programs,
              strips) as device tensors;
- `parallel/` — voice sharding over a mesh of devices, driven from one
              process.

This package imports `torch`, numpy and itself: never `jax`, and nothing of
`libzl_tpu`.
"""

from .device import resolve_device

__all__ = ["resolve_device", "AudioEngine", "ClipAudioSource",
           "WaveFormItem", "save_session", "load_session", "make_mesh"]

# the reference's lazy top-level API (libzl_tpu/__init__.py), on the port's
# modules
_LAZY = {
    "AudioEngine": ("libzl_tpu_torch.engine.engine", "AudioEngine"),
    "ClipAudioSource": ("libzl_tpu_torch.models.clip", "ClipAudioSource"),
    "WaveFormItem": ("libzl_tpu_torch.models.waveform", "WaveFormItem"),
    "save_session": ("libzl_tpu_torch.models.session", "save_session"),
    "load_session": ("libzl_tpu_torch.models.session", "load_session"),
    "make_mesh": ("libzl_tpu_torch.parallel.sharding", "make_mesh"),
}


def __getattr__(name):
    """Lazy top-level API (keeps `import libzl_tpu_torch` light)."""
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'libzl_tpu_torch' has no attribute {name!r}")
