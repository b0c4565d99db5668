"""Closed-form ADSR envelope on tensors (device half of libzl_tpu/ops/adsr.py).

The same expressions in the same f32 order as the reference, so the envelope
is bit-equal to the numpy mirror except in exponential-release rows, where
exp2 may differ by an ulp. `make_rates` and `note_on_stage` are host scalars
and stay in the reference (import them from `libzl_tpu.ops.adsr`).
"""

from __future__ import annotations

import torch

from libzl_tpu.ops.adsr import (
    RELEASE_MODE_EXPONENTIAL,
    STAGE_ATTACK,
    STAGE_DECAY,
    STAGE_IDLE,
    STAGE_RELEASE,
    AdsrProgram,
)

_F32 = torch.float32
_I32 = torch.int32


def _safe_ceil_div(num, den):
    """ceil(num/den) with den==0 -> 0, clamped to >= 0, as int32."""
    den_ok = den > 0
    q = torch.where(den_ok, num / torch.where(den_ok, den, 1.0), 0.0)
    return torch.clamp_min(torch.ceil(q), 0.0).to(_I32)


def ads_env_at(prog: AdsrProgram, k):
    """Attack/decay/sustain envelope value at frame index k (no release).

    k may be any broadcastable int32 tensor; result is f32. Frame k's value
    is what juce's getNextSample() returns on the (k+1)-th call."""
    env0 = prog.env0
    in_attack = prog.stage0 == STAGE_ATTACK
    zero_i = torch.zeros((), dtype=_I32, device=env0.device)
    ka = torch.where(in_attack, _safe_ceil_div(1.0 - env0, prog.a_rate),
                     zero_i)
    e_d = torch.where(in_attack, 1.0, env0)
    has_decay = (in_attack & (prog.d_rate > 0)) | (prog.stage0 == STAGE_DECAY)
    kd = torch.where(
        has_decay, _safe_ceil_div(e_d - prog.sustain, prog.d_rate), zero_i
    )
    e_s = torch.where(has_decay, prog.sustain, e_d)
    kf = (k + 1).to(_F32)
    attack_env = torch.clamp_max(env0 + kf * prog.a_rate, 1.0)
    decay_env = torch.maximum(
        e_d - (k - ka + 1).to(_F32) * prog.d_rate, prog.sustain
    )
    return torch.where(
        k < ka, attack_env, torch.where(k < ka + kd, decay_env, e_s)
    ).to(_F32)


def release_env(e_r, steps, rel_rate, rel_log2, mode):
    """Envelope `steps` frames after entering release from value e_r."""
    # steps < 0 only occurs in lanes discarded by an outer where(); clamp so
    # the dead lanes don't overflow.
    sf = torch.clamp_min(steps, 0).to(_F32)
    linear = torch.clamp_min(e_r - sf * rel_rate, 0.0)
    exponential = e_r * torch.exp2(sf * rel_log2)
    return torch.where(
        mode == RELEASE_MODE_EXPONENTIAL, exponential, linear
    ).to(_F32)


def envelope_values(prog: AdsrProgram, k):
    """Envelope at arbitrary voice-local frame indices (prog fields and k
    mutually broadcastable). Returns f32 of the broadcast shape."""
    stage0 = prog.stage0
    env0 = prog.env0
    rf = prog.release_frame
    mode = prog.rel_mode

    ads = ads_env_at(prog, k)

    # Value just before the newly triggered release (frame rf-1; env0 if
    # rf==0).
    e_r = torch.where(rf > 0, ads_env_at(prog, torch.clamp_min(rf - 1, 0)),
                      env0)
    new_rel_rate = e_r * prog.inv_rel
    # inv_rel == 0 means release<=0: immediate cut to zero (juce noteOff
    # else-branch)
    immediate = prog.inv_rel <= 0
    new_release = torch.where(
        immediate,
        0.0,
        release_env(e_r, k - rf + 1, new_rel_rate, prog.rel_log2, mode),
    )

    from_release = release_env(env0, k + 1, prog.rel_rate, prog.rel_log2,
                               mode)

    env = torch.where(
        stage0 == STAGE_IDLE,
        0.0,
        torch.where(
            stage0 == STAGE_RELEASE,
            from_release,
            torch.where(k < rf, ads, new_release),
        ),
    )
    return env.to(_F32)


def envelope_block(prog: AdsrProgram, block_frames: int, start_frame=None):
    """Envelope values for a whole block: [V, B] f32.

    prog fields are [V]; k runs over [0, B). `start_frame` (optional [V])
    shifts the envelope origin for voices that start mid-block (voice-local
    frames k - start_frame; `release_frame` is in the same frame space)."""
    k = torch.arange(block_frames, dtype=_I32,
                     device=prog.env0.device)[None, :]
    if start_frame is not None:
        k = torch.clamp_min(k - start_frame[:, None], 0)
    prog2 = AdsrProgram(*(f[:, None] for f in prog))
    return envelope_values(prog2, k)


def envelope_final(prog: AdsrProgram, n_frames):
    """Envelope at the last rendered frame (voice-local n_frames-1) per
    voice: O(V)."""
    k = torch.clamp_min(n_frames - 1, 0).to(_I32)
    return envelope_values(prog, k)
