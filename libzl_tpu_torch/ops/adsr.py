"""Closed-form ADSR envelope: its numpy host half and its torch device half.

The counterpart of libzl_tpu/ops/adsr.py (see its docstring for the
semantics). The host half is the reference's: the stage and release-mode
codes, `AdsrProgram`, the juce rate and note-on rules (`make_rates`,
`note_on_stage`), and the numpy envelope the host state mirror evaluates at
a block's last frame (`np_envelope_final`; the reference's xp-generic code
with xp bound to numpy, so its names carry an `np_` prefix). The device
half evaluates the same expressions in the same f32 order on tensors, so the
envelope is bit-equal to the numpy mirror except in exponential-release
rows, where exp2 may differ by an ulp.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

STAGE_IDLE = 0
STAGE_ATTACK = 1
STAGE_DECAY = 2
STAGE_SUSTAIN = 3
STAGE_RELEASE = 4

RELEASE_MODE_LINEAR = 0       # single noteOff: rate fixed at trigger (juce)
RELEASE_MODE_EXPONENTIAL = 1  # noteOff re-issued per frame (auto-release quirk)


class AdsrProgram(NamedTuple):
    """Per-voice envelope program for one block. All arrays shaped [V].

    stage0/env0:   envelope state at block start.
    a_rate/d_rate: juce rates (1/(A*sr), (1-S)/(D*sr)); 0 when unused.
    sustain:       sustain level.
    rel_rate:      linear release rate, valid when stage0==RELEASE.
    inv_rel:       1/(R*sr_source); 0 means release<=0 (immediate cut).
    rel_log2:      log2(1 - inv_rel), for the exponential mode.
    release_frame: frame at which noteOff applies; >= B means none this block.
    rel_mode:      release mode for both in-progress and newly triggered release.
    """

    stage0: Any
    env0: Any
    a_rate: Any
    d_rate: Any
    sustain: Any
    rel_rate: Any
    inv_rel: Any
    rel_log2: Any
    release_frame: Any
    rel_mode: Any


def _np_safe_ceil_div(num, den):
    """ceil(num/den) with den==0 -> 0, clamped to >= 0, as int32."""
    den_ok = den > 0
    q = np.where(den_ok, num / np.where(den_ok, den, 1.0), 0.0)
    return np.maximum(np.ceil(q), 0.0).astype(np.int32)


def np_ads_env_at(prog: AdsrProgram, k):
    """Attack/decay/sustain envelope value at frame index k (no release).

    k may be any broadcastable int array; result is f32. Frame k's value is
    what juce's getNextSample() returns on the (k+1)-th call.
    """
    f32 = np.float32
    one = f32(1.0)
    env0 = prog.env0
    in_attack = prog.stage0 == STAGE_ATTACK
    ka = np.where(
        in_attack, _np_safe_ceil_div(one - env0, prog.a_rate), np.int32(0)
    )
    e_d = np.where(in_attack, one, env0)
    has_decay = np.logical_or(
        np.logical_and(in_attack, prog.d_rate > 0), prog.stage0 == STAGE_DECAY
    )
    kd = np.where(
        has_decay, _np_safe_ceil_div(e_d - prog.sustain, prog.d_rate), np.int32(0)
    )
    e_s = np.where(has_decay, prog.sustain, e_d)
    kf = (k + 1).astype(f32)
    attack_env = np.minimum(env0 + kf * prog.a_rate, one)
    decay_env = np.maximum(e_d - (k - ka + 1).astype(f32) * prog.d_rate, prog.sustain)
    return np.where(k < ka, attack_env, np.where(k < ka + kd, decay_env, e_s)).astype(
        f32
    )


def np_release_env(e_r, steps, rel_rate, rel_log2, mode):
    """Envelope `steps` frames after entering release from value e_r."""
    f32 = np.float32
    # steps < 0 only occurs in lanes discarded by an outer where(); clamp so
    # the dead lanes don't overflow.
    sf = np.maximum(steps, 0).astype(f32)
    linear = np.maximum(e_r - sf * rel_rate, f32(0.0))
    exponential = e_r * np.exp2(sf * rel_log2)
    return np.where(mode == RELEASE_MODE_EXPONENTIAL, exponential, linear).astype(f32)


def np_envelope_values(prog: AdsrProgram, k):
    """Envelope at arbitrary voice-local frame indices.

    prog fields and `k` must already be mutually broadcastable (e.g. fields
    [V,1] with k [1,B], or fields [V] with k [V]). Returns f32 of the
    broadcast shape.
    """
    f32 = np.float32
    stage0 = prog.stage0
    env0 = prog.env0
    rf = prog.release_frame
    mode = prog.rel_mode

    ads = np_ads_env_at(prog, k)

    # Value just before the newly triggered release (frame rf-1; env0 if rf==0).
    e_r = np.where(rf > 0, np_ads_env_at(prog, np.maximum(rf - 1, 0)), env0)
    new_rel_rate = e_r * prog.inv_rel
    # inv_rel == 0 means release<=0: immediate cut to zero (juce noteOff else-branch)
    immediate = prog.inv_rel <= 0
    new_release = np.where(
        immediate,
        f32(0.0),
        np_release_env(e_r, k - rf + 1, new_rel_rate, prog.rel_log2, mode),
    )

    from_release = np_release_env(
        env0, k + 1, prog.rel_rate, prog.rel_log2, mode
    )

    env = np.where(
        stage0 == STAGE_IDLE,
        f32(0.0),
        np.where(
            stage0 == STAGE_RELEASE,
            from_release,
            np.where(k < rf, ads, new_release),
        ),
    )
    return env.astype(f32)


def np_envelope_final(prog: AdsrProgram, n_frames):
    """Envelope at the last rendered frame (voice-local n_frames-1) per
    voice: O(V), used by the host state mirror instead of a full block."""
    k = np.maximum(n_frames - 1, 0).astype(np.int32)
    return np_envelope_values(prog, k)


def make_rates(attack: float, decay: float, sustain: float, release: float,
               source_rate: float) -> dict:
    """juce::ADSR rate computation (recalculateRates), at the source rate."""
    a_rate = 1.0 / (attack * source_rate) if attack > 0 else 0.0
    d_rate = (1.0 - sustain) / (decay * source_rate) if decay > 0 else 0.0
    inv_rel = 1.0 / (release * source_rate) if release > 0 else 0.0
    if 0 < inv_rel < 1:
        rel_log2 = float(np.log2(np.float32(1.0) - np.float32(inv_rel)))
    elif inv_rel >= 1:
        # juce's env *= (1 - inv_rel) goes <= 0 on the first release frame
        # (sub-frame release times): the exponential form must cut, not
        # hold — exp2(-200) underflows f32 to exactly 0 after one step
        rel_log2 = -200.0
    else:
        rel_log2 = 0.0
    return dict(
        a_rate=np.float32(a_rate),
        d_rate=np.float32(d_rate),
        sustain=np.float32(sustain),
        inv_rel=np.float32(inv_rel),
        rel_log2=np.float32(rel_log2),
    )


def note_on_stage(attack: float, decay: float, sustain: float):
    """juce::ADSR::noteOn state decision: returns (stage, env).

    attack>0 -> attack from current env (we start voices at env 0);
    else decay_rate>0 -> env=1, decay; else env=sustain, sustain.
    """
    if attack > 0:
        return STAGE_ATTACK, 0.0
    if decay > 0 and sustain < 1.0:
        return STAGE_DECAY, 1.0
    return STAGE_SUSTAIN, float(sustain)


# --------------------------------------------------------- device half

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
