"""libzl_tpu_torch.ops.voice against the reference voice render.

Programs come from the reference host (`VoicePool.build_program` advanced
block by block), so positions cross loop wraps, short loops that wrap
several times per superblock, and beat-quantized resets past the segment
horizon (the bq_reset columns). Tolerances are the reference's own
(tests/test_voice_render.py:214-217): per-voice contributions rtol 2e-6 /
atol 1e-9, the lane mixdown (a matmul, summed in another order) rtol 1e-5 /
atol 1e-7; positions and the program round trip are bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libzl_tpu.engine.voicestate import VoicePool
from libzl_tpu.ops import voice as ref
from libzl_tpu_torch.ops import voice as tv

SR = 48000.0
N_SOUND = 1 << 16


def make_sound(dtype=np.float32) -> np.ndarray:
    """Planar [2, N] bank, int16-quantized like the engine's int16 bank."""
    t = np.arange(N_SOUND) / SR
    sound = np.stack([0.45 * np.sin(2 * np.pi * 440 * t),
                      0.35 * np.sin(2 * np.pi * 663 * t + 0.3)]
                     ).astype(np.float32)
    if dtype == np.int16:
        sound = np.clip(np.round(sound * np.float32(32767.0)),
                        -32768, 32767).astype(np.int16)
    return sound


def make_pool(seed: int, B: int, V: int = 48) -> VoicePool:
    """Mixed looping/one-shot voices on every lane; every third voice is a
    1-3-tick beat-quantized loop (bq_reset columns at B=1024), and voice 1
    loops 300 frames (several positional wraps per superblock)."""
    pool = VoicePool(V, B, SR)
    rng = np.random.default_rng(seed)
    for v in range(V - 6):  # leave some idle
        pool.note_on(
            v,
            clip_id=int(rng.integers(0, 8)),
            midi_note=int(rng.integers(40, 80)),
            midi_channel=int(rng.integers(0, 10)),
            lane=int(rng.integers(0, 12)),
            base=int(rng.integers(0, 4)) * 512,
            length=int(rng.integers(2000, 40000)),
            source_rate=float(rng.choice([44100.0, 48000.0])),
            root_note=60,
            start_sec=float(rng.uniform(0, 0.01)),
            stop_sec=(300 / SR if v == 1 else float(rng.uniform(0.02, 0.6))),
            gain=float(rng.uniform(0.1, 1)),
            clip_volume=float(rng.uniform(0.3, 1)),
            pan=float(rng.uniform(-1, 1)),
            attack=float(rng.choice([0.0, 0.003])),
            decay=float(rng.choice([0.0, 0.05])),
            sustain=float(rng.uniform(0.1, 1.0)),
            release=float(rng.choice([0.0, 0.02])),
            looping=bool(v == 1 or rng.integers(0, 2)),
            length_beats=float(rng.choice([1.0, 2.0, 0.75, 1.3])),
            start_tick=0,
            frame_offset=int(rng.integers(0, B // 2)),
        )
        if v % 3 == 0:
            pool.looping[v] = True
            pool.beat_quantized[v] = True
            pool.loop_len_ticks[v] = int(rng.integers(1, 4))
            pool.next_loop_tick[v] = int(pool.loop_len_ticks[v])
    return pool


def programs(seed: int, B: int, blocks: int):
    """Consecutive host-built programs (the pool advances between them);
    voice 5 is released mid-run."""
    pool = make_pool(seed, B)
    out = []
    for b in range(blocks):
        if b == blocks // 2:
            pool.note_off(5, tail=True, frame_offset=17)
        prog = pool.build_program(
            block_start_sample=b * B, tick_anchor_sample=0.0,
            tick_anchor=0, samples_per_tick=250.0,
        )
        out.append(prog)
        pool.advance(prog)
    return out


def to_torch_program(prog):
    pi, pf = ref.pack_program(prog)
    fused = torch.from_numpy(ref.fuse_packed(pi, pf))
    return tv.unpack_program(*tv.split_fused(fused))


def program_fields(prog):
    fields = {n: getattr(prog, n) for n in prog._fields if n != "env"}
    fields.update({f"env.{n}": getattr(prog.env, n)
                   for n in prog.env._fields})
    return fields


@pytest.mark.parametrize("B", [128, 1024])
def test_split_unpack_round_trip_bit_equal(B):
    for prog in programs(0, B, 3):
        tp = to_torch_program(prog)
        want, got = program_fields(prog), program_fields(tp)
        assert want.keys() == got.keys()
        for name, w in want.items():
            g = got[name]
            w = np.asarray(w)
            assert g.dtype == (torch.float32 if w.dtype == np.float32
                               else torch.int32), name
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # the bq tail is non-empty at B=1024 and empty at the live geometry
    assert (tp.bq_reset.shape[1] > 0) == (B == 1024)


@pytest.mark.parametrize("B,seed", [(128, 0), (128, 1), (1024, 2)])
def test_positions_block_bit_equal(B, seed):
    saw_wrap = saw_bq = False
    for prog in programs(seed, B, 8 if B == 1024 else 24):
        want = ref.positions_block(np, prog, B)
        got = tv.positions_block(to_torch_program(prog), B)
        for name, w, g in zip(("pos_int", "alpha", "seg_idx"), want, got):
            assert g.dtype == (torch.float32 if name == "alpha"
                               else torch.int32)
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        saw_wrap |= bool((want[2] > 0).any())
        saw_bq |= bool((prog.bq_reset < B).any())
    assert saw_wrap
    assert saw_bq == (B == 1024)


def _render_case(sound_np, layout):
    if layout == "interleaved":
        sound_np = np.ascontiguousarray(sound_np.T)
    return sound_np, torch.from_numpy(sound_np)


def _assert_render_close(got, want):
    mix_g, peak_g, c_g = (t.numpy() for t in got)
    mix_w, peak_w, c_w = (np.asarray(a) for a in want)
    np.testing.assert_allclose(c_g, c_w, rtol=2e-6, atol=1e-9)
    np.testing.assert_allclose(peak_g, peak_w, rtol=2e-6, atol=1e-9)
    np.testing.assert_allclose(mix_g, mix_w, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("B", [128, 1024])
@pytest.mark.parametrize("layout", ["planar", "interleaved"])
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("quirk_gain", [False, True])
def test_gather_render_matches_numpy(B, layout, dtype, quirk_gain):
    sound_np, sound_t = _render_case(make_sound(dtype), layout)
    for prog in programs(3, B, 4 if B == 1024 else 10):
        want = ref.render_voices(np, sound_np, prog, B, quirk_gain=quirk_gain,
                                 return_contrib=True)
        got = tv.render_voices(sound_t, to_torch_program(prog), B,
                               quirk_gain=quirk_gain, return_contrib=True)
        _assert_render_close(got, want)


@pytest.mark.parametrize("layout,dtype,quirk_gain", [
    ("planar", np.float32, False),
    ("interleaved", np.int16, True),
])
def test_gather_render_matches_jax(layout, dtype, quirk_gain):
    B = 128
    sound_np, sound_t = _render_case(make_sound(dtype), layout)
    for prog in programs(4, B, 4):
        want = ref.render_voices(jnp, sound_np, prog, B,
                                 quirk_gain=quirk_gain, return_contrib=True)
        got = tv.render_voices(sound_t, to_torch_program(prog), B,
                               quirk_gain=quirk_gain, return_contrib=True)
        _assert_render_close(got, want)


def test_quirk_gain_routes_windows_to_gather():
    """quirk_gain needs the taps separately: a windows request renders
    through gather, exactly as the reference routes it."""
    B = 128
    sound_np = make_sound()
    prog = programs(5, B, 1)[0]
    tp = to_torch_program(prog)
    sound_t = torch.from_numpy(sound_np)
    g = tv.render_voices(sound_t, tp, B, quirk_gain=True, fetch="gather",
                         return_contrib=True)
    w = tv.render_voices(sound_t, tp, B, quirk_gain=True, fetch="windows",
                         return_contrib=True)
    for a, b in zip(g, w):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
