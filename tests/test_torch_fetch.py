"""The windows fetch (libzl_tpu_torch.ops.fetch_windows) against the
reference Pallas kernel (interpret mode on the CPU, as the reference's own
tests run it) and the two-tap oracle, plus the render's windows path and
the suffix grammar.

Tolerances are the reference's (tests/test_fetch_windows.py): atol 2e-6 for
render-level comparisons against gather, 3e-6 in the hostile-positions fuzz,
and out-of-range lanes exactly 0. The JAX-free kernel tests (oracle, build,
and the `cuda`-marked tests that run on the card) are in
tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libzl_tpu.engine.voicestate import VoicePool
from libzl_tpu.ops import voice as ref_voice
from libzl_tpu_torch.ops import fetch_windows as fw
from libzl_tpu_torch.ops import voice as tv
from test_torch_kernels import (
    assert_out_of_range_zero,
    hostile_inputs,
    oracle,
    torch_args,
)

SR = 48000.0


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_plain_matches_reference_kernel_hostile(dtype):
    from libzl_tpu.ops.fetch_pallas import fetch_interp as ref_fetch

    B, V, N = 128, 8, 16384
    args = hostile_inputs(77, V, B, N, dtype, edges=False)
    want = np.asarray(ref_fetch(*args, block_frames=B))
    got = fw.fetch_interp_plain(*torch_args(*args)).numpy()
    assert got.shape == (V, 2, B) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=3e-6)
    np.testing.assert_allclose(got, oracle(*args), atol=3e-6)
    assert_out_of_range_zero(got, args[1])


SUFFIXES = ["", "default", "highest", "loop", "fusedw", "batchdot", "grid",
            "auto", "default,fusedw", "c64", "c32,a8", "a32,c64", "g16",
            "g32,grid,default", "nope", "c100", "a256", "g5", "g4", "c",
            "highest,,loop"]


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_parse_suffix_matches_reference(suffix):
    from libzl_tpu.ops.fetch_pallas import parse_suffix as ref_parse

    try:
        want = ref_parse(suffix)
    except ValueError:
        with pytest.raises(ValueError):
            fw.parse_suffix(suffix)
        return
    assert fw.parse_suffix(suffix) == want


def test_region_rows_matches_reference():
    from libzl_tpu.ops.fetch_pallas import region_rows as ref_rows

    for B in (64, 128, 256, 1024, 2048):
        for r in (1.0, 2.0, 3.3, 4.0):
            assert fw.region_rows(B, r) == ref_rows(B, r)


def make_pool_with_wraps(B: int, V: int = 16):
    """tests/test_fetch_windows.py's fixture: 12 voices on one 5000-frame
    sound at base 1024 of a padded planar bank, half looping."""
    frames = 5000
    t = np.arange(frames) / SR
    sound = np.zeros((2, 16384), np.float32)
    sound[:, 1024:1024 + frames] = np.stack(
        [0.5 * np.sin(2 * np.pi * 440 * t), 0.5 * np.sin(2 * np.pi * 441 * t)]
    )
    pool = VoicePool(V, B, SR)
    rng = np.random.default_rng(3)
    for v in range(12):
        pool.note_on(
            v, clip_id=v, midi_note=int(rng.integers(48, 73)),
            midi_channel=v % 10, lane=2 + v % 10,
            base=1024, length=frames, source_rate=SR, root_note=60,
            start_sec=0.0, stop_sec=frames / SR,
            gain=0.8, clip_volume=0.9, pan=float(rng.uniform(-1, 1)),
            attack=0.002, decay=0.05, sustain=0.6, release=0.05,
            looping=bool(v % 2), length_beats=1.0 + (v % 3) * 0.3,
            start_tick=0,
        )
    return sound, pool


def _torch_prog(prog):
    pi, pf = ref_voice.pack_program(prog)
    return tv.unpack_program(
        *tv.split_fused(torch.from_numpy(ref_voice.fuse_packed(pi, pf))))


@pytest.mark.parametrize("B,blocks,jax_blocks", [(128, 30, 2), (1024, 6, 1)])
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_windows_render_matches_reference_and_gather(B, blocks, jax_blocks,
                                                     dtype):
    sound, pool = make_pool_with_wraps(B)
    if dtype == np.int16:
        sound = np.clip(np.round(sound * np.float32(32767.0)),
                        -32768, 32767).astype(np.int16)
    sound_t = torch.from_numpy(sound)
    for b in range(blocks):  # crosses positional loop wraps
        prog = pool.build_program(
            block_start_sample=b * B, tick_anchor_sample=0.0,
            tick_anchor=0, samples_per_tick=250.0,
        )
        tp = _torch_prog(prog)
        _, peak_w, c_w = tv.render_voices(sound_t, tp, B, fetch="windows",
                                          return_contrib=True)
        _, peak_g, c_g = tv.render_voices(sound_t, tp, B, fetch="gather",
                                          return_contrib=True)
        np.testing.assert_allclose(c_w.numpy(), c_g.numpy(), atol=2e-6,
                                   err_msg=f"block {b}")
        np.testing.assert_allclose(peak_w.numpy(), peak_g.numpy(), atol=2e-6)
        if b < jax_blocks and dtype == np.float32:
            _, peak_j, c_j = ref_voice.render_voices(
                jnp, sound, prog, B, fetch="windows", return_contrib=True)
            np.testing.assert_allclose(c_w.numpy(), np.asarray(c_j),
                                       atol=2e-6, err_msg=f"block {b}")
            np.testing.assert_allclose(peak_w.numpy(), np.asarray(peak_j),
                                       atol=2e-6)
        pool.advance(prog)


def test_windows_suffix_is_validated_and_ignored():
    B = 128
    sound, pool = make_pool_with_wraps(B)
    prog = pool.build_program(block_start_sample=0, tick_anchor_sample=0.0,
                              tick_anchor=0, samples_per_tick=250.0)
    tp, sound_t = _torch_prog(prog), torch.from_numpy(sound)
    plain = tv.render_voices(sound_t, tp, B, fetch="windows")
    tuned = tv.render_voices(sound_t, tp, B, fetch="windows:default,grid,c64")
    for a, b in zip(plain, tuned):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tv.render_voices(sound_t, tp, B, fetch="windows:g4")
