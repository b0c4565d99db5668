"""Strips, meters, finish_block and render_block_fused against the reference.

Elementwise results and maxima are bit-equal to the numpy mirror on the same
lane mix. Sums and means (the master bus, which feeds the global strip and
the master peak, and the lane RMS) reduce in another order: rtol 1e-6.
The fused entry point is held against the reference's jitted
render_block_fused, including `pad_voices_to`, at the render tolerances
(tests/test_voice_render.py:214-217).
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from libzl_tpu.engine import render as ref_render
from libzl_tpu.ops import meters as ref_meters
from libzl_tpu.ops import mixer as ref_mixer
from libzl_tpu.ops import voice as ref_voice
from libzl_tpu_torch.engine import render as tr
from libzl_tpu_torch.ops import meters as tmeters
from libzl_tpu_torch.ops import mixer as tmixer


def strips(seed: int) -> ref_mixer.StripParams:
    rng = np.random.default_rng(seed)
    K = tr.NUM_STRIPS
    f32 = np.float32
    return ref_mixer.StripParams(
        dry=rng.uniform(0, 1.2, K).astype(f32),
        wet1=rng.uniform(0, 1, K).astype(f32),
        wet2=rng.uniform(0, 1, K).astype(f32),
        pan=rng.uniform(-1, 1, K).astype(f32),
        muted=(rng.random(K) < 0.2).astype(f32),
    )


def torch_strips(p: ref_mixer.StripParams) -> ref_mixer.StripParams:
    return ref_mixer.StripParams(*(torch.from_numpy(f) for f in p))


def lane_mix(seed: int, B: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((12, B, 2)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_strips_bit_equal(seed):
    audio = lane_mix(seed, 128)[:tr.NUM_STRIPS]
    p = strips(seed)
    want = ref_mixer.apply_strips(np, audio, p)
    got = tmixer.apply_strips(torch.from_numpy(audio), torch_strips(p))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_block_meters():
    audio = lane_mix(2, 1024)
    np.testing.assert_array_equal(tmeters.block_peaks(
        torch.from_numpy(audio)).numpy(), ref_meters.block_peaks(np, audio))
    np.testing.assert_allclose(tmeters.block_rms(
        torch.from_numpy(audio)).numpy(), ref_meters.block_rms(np, audio),
        rtol=1e-6)


@pytest.mark.parametrize("B", [128, 1024])
def test_finish_block(B):
    mix = lane_mix(3, B)
    peaks = np.random.default_rng(4).random(40).astype(np.float32)
    p = strips(5)
    want = ref_render.finish_block(np, mix, p, peaks)
    got = tr.finish_block(torch.from_numpy(mix), torch_strips(p),
                          torch.from_numpy(peaks))
    assert got._fields == want._fields
    g = {k: v.numpy() for k, v in got._asdict().items()}
    w = want._asdict()
    # elementwise and max outputs: bit-equal
    for name in ("lane_mix", "lane_peaks", "voice_peaks"):
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    for name in ("strip_dry", "strip_wet1", "strip_wet2"):
        np.testing.assert_array_equal(g[name][1:], w[name][1:], err_msg=name)
    # sums and means (the master bus, the lane RMS): rtol 1e-6
    for name in ("master", "master_peak", "lane_rms"):
        np.testing.assert_allclose(g[name], w[name], rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    for name in ("strip_dry", "strip_wet1", "strip_wet2"):
        np.testing.assert_allclose(g[name][0], w[name][0], rtol=1e-6,
                                   atol=1e-7, err_msg=name)


@pytest.mark.parametrize("B,V,pad", [(128, 48, 64), (1024, 32, 0)])
def test_render_block_fused_matches_jax(B, V, pad):
    sound, prog, _ = graft._example_inputs(V, B, 1 << 15)
    pi, pf = ref_voice.pack_program(prog)
    fused = ref_voice.fuse_packed(pi, pf)
    packed = ref_voice.pack_strips(strips(6))
    want = ref_render.render_block_fused(
        sound, fused, packed, block_frames=B, fetch="gather",
        pad_voices_to=pad)
    got = tr.render_block_fused(
        torch.from_numpy(sound), torch.from_numpy(fused),
        torch.from_numpy(packed), block_frames=B, fetch="gather",
        pad_voices_to=pad)
    g = {k: v.numpy() for k, v in got._asdict().items()}
    w = {k: np.asarray(v) for k, v in want._asdict().items()}
    assert g["voice_peaks"].shape == (max(V, pad),)
    assert (g["voice_peaks"][V:] == 0).all()
    np.testing.assert_allclose(g["voice_peaks"], w["voice_peaks"], rtol=2e-6,
                               atol=1e-9)
    for name in ("master", "lane_mix", "strip_dry", "strip_wet1",
                 "strip_wet2", "lane_peaks", "lane_rms", "master_peak"):
        assert g[name].shape == w[name].shape, name
        np.testing.assert_allclose(g[name], w[name], rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    assert np.abs(g["master"]).max() > 0.01
