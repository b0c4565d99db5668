"""libzl_tpu_torch.ops.adsr against the reference envelope (numpy and jnp).

Same formulas in the same f32 order, so the envelope is bit-equal except in
exponential-release rows, whose exp2 may differ by an ulp between libms
(rtol 1e-6, as tests/test_adsr.py:196-199 allows for numpy vs jax).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libzl_tpu.ops import adsr as ref
from libzl_tpu_torch.ops import adsr as tadsr


def random_program(seed: int, V: int = 64, B: int = 128) -> ref.AdsrProgram:
    rng = np.random.default_rng(seed)
    return ref.AdsrProgram(
        stage0=rng.integers(0, 5, V).astype(np.int32),
        env0=rng.uniform(0, 1, V).astype(np.float32),
        a_rate=np.where(rng.random(V) < 0.2, 0.0,
                        rng.uniform(0, 0.01, V)).astype(np.float32),
        d_rate=np.where(rng.random(V) < 0.2, 0.0,
                        rng.uniform(0, 0.001, V)).astype(np.float32),
        sustain=rng.uniform(0, 1, V).astype(np.float32),
        rel_rate=rng.uniform(0, 0.001, V).astype(np.float32),
        inv_rel=np.where(rng.random(V) < 0.2, 0.0,
                         rng.uniform(0, 0.001, V)).astype(np.float32),
        rel_log2=rng.uniform(-0.001, 0, V).astype(np.float32),
        release_frame=rng.integers(0, 2 * B, V).astype(np.int32),
        rel_mode=rng.integers(0, 2, V).astype(np.int32),
    )


def juce_program(B: int) -> ref.AdsrProgram:
    """Programs from the host's own rate rules (make_rates/note_on_stage)
    over the reference's parameter corners, released mid-block."""
    rows = []
    for attack in (0.0, 0.002, 0.05):
        for decay in (0.0, 0.1):
            for sustain in (0.4, 1.0):
                for release in (0.0, 0.05, 0.5 / 48000.0):
                    rates = ref.make_rates(attack, decay, sustain, release,
                                           44100.0)
                    stage, env = ref.note_on_stage(attack, decay, sustain)
                    rows.append((stage, env, rates))
    V = len(rows)
    f32 = np.float32
    return ref.AdsrProgram(
        stage0=np.array([r[0] for r in rows], np.int32),
        env0=np.array([r[1] for r in rows], f32),
        a_rate=np.array([r[2]["a_rate"] for r in rows], f32),
        d_rate=np.array([r[2]["d_rate"] for r in rows], f32),
        sustain=np.array([r[2]["sustain"] for r in rows], f32),
        rel_rate=np.zeros(V, f32),
        inv_rel=np.array([r[2]["inv_rel"] for r in rows], f32),
        rel_log2=np.array([r[2]["rel_log2"] for r in rows], f32),
        release_frame=(np.arange(V, dtype=np.int32) * 7) % (B + 16),
        rel_mode=(np.arange(V, dtype=np.int32) % 2),
    )


def to_torch(prog: ref.AdsrProgram) -> ref.AdsrProgram:
    return ref.AdsrProgram(*(torch.from_numpy(np.asarray(f)) for f in prog))


def assert_envelope_equal(got, want, rel_mode):
    exp_rows = np.asarray(rel_mode) == ref.RELEASE_MODE_EXPONENTIAL
    np.testing.assert_array_equal(got[~exp_rows], want[~exp_rows])
    np.testing.assert_allclose(got[exp_rows], want[exp_rows], rtol=1e-6)


@pytest.mark.parametrize("B", [128, 1024])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_start", [False, True])
def test_envelope_block_matches_numpy(B, seed, with_start):
    prog = random_program(seed, B=B)
    start = None
    if with_start:
        start = np.random.default_rng(seed + 10).integers(
            0, B, prog.env0.shape[0]).astype(np.int32)
    want = ref.envelope_block(np, prog, B, start_frame=start)
    got = tadsr.envelope_block(
        to_torch(prog), B,
        start_frame=None if start is None else torch.from_numpy(start),
    )
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert_envelope_equal(got.numpy(), want, prog.rel_mode)


@pytest.mark.parametrize("B", [128, 1024])
def test_envelope_block_matches_jax(B):
    prog = random_program(7, B=B)
    want = np.asarray(ref.envelope_block(jnp, prog, B))
    got = tadsr.envelope_block(to_torch(prog), B).numpy()
    assert_envelope_equal(got, want, prog.rel_mode)


@pytest.mark.parametrize("B", [128, 1024])
def test_envelope_block_juce_rates(B):
    prog = juce_program(B)
    want = ref.envelope_block(np, prog, B)
    got = tadsr.envelope_block(to_torch(prog), B).numpy()
    assert_envelope_equal(got, want, prog.rel_mode)


def test_envelope_final_matches_numpy():
    prog = random_program(3)
    n_frames = np.random.default_rng(4).integers(
        0, 300, prog.env0.shape[0]).astype(np.int32)
    want = ref.envelope_final(np, prog, n_frames)
    got = tadsr.envelope_final(to_torch(prog), torch.from_numpy(n_frames))
    assert_envelope_equal(got.numpy(), want, prog.rel_mode)
