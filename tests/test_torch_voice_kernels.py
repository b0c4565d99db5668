"""The plain versions of the voice prep, the voice post and the finish
(libzl_tpu_torch/ops/voice_render.py, ops/finish.py: the oracles of
csrc/voice_prep.cu, voice_post.cu and finish_block.cu) against the
reference, on the CPU.

- Voice prep: positions, the windows addressing and the masks bit-equal to
  the reference's positions_block, masks and addressing (numpy and jnp);
  the gain bit-equal except in exponential-release rows, where exp2 may
  differ by an ulp between libms (rtol 1e-6, tests/test_adsr.py:196-199).
- Voice post: on the reference's own windows taps (its Pallas fetch in
  interpret mode) and gain, the contributions and peaks of the reference's
  render_voices(fetch="windows") at the render tolerance (rtol 2e-6, atol
  1e-9, tests/test_voice_render.py:214-217).
- Finish: strips and maxima bit-equal to the reference's finish_block;
  the master bus (and strip 0, the master peak, which act on it) and the
  lane RMS rtol 1e-6, atol 1e-7 (another summation order); the plain
  version bit-equal to its spelled-out order in scalar float32.

- Voice prep of a horizon slice (straight from the compact dynamics):
  torch.equal to unpack_horizon_slice + voice_prep_plain, and the
  reference's unpack_horizon_slice + render fields at the prep's rule.

Programs are hostile draws (test_torch_kernels.hostile_program: every ADSR
stage and release mode, releases, starts and stops mid-block, wrap segments
with loop periods, beat-quantized resets, inactive rows, pan at +-1) and
the reference host's own programs. The card tests of the kernels are in
tests/test_torch_kernels.py.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libzl_tpu.engine import render as ref_render
from libzl_tpu.ops import adsr as ref_adsr
from libzl_tpu.ops import mixer as ref_mixer
from libzl_tpu.ops import voice as ref_voice
from libzl_tpu_torch.engine import render as tr
from libzl_tpu_torch.ops import finish as fin
from libzl_tpu_torch.ops import launch_tally
from libzl_tpu_torch.ops import voice as tv
from libzl_tpu_torch.ops import voice_render as vr
from libzl_tpu_torch.utils import roofline
from test_torch_fetch import make_pool_with_wraps
from test_torch_horizon import horizon_fixture
from test_torch_kernels import (
    device_program,
    finish_inputs,
    hostile_dynamics,
    hostile_program,
    own_columns,
    post_inputs,
)

F32 = np.float32


def ref_program(prog) -> ref_voice.VoiceProgram:
    """The port's numpy program as the reference's VoiceProgram."""
    fields = {n: getattr(prog, n) for n in prog._fields if n != "env"}
    return ref_voice.VoiceProgram(
        env=ref_adsr.AdsrProgram(*prog.env), **fields)


def ref_prep(xp, prog, B: int, r_max: float = 4.0) -> list:
    """The reference's voice body up to the fetch, as render_voices spells
    it (libzl_tpu/ops/voice.py:563-603): (pos_local, alpha, g, valid)."""
    from libzl_tpu.ops.fetch_pallas import SOUND_BLOCK, region_rows

    k = np.arange(B, dtype=np.int32)[None, :]
    pos_int, alpha, seg_idx = ref_voice.positions_block(xp, prog, B)
    env = ref_adsr.envelope_block(xp, prog.env, B,
                                  start_frame=prog.start_frame)
    renders = ((prog.active[:, None] > 0) & (k >= prog.start_frame[:, None])
               & (k < prog.stop_frame[:, None]))
    valid = renders & (pos_int >= 0) & (pos_int < prog.len_minus1[:, None])
    g = (prog.gain[:, None] * env * prog.clip_volume[:, None]).astype(F32)
    region = region_rows(B, r_max)
    in_a = seg_idx == 0
    anchor = xp.where(in_a, prog.win_blk_a[:, None], prog.win_blk_b[:, None])
    pos_local = (pos_int + prog.base[:, None] - anchor * SOUND_BLOCK
                 + xp.where(in_a, 0, region)).astype(np.int32)
    return [np.asarray(a) for a in (pos_local, alpha, g, valid)]


def assert_prep_equal(got, want, rel_mode):
    names = ("pos_local", "alpha", "g", "valid")
    for name, g, w in zip(names, got, want):
        g = g.numpy()
        assert g.dtype == w.dtype, name
        if name != "g":
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        exp_rows = np.asarray(rel_mode) == ref_adsr.RELEASE_MODE_EXPONENTIAL
        np.testing.assert_array_equal(g[~exp_rows], w[~exp_rows])
        np.testing.assert_allclose(g[exp_rows], w[exp_rows], rtol=1e-6,
                                   atol=0)


# ---------------------------------------------------------------- voice prep


@pytest.mark.parametrize("B", [128, 130, 1024])
@pytest.mark.parametrize("W", [0, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_voice_prep_plain_matches_jax(B, W, seed):
    prog = hostile_program(seed, 48, B, W)
    want = ref_prep(jnp, ref_program(prog), B)
    got = vr.voice_prep_plain(device_program(prog), B)
    assert_prep_equal(got, want, prog.env.rel_mode)
    valid = want[3]
    assert valid.any() and not valid.all()


@pytest.mark.parametrize("B", [128, 130, 1024])
@pytest.mark.parametrize("W", [0, 5])
def test_voice_prep_plain_matches_numpy(B, W):
    prog = hostile_program(7 + W, 64, B, W)
    want = ref_prep(np, ref_program(prog), B)
    got = vr.voice_prep_plain(device_program(prog), B)
    assert_prep_equal(got, want, prog.env.rel_mode)


@pytest.mark.parametrize("B", [128, 1024])
def test_voice_prep_plain_on_host_programs(B):
    """The reference host's programs (loop wraps, beat-quantized resets at
    B=1024, a release mid-run), bit-equal to the reference's numpy body."""
    from test_torch_voice import programs

    for prog in programs(2, B, 4):
        want = ref_prep(np, prog, B)
        got = vr.voice_prep_plain(tv.unpack_program(*tv.split_fused(
            torch.from_numpy(ref_voice.fuse_packed(
                *ref_voice.pack_program(prog))))), B)
        assert_prep_equal(got, want, prog.env.rel_mode)


def test_voice_prep_plain_matches_the_reference_at_a_large_block():
    """B=10240 with W = 67 beat-quantized resets (the pool's count at 48
    kHz), a few voices, against the reference's numpy path."""
    from libzl_tpu_torch.constants import bq_extra_resets

    B = 10240
    W = bq_extra_resets(B, 48000)
    assert W == 67
    prog = hostile_program(11, 6, B, W)
    want = ref_prep(np, ref_program(prog), B)
    assert_prep_equal(vr.voice_prep_plain(device_program(prog), B), want,
                      prog.env.rel_mode)
    assert want[3].any()


def test_voice_prep_plain_returns_the_programs_anchors():
    """The window anchors among the outputs are the program's win_blk_a and
    win_blk_b, contiguous (what fetch_interp takes)."""
    prog = device_program(hostile_program(4, 20, 128, 2))
    *_, win_a, win_b = vr.voice_prep_plain(prog, 128)
    assert not prog.win_blk_a.is_contiguous()      # a strided column view
    assert win_a.is_contiguous() and win_b.is_contiguous()
    assert torch.equal(win_a, prog.win_blk_a)
    assert torch.equal(win_b, prog.win_blk_b)


@pytest.mark.parametrize("B", [128, 1024])
@pytest.mark.parametrize("H", [2, 16])
def test_voice_prep_slice_plain_matches_unpack_and_reference(B, H):
    """Every slice h >= 1 of a host-built compact horizon: torch.equal to
    unpack_horizon_slice + voice_prep_plain (the anchors those of the
    unpacked slice: win_blk_a rebuilt, win_blk_b the base's), and the
    reference's unpack_horizon_slice + render fields (its numpy path) at
    the prep's rule (bit-equal; the gain except in exponential-release
    rows, rtol 1e-6)."""
    _, packed, dyn = horizon_fixture(B, H)
    fused = ref_voice.fuse_packed(*packed[0])
    base = tv.unpack_program(*tv.split_fused(torch.from_numpy(fused)))
    ref_base = ref_voice.unpack_program(*ref_voice.split_fused(fused))
    dyn_t = torch.from_numpy(dyn)
    for h in range(1, H):
        got = vr.voice_prep_slice_plain(base, dyn_t, h, B)
        prog = tv.unpack_horizon_slice(base, dyn_t, h, B)
        for a, b in zip(got, vr.voice_prep_plain(prog, B)):
            assert torch.equal(a, b), h
        assert torch.equal(got[4], prog.win_blk_a)
        assert torch.equal(got[5], base.win_blk_b)
        ref = ref_voice.unpack_horizon_slice(np, ref_base, dyn, h, B)
        assert_prep_equal(got[:4], ref_prep(np, ref, B),
                          np.asarray(ref.env.rel_mode))
        np.testing.assert_array_equal(got[4].numpy(),
                                      np.asarray(ref.win_blk_a))


@pytest.mark.parametrize("H,W", [(2, 0), (3, 3), (16, 5)])
def test_voice_prep_slice_plain_on_hostile_dynamics(H, W):
    """Hostile dynamics (negative positions, wraps past the block, the
    release sentinel, every stage): the slice source equals the unpacked
    slice's prep, bit for bit, at every h."""
    B = 130
    base = device_program(hostile_program(8, 24, B, W))
    dyn = torch.from_numpy(hostile_dynamics(9, 24, B, H, W))
    for h in range(1, H):
        want = vr.voice_prep_plain(tv.unpack_horizon_slice(base, dyn, h, B),
                                   B)
        for a, b in zip(vr.voice_prep_slice(base, dyn, h, B), want):
            assert torch.equal(a, b), h


def test_voice_prep_reads_strided_and_own_columns_alike():
    """A block's strided column views and a horizon slice's own tensors
    give the same prep."""
    prog = device_program(hostile_program(3, 40, 128, 2))
    for a, b in zip(vr.voice_prep(prog, 128),
                    vr.voice_prep(own_columns(prog), 128)):
        assert torch.equal(a, b)


def test_prep_columns_follow_the_kernels_layout():
    """PREP_COLUMNS names the program's fields in the order of
    csrc/voice_prep.cu's Col enum."""
    src = (Path(vr.__file__).parent.parent / "csrc" / "voice_prep.cu"
           ).read_text()
    enum = re.search(r"enum Col \{(.*?)\};", src, re.S).group(1)
    cols = [c.strip() for c in enum.replace("\n", " ").split(",")]
    assert cols[-1] == "kCols"
    camel = ["k" + "".join(p.capitalize() for p in
                           name.removeprefix("env.").split("_"))
             for name in vr.PREP_COLUMNS]
    assert cols[:-1] == camel
    prog = device_program(hostile_program(0, 4, 64))
    for name in vr.PREP_COLUMNS:
        vr._column(prog, name)          # every name is a program field
    # the slice source: ops/voice.pack_horizon_dynamics' words as the kernel
    # reads them (pos_int, pos_frac, env0, rel_rate, the 16-bit fields from
    # word 4, the flags after them, the reset pairs after the flags), its
    # sentinels and the anchor's floor division
    const = dict(re.findall(r"constexpr int(?:32_t)? (k\w+) = ([^;]+);", src))
    assert eval(const["kReleaseNone"]) == int(tv.RELEASE_NONE)
    assert int(const["kField16"], 16) == tv._RF16
    assert 1 << int(const["kAnchorShift"]) == tv.WINDOW_ANCHOR_BLOCK
    assert int(const["kMaxSegments"]) == vr.MAX_SEGMENTS
    for word in ("__ldg(w)", "__ldg(w + 1)", "__ldg(w + 2)", "__ldg(w + 3)",
                 "__ldg(w + 4 + i / 2)", "__ldg(w + 4 + npack)",
                 "__ldg(w + 5 + npack + e / 2)"):
        assert word in src, word
    S = tv.MAX_SEGMENTS_PER_BLOCK
    for W in (0, 1, 67, 109):
        assert tv.horizon_dyn_cols(W) == 4 + (S + 1) // 2 + 1 + (W + 1) // 2


# ---------------------------------------------------------------- voice post


@pytest.mark.parametrize("B,dtype", [(128, np.float32), (128, np.int16),
                                     (256, np.float32)])
def test_voice_post_plain_matches_reference_windows_render(B, dtype):
    """On the reference's own windows taps and gain, the contributions and
    peaks of the reference's render_voices(fetch="windows")."""
    from libzl_tpu.ops.fetch_pallas import fetch_interp as ref_fetch

    sound, pool = make_pool_with_wraps(B)
    if dtype == np.int16:
        sound = np.clip(np.round(sound * F32(32767.0)),
                        -32768, 32767).astype(np.int16)
    for b in range(2):
        prog = pool.build_program(
            block_start_sample=b * B, tick_anchor_sample=0.0, tick_anchor=0,
            samples_per_tick=250.0)
        pool.advance(prog)
    _, peak_w, contrib_w = ref_voice.render_voices(
        jnp, sound, prog, B, fetch="windows", return_contrib=True)
    pos_local, alpha, g, valid = ref_prep(jnp, prog, B)
    interp = np.asarray(ref_fetch(sound, pos_local, alpha, prog.win_blk_a,
                                  prog.win_blk_b, block_frames=B))
    peak, contrib = vr.voice_post_plain(
        torch.from_numpy(interp), torch.from_numpy(g),
        torch.from_numpy(valid), torch.from_numpy(prog.pan))
    np.testing.assert_allclose(contrib.numpy(), np.asarray(contrib_w),
                               rtol=2e-6, atol=1e-9)
    np.testing.assert_allclose(peak.numpy(), np.asarray(peak_w), rtol=2e-6,
                               atol=1e-9)
    assert np.abs(contrib.numpy()).max() > 0.05


def test_voice_post_plain_masks_with_a_select():
    """Frames that are not valid give +0.0 (a select), even with a negative
    or zero gain, and a voice's peak is floored at 0."""
    interp = -torch.ones((2, 2, 4))
    g = torch.tensor([[0.0, -1.0, 2.0, 0.0], [1.0, 1.0, 1.0, 1.0]])
    valid = torch.tensor([[False, False, True, True], [False] * 4])
    peak, contrib = vr.voice_post_plain(interp, g, valid,
                                        torch.tensor([0.0, 1.0]))
    assert (contrib[0, :2] == 0).all()
    assert not torch.signbit(contrib[0, :2]).any()
    assert not torch.signbit(contrib[1]).any()
    assert peak.tolist() == [0.0, 0.0]


def test_voice_post_writes_into_out():
    args = post_inputs(1, 6, 64)
    buf = torch.full((2, 6, 64, 2), 5.0)
    peak, got = vr.voice_post(*args, out=buf[1])
    want_peak, want = vr.voice_post_plain(*args)
    assert got.data_ptr() == buf[1].data_ptr()
    assert torch.equal(buf[1], want) and torch.equal(peak, want_peak)
    assert (buf[0] == 5.0).all()


@pytest.mark.parametrize("fetch", ["windows", "windows:grid"])
def test_voice_contrib_windows_is_prep_fetch_post(fetch):
    """voice_contrib's windows path is the three calls, composed."""
    B = 128
    sound, pool = make_pool_with_wraps(B)
    prog = tv.unpack_program(*tv.split_fused(torch.from_numpy(
        ref_voice.fuse_packed(*ref_voice.pack_program(pool.build_program(
            block_start_sample=0, tick_anchor_sample=0.0, tick_anchor=0,
            samples_per_tick=250.0))))))
    sound_t = torch.from_numpy(sound)
    peak, contrib = tv.voice_contrib(sound_t, prog, B, fetch=fetch)
    pos_local, alpha, g, valid, win_a, win_b = vr.voice_prep_plain(prog, B)
    interp = tv.fetch_interp(sound_t, pos_local, alpha, win_a, win_b)
    want_peak, want = vr.voice_post_plain(interp, g, valid, prog.pan)
    assert torch.equal(contrib, want) and torch.equal(peak, want_peak)


# -------------------------------------------------------------------- finish


def ref_strips(packed: np.ndarray) -> ref_mixer.StripParams:
    return ref_mixer.StripParams(*packed)


@pytest.mark.parametrize("B", [128, 130, 1024, 16512])
@pytest.mark.parametrize("seed", [0, 1])
def test_finish_plain_matches_jax(B, seed):
    mix, strips = finish_inputs(seed, 1, B)
    peaks = np.random.default_rng(seed).random(24).astype(F32)
    want = ref_render.finish_block(jnp, mix[0].numpy(),
                                   ref_strips(strips.numpy()), peaks)
    got = tr.finish_block(mix[0], strips, torch.from_numpy(peaks))
    g = {k: v.numpy() for k, v in got._asdict().items()}
    w = {k: np.asarray(v) for k, v in want._asdict().items()}
    for name in ("lane_mix", "lane_peaks", "voice_peaks"):
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    for name in ("strip_dry", "strip_wet1", "strip_wet2"):
        np.testing.assert_array_equal(g[name][1:], w[name][1:], err_msg=name)
        np.testing.assert_allclose(g[name][0], w[name][0], rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    for name in ("master", "master_peak", "lane_rms"):
        np.testing.assert_allclose(g[name], w[name], rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def spelled_finish(mix: np.ndarray, strips: np.ndarray) -> tuple:
    """finish's order in numpy float32: the master a chain over lanes, the
    RMS a zero-padded halving tree, the strips (x * scale) * amount."""
    H, L, B, _ = mix.shape
    master = mix[:, 0].copy()
    for lane in range(1, L):
        master = master + mix[:, lane]
    x = np.concatenate([master[:, None], mix[:, 2:]], axis=1)
    dry, wet1, wet2, pan, muted = (r[None, :, None] for r in strips)
    gate = F32(1.0) - muted
    scale = np.stack([np.minimum(F32(1.0) - pan, F32(1.0)) * gate,
                      np.minimum(F32(1.0) + pan, F32(1.0)) * gate], axis=-1)
    scaled = x * scale[..., 0, :][:, :, None, :]
    sends = [scaled * a[..., None] for a in (dry, wet1, wet2)]
    P = 1
    while P < B:
        P *= 2
    sq = np.zeros((H, L, P, 2), F32)
    sq[:, :, :B] = mix * mix
    while P > 1:
        P //= 2
        sq = sq[:, :, :P] + sq[:, :, P:]
    # the root is the library's (on the CPU not always the rounded one)
    rms = torch.sqrt(torch.from_numpy(sq[:, :, 0] / F32(B))).numpy()
    return (*sends, np.abs(mix).max(axis=2), rms,
            np.abs(sends[0][:, 0]).max(axis=1))


@pytest.mark.parametrize("H,B", [(1, 1), (1, 130), (3, 128), (2, 1024)])
def test_finish_plain_is_the_spelled_order(H, B):
    mix, strips = finish_inputs(H + B, H, B)
    got = fin.finish_plain(mix, strips)
    want = spelled_finish(mix.numpy(), strips.numpy())
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        np.testing.assert_array_equal(g.numpy(), w.astype(F32), err_msg=i)


@pytest.mark.parametrize("H,B", [(2, 128), (16, 128), (16, 130), (3, 1024)])
def test_finish_stacked_equals_each_slice(H, B):
    """A horizon's [H, 12, B, 2] finished in one call gives each slice the
    bits of a per-block finish."""
    mix, strips = finish_inputs(5, H, B)
    peaks = torch.rand(H, 16)
    outs = tr.finish_block(mix, strips, peaks)
    assert isinstance(outs, tuple) and len(outs) == H
    for h, o in enumerate(outs):
        one = tr.finish_block(mix[h], strips, peaks[h])
        for name, a, b in zip(o._fields, o, one):
            assert torch.equal(a, b), (h, name)


def test_finish_block_takes_packed_strips_or_params():
    mix, strips = finish_inputs(9, 1, 128)
    peaks = torch.rand(8)
    a = tr.finish_block(mix[0], strips, peaks)
    b = tr.finish_block(mix[0], tv.unpack_strips(strips), peaks)
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


# ----------------------------------------------------------------- wrappers


def _prep():
    return vr.voice_prep, vr.voice_prep_plain, (
        device_program(hostile_program(2, 12, 128)), 128)


def _prep_slice():
    return vr.voice_prep_slice, vr.voice_prep_slice_plain, (
        device_program(hostile_program(3, 12, 128, 3)),
        torch.from_numpy(hostile_dynamics(3, 12, 128, 4, 3)), 2, 128)


def _post():
    return vr.voice_post, vr.voice_post_plain, post_inputs(2, 12, 128)


def _finish():
    return fin.finish, fin.finish_plain, finish_inputs(2, 2, 128)


@pytest.mark.parametrize("case", [_prep, _prep_slice, _post, _finish])
def test_wrapper_on_cpu_is_the_plain_version(case):
    wrapper, plain, args = case()
    before = launch_tally.counts()
    for a, b in zip(wrapper(*args), plain(*args)):
        assert torch.equal(a, b)
    assert launch_tally.counts() == before


@pytest.mark.parametrize("case", [_prep, _prep_slice, _post, _finish])
def test_wrapper_refuses_other_devices(case):
    wrapper, _, args = case()

    def meta(x):
        if isinstance(x, torch.Tensor):
            return x.to("meta")
        if isinstance(x, tuple) and hasattr(x, "_replace"):
            return type(x)(*(meta(f) for f in x))
        return x

    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(*(meta(a) for a in args))


def test_argument_checks_take_any_reset_count_and_block_size():
    """The wrappers' checks (run before a launch, no card needed) take the
    W = 109 resets of B=16512 at 48 kHz and a 16512-frame finish, and
    refuse what the kernels do not take."""
    from libzl_tpu_torch.constants import bq_extra_resets

    W = bq_extra_resets(16512, 48000)
    assert W == 109
    prog = device_program(hostile_program(5, 4, 64, W))
    cols, S, got_w = vr.prep_columns(prog)
    assert (S, got_w) == (tv.MAX_SEGMENTS_PER_BLOCK, W)
    assert cols.ptr[vr.PREP_COLUMNS.index("bq_reset")] == \
        prog.bq_reset.data_ptr()
    assert cols.stride[0] == prog.active.stride(0)
    D = tv.horizon_dyn_cols(W)
    dyn = torch.from_numpy(hostile_dynamics(5, 4, 64, 3, W))
    assert vr.slice_offset(prog, dyn, 2) == 1 + D
    mix, strips = finish_inputs(5, 1, 16512)
    assert fin.check_finish(mix, strips) == (1, 12, 16512)
    with pytest.raises(ValueError):
        vr.prep_columns(prog._replace(gain=prog.gain.double()))
    with pytest.raises(ValueError):
        vr.slice_offset(prog, dyn, 0)
    with pytest.raises(ValueError):
        vr.slice_offset(prog, dyn, 3)             # past the dynamics
    with pytest.raises(ValueError):
        vr.slice_offset(prog, dyn[:, ::2], 1)     # words not adjacent
    with pytest.raises(ValueError):
        fin.check_finish(mix[:, :, :0], strips)
    with pytest.raises(ValueError):
        fin.check_finish(mix, strips[:, :10])
    with pytest.raises(ValueError):             # the kernel's 12 lanes only
        fin.check_finish(mix[:, :5].contiguous(), strips[:, :4].contiguous())


def test_every_kernel_is_registered():
    assert set(launch_tally.counts()) == {
        "fetch_interp", "lane_mixdown", "voice_prep", "voice_post",
        "finish_block"}


def test_launch_tally_counts_tallies_and_adds():
    before = launch_tally.counts()
    with launch_tally.recording() as tally:
        launch_tally.count("voice_prep")
        launch_tally.count("finish_block")
        launch_tally.count("voice_prep")
    assert dict(tally) == {"voice_prep": 2, "finish_block": 1}
    assert launch_tally.counts() == before
    launch_tally.count("voice_post")
    launch_tally.add(tally)
    after = launch_tally.counts()
    assert after["voice_prep"] == before["voice_prep"] + 2
    assert after["voice_post"] == before["voice_post"] + 1
    assert after["finish_block"] == before["finish_block"] + 1
    assert vr.voice_prep.launches == after["voice_prep"]
    for name, wrapper in (("voice_prep", vr.voice_prep),
                          ("voice_post", vr.voice_post),
                          ("finish_block", fin.finish)):
        wrapper.launches = before[name]


# ------------------------------------------------------------------- bounds


def test_voice_prep_bound_counts_each_byte_once():
    prog = device_program(hostile_program(0, 10, 64, 3))
    b = roofline.voice_prep_bound(prog, 64)
    assert b["bytes"] == 10 * (22 + 3 * 4 + 3) * 4 + 13 * 10 * 64 + 8 * 10
    assert b["bound_by"] == "bytes" and b["bound_ms"] > 0


def test_voice_prep_slice_bound_counts_each_byte_once():
    """A slice reads its D words and istart, and 13 static columns of the
    base program, and writes what a block's prep writes."""
    base = device_program(hostile_program(0, 10, 64, 3))
    dyn = torch.from_numpy(hostile_dynamics(0, 10, 64, 4, 3))
    b = roofline.voice_prep_slice_bound(base, dyn, 2, 64)
    D = tv.horizon_dyn_cols(3)
    assert b["bytes"] == 10 * (13 + 1 + D) * 4 + 13 * 10 * 64 + 8 * 10
    assert b["bytes"] < roofline.voice_prep_bound(base, 64)["bytes"]
    assert b["bound_by"] == "bytes"


def test_voice_post_bound_counts_each_byte_once():
    b = roofline.voice_post_bound(*post_inputs(0, 10, 64))
    assert b["bytes"] == 21 * 10 * 64 + 8 * 10
    assert b["bound_ms"] == pytest.approx(b["bytes"] / 3.35e12 * 1e3)


def test_finish_bound_counts_each_byte_once():
    mix, strips = finish_inputs(0, 3, 128)
    b = roofline.finish_bound(mix, strips)
    assert b["bytes"] == (3 * 12 * 128 * 8 + 5 * 11 * 4 + 3 * 3 * 11 * 128 * 8
                          + 2 * 3 * 12 * 8 + 3 * 8)
    assert b["bound_by"] == "bytes"
