"""Voice sharding over a mesh (parallel/sharding.py and AudioEngine(mesh=))
on the CPU, where a mesh repeats the one device: ["cpu"] * n.

The sharded render sums the shards' lane mixes in shard order on the first
device; the unsharded render sums all voices of a lane in one f32 matmul,
whose accumulation order is the BLAS library's. On the randomized session
below the two are bit-equal (measured at 2 and 4 shards, both paths), but
not in general: with 32 voices over 4 clips (chip_smoke.build_session) the
master differed by 4.8e-7 at 4 shards. So the mesh is held to the
whole-engine rule, master and lane peaks rtol 1e-5, atol 2e-6 x the voices
of the densest lane, lane RMS rtol 1e-5, atol 1e-6; a one-shard mesh and
the per-voice peaks, which reduce nothing across shards, are bit-equal.
The reference's tests/test_sharding.py asserts bit-equality of its XLA
reduction; PERF.md says why the port does not.
"""

import dataclasses

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from libzl_tpu.engine.commands import ClipCommand as RefClipCommand
from libzl_tpu.engine.engine import AudioEngine as RefEngine
from libzl_tpu.io.wav import AudioData as RefAudioData
from libzl_tpu.models.clip import ClipAudioSource as RefClip
from libzl_tpu.ops import voice as ref_voice
from libzl_tpu.parallel.sharding import make_mesh as ref_make_mesh
from libzl_tpu_torch import convert
from libzl_tpu_torch.engine import render as tr
from libzl_tpu_torch.engine.commands import ClipCommand
from libzl_tpu_torch.engine.engine import AudioEngine
from libzl_tpu_torch.io.wav import AudioData
from libzl_tpu_torch.models.clip import ClipAudioSource
from libzl_tpu_torch.parallel import sharding
from libzl_tpu_torch.parallel.sharding import Mesh, make_mesh

SR = 48000


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _api(engine):
    if isinstance(engine, RefEngine):
        return RefClip, RefAudioData, RefClipCommand
    return ClipAudioSource, AudioData, ClipCommand


def run_random_session(engine, blocks=30, seed=3):
    """tests/test_sharding.py's randomized session: 4 clips, 12 notes at
    random channels, pans, volumes and start ticks, two strips set.
    Returns per-block (master, lane_peaks, lane_rms) stacks and the densest
    lane's voice count."""
    clip_cls, data_cls, cmd_cls = _api(engine)
    rng = np.random.default_rng(seed)
    engine.set_strip(2, dry=0.8, pan=0.3)
    engine.set_strip(5, wet1=0.4)
    clips = []
    for i in range(4):
        n = int(rng.integers(4000, 16000))
        t = np.arange(n) / SR
        w = (0.3 * np.sin(2 * np.pi * (180 + 60 * i) * t)).astype(np.float32)
        clips.append(clip_cls(engine, audio=data_cls(w[:, None], SR)))
        clips[-1].set_pan(float(rng.uniform(-1, 1)))
    engine.start_transport(bpm=132)
    for v in range(12):
        cmd = cmd_cls.channel(clips[v % 4].id, int(rng.integers(0, 10)))
        cmd.midi_note = int(rng.integers(48, 72))
        cmd.change_volume = True
        cmd.volume = float(rng.uniform(0.3, 1.0))
        cmd.looping = bool(v % 2)
        cmd.start_playback = True
        engine.schedule_clip_command(cmd, int(rng.integers(0, 12)))
    out = {"master": [], "lane_peaks": [], "lane_rms": []}
    densest = 1
    for _ in range(blocks):
        o = engine.process_block().outputs
        for k in out:
            v = getattr(o, k)
            out[k].append(v.numpy() if torch.is_tensor(v) else np.asarray(v))
        act = engine.pool.active
        if act.any():
            densest = max(densest, int(np.bincount(engine.pool.lane[act])
                                       .max()))
    return {k: np.stack(v) for k, v in out.items()}, densest


def assert_engine_rule(got, want, densest, tag=""):
    for name in ("master", "lane_peaks"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=2e-6 * densest, err_msg=tag + name)
    np.testing.assert_allclose(got["lane_rms"], want["lane_rms"], rtol=1e-5,
                               atol=1e-6, err_msg=tag + "lane_rms")
    assert np.abs(want["master"]).max() > 0.05


def port(mesh=None, **kw):
    kw.setdefault("num_voices", 32)
    return AudioEngine("cpu", sample_rate=SR, mesh=mesh, **kw)


@pytest.fixture(scope="module")
def unsharded():
    """The per-block port engine on the randomized session (the reference
    of the mesh cases)."""
    return run_random_session(port(lookahead=0))


@pytest.mark.parametrize("lookahead", [0, "auto"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_mesh_matches_unsharded_engine(n, lookahead, unsharded):
    want, d0 = unsharded
    eng = port(cpu_mesh(n), lookahead=lookahead)
    got, d1 = run_random_session(eng)
    assert_engine_rule(got, want, max(d0, d1), f"n={n} ")
    if n == 1:
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    if lookahead == "auto":
        kinds = eng.stats()["slo_by_kind"]
        assert kinds["horizon"][1] + kinds.get("event_rebuild", [0, 0])[1]
        eng.drain_speculation()


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_matches_reference_mesh_engine(n):
    """The port's mesh against the reference's make_mesh(n) engine (gather
    fetch, per-block dispatch) on the same session."""
    ref = RefEngine(sample_rate=SR, backend="jax", num_voices=32,
                    mesh=ref_make_mesh(n), lookahead=0, fetch="gather",
                    host_core="numpy")
    want, d0 = run_random_session(ref, blocks=25)
    got, d1 = run_random_session(port(cpu_mesh(n), lookahead=0), blocks=25)
    assert_engine_rule(got, want, max(d0, d1))


def _fused_inputs(V, B, seed_frames=1 << 12):
    sound, prog, strips = graft._example_inputs(V, B, seed_frames)
    fused = ref_voice.fuse_packed(*ref_voice.pack_program(prog))
    return (np.ascontiguousarray(sound), fused,
            torch.from_numpy(ref_voice.pack_strips(strips)))


@pytest.mark.parametrize("fetch", ["gather", "windows"])
def test_render_block_sharded_matches_fused(fetch):
    """The sharded block render (each shard through render_voices, the
    windows fetch per shard included) against render_block_fused on the
    whole program; per-voice peaks bit-equal, padded to the pool."""
    V, B = 64, 128
    sound, fused, strips = _fused_inputs(V, B)
    bank = convert.sound_bank_tensor(
        sound, "cpu", layout="planar" if fetch == "windows"
        else "interleaved")
    want = tr.render_block_fused(bank, torch.from_numpy(fused), strips,
                                 block_frames=B, fetch=fetch,
                                 pad_voices_to=2 * V)
    mesh = cpu_mesh(4)
    got = sharding.render_block_sharded(
        mesh, {mesh.devices[0]: bank}, fused, strips, block_frames=B,
        fetch=fetch, pad_voices_to=2 * V)
    np.testing.assert_array_equal(got.voice_peaks.numpy(),
                                  want.voice_peaks.numpy())
    assert got.voice_peaks.shape == (2 * V,)
    for name in ("master", "lane_mix", "strip_dry", "lane_peaks"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name).numpy(),
                                   rtol=1e-5, atol=2e-6 * 8, err_msg=name)
    assert float(want.master.abs().max()) > 0


def test_render_horizon_sharded_matches_onebuf():
    """The sharded horizon against render_horizon_onebuf: H slices rebuilt
    per shard, one stacked reduction."""
    from libzl_tpu_torch.engine.voicestate import VoicePool
    from libzl_tpu_torch.ops import voice as pv

    V, B, H = 32, 128, 4
    pool = VoicePool(V, B, float(SR))
    rng = np.random.default_rng(5)
    for v in range(V - 4):
        pool.note_on(v, clip_id=v % 3, midi_note=int(rng.integers(50, 70)),
                     midi_channel=int(rng.integers(0, 10)),
                     lane=int(rng.integers(0, 12)), base=0, length=4000,
                     source_rate=48000.0, root_note=60, start_sec=0.0,
                     stop_sec=1.0, gain=0.5, clip_volume=0.8,
                     pan=float(rng.uniform(-1, 1)), attack=0.0, decay=0.0,
                     sustain=1.0, release=0.0, looping=True,
                     length_beats=1.0, start_tick=0)
    packed = []
    for h in range(H):
        prog = pool.build_program(block_start_sample=float(h * B),
                                  tick_anchor_sample=0.0, tick_anchor=0,
                                  samples_per_tick=250.0)
        packed.append(pv.pack_program(prog))
        pool.advance(prog)
    dyn = pv.pack_horizon_dynamics(packed[1:], pool.istart)
    base = pv.fuse_packed(*packed[0])
    hz = np.concatenate([base, dyn], axis=1)
    t = np.arange(8192) / SR
    wave = np.stack([np.sin(2 * np.pi * 200 * t)] * 2).astype(np.float32)
    bank = torch.from_numpy(np.ascontiguousarray(wave.T))
    strips = torch.from_numpy(pv.pack_strips(tr.mixer_ops.default_strip_params(
        tr.NUM_STRIPS)))
    want = tr.render_horizon_onebuf(bank, torch.from_numpy(hz), strips,
                                    block_frames=B, slices=H,
                                    base_cols=base.shape[1])
    mesh = cpu_mesh(4)
    got = sharding.render_horizon_sharded(
        mesh, {mesh.devices[0]: bank}, hz, strips, block_frames=B, slices=H,
        base_cols=base.shape[1])
    assert len(got) == H
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.voice_peaks.numpy(),
                                      w.voice_peaks.numpy())
        np.testing.assert_allclose(g.master.numpy(), w.master.numpy(),
                                   rtol=1e-5, atol=2e-6 * 8)
    assert float(want[-1].master.abs().max()) > 0


def test_mesh_bucket_ladder():
    """test_sharding.py's ladder case: 3 voices on a 128-voice pool over 8
    shards dispatch the 64-voice bucket (8 rows a shard), render what the
    full pool renders, and the session update takes the padded peaks."""
    rows = []
    real = sharding.render_block_sharded

    def spy(mesh, sound, fused, *a, **kw):
        rows.append(fused.shape[0])
        return real(mesh, sound, fused, *a, **kw)

    def run(voice_buckets):
        eng = port(cpu_mesh(8), num_voices=128, voice_buckets=voice_buckets,
                   lookahead=0)
        t = np.arange(9000) / SR
        clip = ClipAudioSource(eng, audio=AudioData(
            (0.4 * np.sin(2 * np.pi * 260 * t)).astype(np.float32)[:, None],
            SR))
        eng.start_transport(bpm=120)
        for ch in range(3):
            clip.play(loop=True, midi_channel=ch)
        out, last = [], None
        for _ in range(25):
            last = eng.process_block()
            out.append(last.outputs.master.numpy())
        return np.concatenate(out), last, eng

    sharding.render_block_sharded = spy
    try:
        bucketed, last, eng = run("auto")
        assert rows and set(rows) == {64}
        rows.clear()
        full, _, _ = run("off")
        assert set(rows) == {128}
    finally:
        sharding.render_block_sharded = real
    ref = RefEngine(sample_rate=SR, backend="jax", num_voices=128,
                    mesh=ref_make_mesh(8), lookahead=0, host_core="numpy")
    assert eng._bucket_ladder == ref._bucket_ladder == [64, 128]
    assert last.outputs.voice_peaks.shape == (128,)
    np.testing.assert_allclose(bucketed, full, atol=1e-6)
    eng.update_session(last)
    # a caller's fetch with bucket-length peaks (the reference's mesh
    # convention) pads to the pool
    fetched = eng.fetch_session_arrays(last)
    fetched["voice_peaks"] = fetched["voice_peaks"][:64]
    eng.update_session(last, fetched=fetched)


@pytest.mark.parametrize("n,V", [(4, 256), (8, 128), (16, 128)])
def test_options_resolve_as_the_reference_mesh(n, V):
    """The ladder unit is max(mesh.size * 8, 8) and the rung prune judges
    the per-shard voice count, as in the reference."""
    eng = port(cpu_mesh(n), num_voices=V, fetch="windows")
    ref = RefEngine(sample_rate=SR, backend="jax", num_voices=V,
                    mesh=ref_make_mesh(min(n, 8)) if n <= 8 else None,
                    host_core="numpy")
    if n <= 8:
        assert eng._bucket_ladder == ref._bucket_ladder
    unit = max(n * 8, 8)
    if eng._bucket_ladder is not None:
        assert all(s % unit == 0 or s == V for s in eng._bucket_ladder)
    eng.RUNG_MIN_SHARD_VOICES = V // n
    assert eng._allowed_rungs(V) == [2.0, 4.0]
    assert eng._allowed_rungs(V // 2) == [4.0]


def test_dryrun_multichip_equivalent():
    """__graft_entry__.dryrun_multichip's engine assertions on an 8-shard
    CPU mesh: the windows fetch per shard, lookahead 4, the ratio ladder
    dispatched at both rungs (a high note mid-session), a horizon engaged,
    the bucket ladder engaged on a sparse pool, and emits."""
    eng = port(cpu_mesh(8), num_voices=128, fetch="windows", lookahead=4,
               block_frames=128)
    assert eng._ratio_ladder == [2.0, 4.0]
    eng.RUNG_MIN_SHARD_VOICES = 8
    t = np.arange(4096) / SR
    clip = ClipAudioSource(eng, audio=AudioData(
        (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)[:, None], SR))
    eng.start_transport(bpm=120)
    clip.play(loop=True, midi_channel=0)
    assert eng.warmup() > 0
    calls = []
    reals = (sharding.render_block_sharded, sharding.render_horizon_sharded)

    def spy(kind, real):
        def f(mesh, sound, fused, *a, **kw):
            calls.append((kind, kw["max_pitch_ratio"], fused.shape[0]))
            return real(mesh, sound, fused, *a, **kw)
        return f

    sharding.render_block_sharded = spy("block", reals[0])
    sharding.render_horizon_sharded = spy("horizon", reals[1])
    kinds, horizon_blocks, res = [], 0, None
    try:
        for i in range(24):
            if i == 12:
                cmd = ClipCommand.channel(clip.id, 1)
                cmd.midi_note = 84              # ratio 4.0: the top rung
                cmd.change_volume = True
                cmd.volume = 1.0
                cmd.start_playback = True
                cmd.looping = True
                cmd.change_looping = True
                eng.schedule_clip_command(cmd, 0)
            res = eng.process_block()
            kinds.append(eng.slo.last_kind)
            horizon_blocks += bool(eng._h_slices)
        eng.drain_speculation()
    finally:
        sharding.render_block_sharded, sharding.render_horizon_sharded = reals
    master = res.outputs.master.numpy()
    assert np.isfinite(master).all() and np.abs(master).max() > 0
    assert horizon_blocks > 0
    assert "horizon" in {k for k, _, _ in calls}
    assert {r for _, r, _ in calls} == {2.0, 4.0}
    assert min(n for _, _, n in calls) < 128      # a prefix bucket
    assert "emit" in kinds
    assert eng.stats()["spec_failures"] == 0
    assert eng.fetch_dispatches["gather"] == 0


def test_mesh_errors(monkeypatch):
    with pytest.raises(ValueError, match="divide evenly"):
        port(cpu_mesh(4), num_voices=30)
    with pytest.raises(ValueError, match="first device"):
        port(Mesh((torch.device("cuda", 0),) * 2), num_voices=32)
    with pytest.raises(ValueError, match="mixed device types"):
        make_mesh(devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="asked for 4"):
        make_mesh(4, devices=["cpu"] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no CUDA device"):
        make_mesh()


def test_mesh_shape():
    mesh = make_mesh(3, devices=["cpu"] * 4)
    assert mesh.size == 3 and mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.distinct() == [torch.device("cpu")]
    with pytest.raises(dataclasses.FrozenInstanceError):
        mesh.devices = ()
