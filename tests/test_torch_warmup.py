"""The port's warmup (libzl_tpu_torch/engine/engine.py::AudioEngine.warmup)
on the CPU.

The reference's warmup executes every render of its work list, so the first
realtime block of each is warm (libzl_tpu/engine/engine.py, "never inside
the realtime pump"). The port's captures a render graph for each item, then
replays every graph it captured from both staging slots on the thread that
replays it in realtime (the caller's; a lookahead engine's horizon graphs
on the speculative dispatch thread too), runs the native host core's first
calls from the pool's state and puts the state back. On the CPU a graph
is its plain version (engine/graphs.py::_PlainGraph), so the same plumbing
runs here.

These tests hold that every captured graph was warm-replayed without
counting as a realtime replay (one device, a bucketed engine, a windows
engine's gather fallback, H=0 and H=2, a k=2 mesh, the chain of a mesh
across cards, and a recapture after the bank grew); that a warmed engine's
first 16 blocks are bit-equal to those of an engine that was never warmed,
and within the reference's tolerances of the reference jax engine's same
blocks; and that warmup leaves the pool's state arrays as it found them.
"""

import threading

import numpy as np
import pytest
import torch

from libzl_tpu.engine import commands as ref_commands
from libzl_tpu.engine.engine import AudioEngine as RefEngine
from libzl_tpu.io import wav as ref_wav
from libzl_tpu.models import clip as ref_clip
from libzl_tpu_torch.engine import graphs as graphs_mod
from libzl_tpu_torch.engine import hostcore
from libzl_tpu_torch.engine.commands import ClipCommand
from libzl_tpu_torch.engine.engine import AudioEngine
from libzl_tpu_torch.engine.render import RenderOutputs
from libzl_tpu_torch.engine.soundbank import SoundBank
from libzl_tpu_torch.io.wav import AudioData
from libzl_tpu_torch.models.clip import ClipAudioSource
from libzl_tpu_torch.ops import fetch_windows as fw
from libzl_tpu_torch.ops import mixdown as md
from libzl_tpu_torch.parallel.sharding import make_mesh

SR = 48000
B = 128
V = 128
BLOCKS = 16
SPEC_THREAD = "libzl-spec-dispatch"

# name -> (engine options, mesh shards, chained plan)
CASES = {
    "per_block": (dict(lookahead=0, voice_buckets="off"), 1, False),
    "bucketed": (dict(lookahead=0), 1, False),
    "h2": (dict(lookahead=2, voice_buckets="off"), 1, False),
    "windows": (dict(lookahead=0, fetch="windows"), 1, False),
    "windows_h2": (dict(lookahead=2, fetch="windows"), 1, False),
    "mesh2": (dict(lookahead=0, fetch="windows"), 2, False),
    "mesh2_h2": (dict(lookahead=2, fetch="windows"), 2, False),
    "chain2": (dict(lookahead=2, fetch="windows"), 2, True),
}


def _tone(seconds, freq, audio_data=AudioData):
    t = np.arange(int(SR * seconds)) / SR
    return audio_data(
        (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)[:, None], SR)


def _command(cls, clip_id, note, channel, stop=False):
    cmd = cls.channel(clip_id, channel)
    cmd.midi_note = note
    if stop:
        cmd.stop_playback = True
        return cmd
    cmd.change_volume = True
    cmd.volume = 0.7
    cmd.start_playback = True
    cmd.looping = True
    cmd.change_looping = True
    return cmd


def _engine(case, render_graphs="auto", bank_frames=None):
    opts, k, chained = CASES[case]
    eng = AudioEngine("cpu", sample_rate=SR, block_frames=B, num_voices=V,
                      render_graphs=render_graphs,
                      mesh=make_mesh(devices=["cpu"] * k) if k > 1 else None,
                      **opts)
    if bank_frames is not None:
        eng.bank = SoundBank(capacity_frames=bank_frames,
                             tail_guard=eng.bank._tail_guard)
    if chained:
        # one segment a shard: the chain a mesh across cards replays
        mesh = eng.mesh
        eng._graphs = graphs_mod.RenderGraphs(
            mesh.devices[0], [(d, i, 1) for i, d in enumerate(mesh.devices)])
    return eng


def _first_blocks(eng, ref=False, warm=True):
    """Two clips, the transport, warmup (when `warm`), then BLOCKS blocks:
    four notes at block 0 (a horizon after three clean blocks at H=2), a
    pitch over the windows envelope at block 6 (ratio 4.24: the gather
    fallback), a note-off at block 11. Returns (outputs, voices in the
    densest lane a block)."""
    clip_cls = ref_clip.ClipAudioSource if ref else ClipAudioSource
    data = ref_wav.AudioData if ref else AudioData
    cmd_cls = ref_commands.ClipCommand if ref else ClipCommand
    clips = [clip_cls(eng, audio=_tone(0.5, 220.0, data)),
             clip_cls(eng, audio=_tone(0.3, 330.0, data))]
    eng.start_transport(bpm=120)
    if warm:
        eng.warmup()

    def play(clip, note, channel, stop=False):
        eng.schedule_clip_command(
            _command(cmd_cls, clip.id, note, channel, stop=stop), 0)

    script = {
        0: lambda: [play(clips[i % 2], 57 + 3 * i, i) for i in range(4)],
        6: lambda: play(clips[0], 85, 5),
        11: lambda: play(clips[1], 60, 1, stop=True),
    }
    outs, dens = [], []
    for b in range(BLOCKS):
        if b in script:
            script[b]()
        act = eng.pool.active.copy()
        outs.append(eng.process_block().outputs)
        act |= eng.pool.active
        dens.append(int(np.bincount(eng.pool.lane[act], minlength=12).max())
                    if act.any() else 0)
    if not ref:
        eng.drain_speculation()
    return outs, dens


def _assert_warm(eng):
    """Every captured graph warm-replayed on this thread (a horizon graph
    of a lookahead engine also on the spec dispatch thread), none counted
    as a realtime replay."""
    g = eng._graphs
    stats = eng.stats()
    me = threading.current_thread().name
    assert stats["graphs"] == len(g) > 0
    assert stats["graph_replays"] == 0
    spec = 0
    for entry in g._entries.values():
        assert me in entry.warmed, entry.key
        on_spec = any(n.startswith(SPEC_THREAD) for n in entry.warmed)
        assert on_spec == (entry.key.kind == "horizon"), entry.key
        spec += on_spec
    # each graph from both staging slots, on each of its threads
    assert stats["graph_warm_replays"] == 2 * (len(g) + spec)
    return stats


@pytest.mark.parametrize("case", list(CASES))
def test_warmup_replays_every_graph(case):
    eng = _engine(case)
    ClipAudioSource(eng, audio=_tone(0.25, 220.0))
    n = eng.warmup()
    stats = _assert_warm(eng)
    assert stats["warmed_graphs"] == stats["graphs"] == n
    assert stats["late_captures"] == 0 and stats["graph_recaptures"] == 0
    keys = eng._graphs.keys()
    opts, k, chained = CASES[case]
    assert stats["graph_segments"] == (k if chained else 1)
    if opts.get("fetch") == "windows":
        assert any(key.fetch == "gather" for key in keys)   # the fallback
    if case == "bucketed":
        assert len({key.voices for key in keys}) > 1
    assert any(key.kind == "horizon" for key in keys) == bool(
        opts["lookahead"])


@pytest.mark.parametrize("case", ["windows", "windows_h2", "chain2"])
def test_rebind_warm_replays_the_recaptured_graphs(case):
    """A clip load that outgrows the bank recaptures every graph
    (RenderGraphs.rebind), and each recaptured graph is warm-replayed on
    the thread that grew the bank before the block that meets it replays
    it (not on the spec dispatch thread, where the warm would hold the GIL
    against the blocks that follow)."""
    eng = _engine(case, bank_frames=1 << 15)
    outs, _ = _first_blocks(eng)
    before = eng.stats()
    graphs = before["graphs"]
    loaded = ClipAudioSource(eng, audio=_tone(1.0, 440.0))   # > 1 << 15
    eng.schedule_clip_command(
        _command(ClipCommand, loaded.id, 64, 7), 0)
    for _ in range(4):
        eng.process_block()
    eng.drain_speculation()
    stats = eng.stats()
    assert eng.bank.capacity_frames > 1 << 15
    assert stats["graph_recaptures"] == graphs
    for entry in eng._graphs._entries.values():
        assert entry.key.bank[0][-1] == eng.bank.capacity_frames
        assert entry.warmed == {threading.current_thread().name}
    assert stats["graph_warm_replays"] - before["graph_warm_replays"] == \
        2 * graphs
    assert stats["spec_failures"] == 0


@pytest.mark.parametrize("case", ["per_block", "bucketed", "h2",
                                  "windows_h2", "mesh2", "mesh2_h2",
                                  "chain2"])
def test_warmed_first_blocks_equal_never_warmed(case):
    """Warmup renders nothing a block sees: a warmed engine's first 16
    blocks are bit-equal, every output field, to those of an engine of the
    same options that was never warmed (its graphs captured late)."""
    warmed, dens = _first_blocks(_engine(case))
    cold_eng = _engine(case)
    cold, _ = _first_blocks(cold_eng, warm=False)
    assert cold_eng.stats()["late_captures"] > 0
    for b, (got, want) in enumerate(zip(warmed, cold)):
        for name, x, y in zip(RenderOutputs._fields, got, want):
            assert torch.equal(x, y), f"block {b} {name}"
    assert max(float(o.master.abs().max()) for o in warmed) > 0.05
    assert max(dens) > 0


@pytest.mark.parametrize("lookahead", [0, 2])
def test_warmed_first_blocks_match_reference(lookahead):
    """A warmed windows engine's first 16 blocks against the reference jax
    engine's (the gather fetch, the same script, not warmed: its renders
    are the same warm or cold) at the engine tolerance: voice peaks rtol
    2e-6 / atol 1e-9, master rtol 1e-5 / atol 2e-6 per voice in the
    densest lane."""
    got, dens = _first_blocks(_engine("windows_h2" if lookahead
                                      else "windows"))
    ref = RefEngine(sample_rate=SR, backend="jax", block_frames=B,
                    num_voices=V, lookahead=lookahead, fetch="gather",
                    host_core="numpy")
    want, _ = _first_blocks(ref, ref=True, warm=False)
    for b in range(BLOCKS):
        np.testing.assert_allclose(
            got[b].voice_peaks.numpy(), np.asarray(want[b].voice_peaks),
            rtol=2e-6, atol=1e-9, err_msg=f"block {b} voice peaks")
        np.testing.assert_allclose(
            got[b].master.numpy(), np.asarray(want[b].master), rtol=1e-5,
            atol=2e-6 * max(dens[b], 1), err_msg=f"block {b} master")


@pytest.mark.skipif(not hostcore.available(),
                    reason="native host core unavailable")
@pytest.mark.parametrize("lookahead", [0, 2])
def test_warmup_leaves_the_pool_state_as_it_was(lookahead):
    """Warmup runs the native host core's first voice_update (and
    horizon_update at H > 0) from the live pool, mid-session with voices
    sounding and dying, and puts the state back: every array the native
    core reads or writes is bit-equal after warmup to before it."""
    eng = _engine("h2" if lookahead else "per_block")
    assert eng.use_native_host
    clip = ClipAudioSource(eng, audio=_tone(0.05, 220.0))
    eng.start_transport(bpm=120)
    for ch in range(6):
        eng.schedule_clip_command(
            _command(ClipCommand, clip.id, 50 + ch, ch), 0)
    for _ in range(5):
        eng.process_block()
    eng.drain_speculation()
    fields = hostcore._STATE_FIELDS[:-1]
    before = {n: getattr(eng.pool, n).copy() for n in fields}
    assert before["active"].any()
    eng.warmup()
    for n in fields:
        np.testing.assert_array_equal(getattr(eng.pool, n), before[n],
                                      err_msg=n)
    # the native core's pointer cache holds the live pool and the lanes of
    # the per-block call, the first block's
    _, _, lane = eng.pool._hostcore_state_cache
    assert lane is eng.lane_enabled


def _fake_render(prog):
    fw._count_launch()
    md._count_launch()
    s = torch.as_tensor(prog).to(torch.float32).sum()
    return RenderOutputs(*(torch.full((2, 3), float(i)) + s
                           for i in range(len(RenderOutputs._fields))))


def test_warm_restages_the_last_program_from_both_slots():
    """RenderGraphs.warm replays a graph on the program it last staged,
    once from each staging slot, adds its launches, and counts the replays
    apart: a later replay renders its own program, and a dead graph is
    skipped."""
    g = graphs_mod.RenderGraphs("cpu")
    bound = object()
    g.rebind(bound)
    key = graphs_mod.GraphKey("block", 4, "windows",
                              ((2, 64), "torch.float32"))
    prog = np.arange(12, dtype=np.int32).reshape(4, 3)
    out, captured = g.render(key, _fake_render, prog, bound)
    assert captured
    f0, m0 = fw.fetch_interp.launches, md.lane_mixdown.launches
    assert g.warm() == 2
    (entry,) = g._entries.values()
    assert entry.warmed == {threading.current_thread().name}
    for slot in entry.segments[0].staging:
        np.testing.assert_array_equal(slot.numpy(), prog)
    assert (g.replays, g.warm_replays) == (0, 2)
    assert (fw.fetch_interp.launches - f0, md.lane_mixdown.launches - m0) \
        == (2, 2)
    again, captured = g.render(key, _fake_render, prog + 1, bound)
    assert not captured and g.replays == 1
    assert float(again.master[0, 0]) == float(out.master[0, 0]) + 12
    entry.dead = True
    assert g.warm() == 0 and g.warm_replays == 2
    fw.fetch_interp.launches, md.lane_mixdown.launches = f0, m0


def test_warm_launches_count_what_no_dispatch_made():
    """The launches of warm replays and of the warm-up renders of graphs
    that rebind captures again are counted (they ran) and also summed in
    `warm_launches`: the counts less warm_launches are what the
    dispatches launched."""
    g = graphs_mod.RenderGraphs("cpu")
    bound = object()
    g.rebind(bound)
    key = graphs_mod.GraphKey("block", 4, "windows",
                              ((2, 64), "torch.float32"))
    prog = np.arange(12, dtype=np.int32).reshape(4, 3)
    f0, m0 = fw.fetch_interp.launches, md.lane_mixdown.launches
    g.render(key, _fake_render, prog, bound)          # a dispatch
    g.warm()
    assert g.warm_launches == {"fetch_interp": 2, "lane_mixdown": 2}
    bound = object()
    assert g.rebind(bound, lambda k, cols: (k, _fake_render)) == 1
    # the recapture's warm-up render, then its two warm replays
    assert g.warm_launches == {"fetch_interp": 5, "lane_mixdown": 5}
    g.render(key, _fake_render, prog + 1, bound)      # a dispatch
    assert (g.replays, g.recaptures) == (1, 1)
    assert (fw.fetch_interp.launches - f0 - g.warm_launches["fetch_interp"],
            md.lane_mixdown.launches - m0
            - g.warm_launches["lane_mixdown"]) == (2, 2)
    fw.fetch_interp.launches, md.lane_mixdown.launches = f0, m0
