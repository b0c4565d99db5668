"""Render graphs on meshes of k > 1 shards (engine/graphs.py over
parallel/sharding.segments) on the CPU.

A mesh ["cpu"] * k is one segment: its renders replay one graph a key, as
one card's k shards do. Forcing the plan to one segment a shard runs the
chain that meshes across cards replay (a contrib and a fold graph a
segment, the mix copied into the next segment's static init, a tail graph
on the first device) under the graphs' plain version. Both are held bit for
bit to the same mesh rendering eagerly (render_graphs "off") and to the
unsharded engine, per-block and with lookahead, through a bank growth (every
graph recaptured) and a strips change; warmup() captures the reference
engine's mesh work list; a replay adds k fetch and k mixdown launches;
eight threads replaying one chained key each get their own program's
outputs; and the graph mesh engine meets the reference's make_mesh(2)
engine at the bus rule of tests/test_torch_mesh.py.
"""

import types

import numpy as np
import pytest
import torch

from libzl_tpu.engine.engine import AudioEngine as RefEngine
from libzl_tpu.parallel.sharding import make_mesh as ref_make_mesh
from libzl_tpu_torch.engine import graphs as graphs_mod
from libzl_tpu_torch.engine.commands import ClipCommand
from libzl_tpu_torch.engine.engine import AudioEngine
from libzl_tpu_torch.engine.render import RenderOutputs
from libzl_tpu_torch.engine.soundbank import SoundBank
from libzl_tpu_torch.io.wav import AudioData
from libzl_tpu_torch.models.clip import ClipAudioSource
from libzl_tpu_torch.ops import fetch_windows as fw
from libzl_tpu_torch.ops import mixdown as md
from libzl_tpu_torch.ops import voice as voice_ops
from libzl_tpu_torch.parallel import sharding
from libzl_tpu_torch.parallel.sharding import Mesh, make_mesh, segments

from test_torch_mesh import assert_engine_rule, run_random_session

SR = 48000
B = 128
V = 32
BLOCKS = 40


def _cuda(*indices):
    return Mesh(tuple(torch.device("cuda", i) for i in indices))


@pytest.mark.parametrize("mesh,want", [
    (_cuda(0, 0, 0, 0), [(0, 0, 4)]),
    (_cuda(0, 1, 2, 3), [(0, 0, 1), (1, 1, 1), (2, 2, 1), (3, 3, 1)]),
    (_cuda(0, 0, 1, 1), [(0, 0, 2), (1, 2, 2)]),
    (_cuda(0, 1, 0), [(0, 0, 1), (1, 1, 1), (0, 2, 1)]),
    (_cuda(1), [(1, 0, 1)]),
], ids=["one-card", "four-cards", "two-by-two", "back-again", "one-shard"])
def test_segments(mesh, want):
    """Maximal runs of consecutive shards on one device, in mesh order: a
    pure function of mesh.devices (no card needed)."""
    assert segments(mesh) == [(torch.device("cuda", d), a, n)
                              for d, a, n in want]


def test_segments_of_a_cpu_mesh():
    assert segments(make_mesh(devices=["cpu"] * 3)) == [
        (torch.device("cpu"), 0, 3)]


def _tone(seconds, freq):
    t = np.arange(int(SR * seconds)) / SR
    return AudioData(
        (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)[:, None], SR)


def _command(clip_id, note, channel, stop=False):
    cmd = ClipCommand.channel(clip_id, channel)
    cmd.midi_note = note
    if stop:
        cmd.stop_playback = True
        return cmd
    cmd.change_volume = True
    cmd.volume = 0.8
    cmd.start_playback = True
    cmd.looping = True
    cmd.change_looping = True
    return cmd


def _chained(eng):
    """The engine's graphs planned one segment a shard: the chain a mesh
    across cards replays."""
    mesh = eng.mesh
    eng._graphs = graphs_mod.RenderGraphs(
        mesh.devices[0], [(d, i, 1) for i, d in enumerate(mesh.devices)])
    return eng


def _session(k, lookahead, render_graphs="auto", chained=False):
    """A V-voice windows engine on a k-shard CPU mesh (k=1: unsharded)
    with a small bank: notes, a strips change, a clip load that grows the
    bank (every graph recaptured) and a note-off. Every block's outputs,
    kept alive, and the engine."""
    eng = AudioEngine("cpu", sample_rate=SR, block_frames=B, num_voices=V,
                      lookahead=lookahead, fetch="windows",
                      render_graphs=render_graphs,
                      mesh=make_mesh(devices=["cpu"] * k) if k > 1 else None)
    eng.bank = SoundBank(capacity_frames=1 << 15,
                         tail_guard=eng.bank._tail_guard)
    if chained:
        _chained(eng)
    clip = ClipAudioSource(eng, audio=_tone(0.3, 280.0))
    eng.start_transport(bpm=120)
    eng.warmup()

    def grow():
        loaded = ClipAudioSource(eng, audio=_tone(1.0, 440.0))
        eng.schedule_clip_command(_command(loaded.id, 60, 6), 0)

    script = {
        0: lambda: [eng.schedule_clip_command(
            _command(clip.id, 50 + 4 * ch, ch), 0) for ch in range(5)],
        12: lambda: eng.set_strip(2, dry=0.5, pan=0.3),
        20: grow,
        30: lambda: eng.schedule_clip_command(
            _command(clip.id, 50, 0, stop=True), 0),
    }
    outs = []
    for b in range(BLOCKS):
        if b in script:
            script[b]()
        outs.append(eng.process_block().outputs)
    eng.drain_speculation()
    return outs, eng


@pytest.fixture(scope="module")
def unsharded():
    return {la: _session(1, la)[0] for la in (0, 4)}


def _assert_equal(got, want, tag):
    for b, (g, w) in enumerate(zip(got, want)):
        for name, a, e in zip(RenderOutputs._fields, g, w):
            assert torch.equal(a, e), f"{tag} block {b} {name}"
    assert max(float(o.master.abs().max()) for o in want) > 0.05


def _assert_every_render_a_graph(eng, segments_per_key):
    stats = eng.stats()
    assert stats["render_graphs"] == "graphs"
    assert stats["graph_segments"] == segments_per_key
    assert stats["graphs"] >= stats["warmed_graphs"] > 0
    assert stats["graph_recaptures"] > 0                     # the bank grew
    assert stats["graph_replays"] > 0
    assert sum(eng.render_dispatches.values()) == (
        stats["graph_replays"] + stats["late_captures"]
        + stats["graph_stale_renders"])
    assert stats["spec_failures"] == 0


@pytest.mark.parametrize("lookahead", [0, 4])
@pytest.mark.parametrize("k", [2, 4])
def test_mesh_graphs_match_eager_and_unsharded(k, lookahead, unsharded):
    """A k-shard mesh with render graphs ("auto": one graph a key) and
    eagerly ("off"): every field of every block bit-equal to each other
    and to the unsharded engine."""
    on, eng = _session(k, lookahead)
    off, eager = _session(k, lookahead, render_graphs="off")
    _assert_equal(on, off, f"k={k} auto vs off")
    _assert_equal(on, unsharded[lookahead], f"k={k} auto vs unsharded")
    _assert_every_render_a_graph(eng, 1)
    assert eager.stats()["render_graphs"] == "eager"
    if lookahead:
        assert eng.render_dispatches["horizon"] > 0


@pytest.mark.parametrize("lookahead", [0, 4])
@pytest.mark.parametrize("k", [2, 4])
def test_chained_graphs_match_unsharded(k, lookahead, unsharded):
    """The chain of a mesh across cards (one segment a shard: contrib and
    fold graphs, the carried mix copied into each static init, the tail)
    bit-equal to the unsharded engine, hence to the eager mesh."""
    got, eng = _session(k, lookahead, chained=True)
    _assert_equal(got, unsharded[lookahead], f"k={k} chained")
    _assert_every_render_a_graph(eng, k)
    for entry in eng._graphs._entries.values():
        assert len(entry.segments) == k
        assert entry.segments[0].init is None
        assert all(seg.init is not None for seg in entry.segments[1:])


def _reference_mesh_work(monkeypatch, kw, k) -> tuple:
    """(warmed_graphs, the set of (kind, voices, fetch) renders) of the
    reference engine's warmup on make_mesh(k), its shard_map renders
    spied; every render at the one envelope (at 64 voices the reference's
    ladder keeps its top rung alone)."""
    ref = RefEngine(sample_rate=SR, backend="jax", block_frames=B,
                    num_voices=64, host_core="numpy", mesh=ref_make_mesh(k),
                    **kw)
    calls = set()

    def mesh_render(kind, ratio):
        # None: the over-envelope gather fallback
        assert ratio in (None, ref.max_pitch_ratio)
        fetch = ref.fetch if ratio is not None else "gather"

        def render(sound, prog, strips):
            calls.add((kind, prog.shape[0], fetch))
            out = types.SimpleNamespace(master=np.zeros((B, 2), np.float32))
            return out if kind == "block" else (out,)
        return render

    monkeypatch.setattr(ref, "_mesh_render", mesh_render)
    return ref.warmup(), calls


@pytest.mark.parametrize("kw", [
    {"lookahead": 0},
    {"lookahead": 4},
    {"lookahead": 0, "fetch": "windows"},
], ids=["per-block", "lookahead", "windows"])
def test_mesh_warmup_captures_the_reference_work_list(monkeypatch, kw):
    """warmup() on a 2-shard mesh captures one graph a item of the
    reference's mesh work list, and nothing more."""
    want_n, want = _reference_mesh_work(monkeypatch, kw, 2)
    eng = AudioEngine("cpu", sample_rate=SR, block_frames=B, num_voices=64,
                      mesh=make_mesh(devices=["cpu"] * 2), **kw)
    ClipAudioSource(eng, audio=_tone(0.25, 220.0))
    assert eng.warmup() == want_n
    keys = eng._graphs.keys()
    assert {(g.kind, g.voices, g.fetch) for g in keys} == want
    assert len(keys) == want_n
    stats = eng.stats()
    assert stats["warmed_graphs"] == stats["graphs"] == want_n
    assert stats["late_captures"] == 0 and stats["graph_replays"] == 0


@pytest.mark.parametrize("chained", [False, True], ids=["one-segment",
                                                         "chained"])
@pytest.mark.parametrize("k", [2, 4])
def test_replay_adds_k_fetch_and_k_mixdown_launches(monkeypatch, k, chained):
    """With each shard's fetch and mixdown counted as the kernels count
    their launches, a replay adds k of each, so the counts equal k x the
    windows blocks and k x the renders."""
    real_fetch, real_mix = voice_ops.fetch_interp, sharding.lane_mixdown

    def fetch(*a, **kw):
        fw._count_launch()
        return real_fetch(*a, **kw)

    def mix(*a, **kw):
        md._count_launch()
        return real_mix(*a, **kw)

    monkeypatch.setattr(voice_ops, "fetch_interp", fetch)
    monkeypatch.setattr(sharding, "lane_mixdown", mix)
    eng = AudioEngine("cpu", sample_rate=SR, block_frames=B, num_voices=V,
                      lookahead=0, fetch="windows",
                      mesh=make_mesh(devices=["cpu"] * k))
    if chained:
        _chained(eng)
    clip = ClipAudioSource(eng, audio=_tone(0.3, 330.0))
    eng.start_transport(bpm=120)
    for ch in range(3):
        eng.schedule_clip_command(_command(clip.id, 55 + 5 * ch, ch), 0)
    eng.warmup()
    eng.process_block()
    f0, m0 = fw.fetch_interp.launches, md.lane_mixdown.launches
    replays = eng._graphs.replays
    eng.process_block()
    assert eng._graphs.replays == replays + 1
    assert (fw.fetch_interp.launches - f0,
            md.lane_mixdown.launches - m0) == (k, k)
    eng.fetch_dispatches = {"windows": 0, "gather": 0}
    eng.render_dispatches = {"block": 0, "horizon": 0}
    f0, m0 = fw.fetch_interp.launches, md.lane_mixdown.launches
    for _ in range(6):
        eng.process_block()
    assert fw.fetch_interp.launches - f0 == k * eng.fetch_dispatches[
        "windows"] == 6 * k
    assert md.lane_mixdown.launches - m0 == k * sum(
        eng.render_dispatches.values())


def test_chain_capture_failure_raises_and_keeps_no_graph():
    """A chained capture whose step fails raises; nothing is kept and
    nothing renders eagerly in its place."""
    class Broken:
        def chain(self, plan, rows):
            raise RuntimeError("render failed")

    cpu = torch.device("cpu")
    g = graphs_mod.RenderGraphs(cpu, [(cpu, 0, 1), (cpu, 1, 1)])
    bound = object()
    g.rebind(bound)
    key = graphs_mod.GraphKey("block", 4, "windows",
                              ((2, 64), "torch.float32"))
    with pytest.raises(RuntimeError, match="render failed"):
        g.render(key, Broken(), np.zeros((4, 3), np.int32), bound)
    assert len(g) == 0 and g.captures == 0


class _Steps:
    """A render split as sharding.ShardedRender splits one, in plain
    arithmetic on a [rows, 3] program: a shard's contribution is its rows'
    sum, the fold adds the shards' to the carried value, the tail fans the
    mix out into every field, the voice peaks are column 0."""

    mesh = Mesh((torch.device("cpu"),) * 4)
    chain = sharding.ShardedRender.chain

    def __call__(self, prog):
        rows = torch.as_tensor(prog)
        s = rows.shape[0] // 4
        return self.chain([(torch.device("cpu"), 0, 4)], [rows[:4 * s]])

    def contrib(self, seg, rows):
        s = rows.shape[0] // seg[2]
        parts = [(rows[i * s:(i + 1) * s].to(torch.float32).sum().reshape(1),
                  rows[i * s:(i + 1) * s, 1].contiguous())
                 for i in range(seg[2])]
        return parts, rows[:, 0].to(torch.float32)

    def fold(self, seg, parts, init):
        mix = torch.zeros(1) if init is None else init
        for contrib, _ in parts:
            mix = mix + contrib
        return mix

    def tail(self, mix, peaks, rows):
        return RenderOutputs(*(mix * (i + 1) for i in range(8)),
                             voice_peaks=torch.cat(peaks))


def test_chain_replays_from_many_threads():
    """Eight threads replay one chained key at once (the engine thread and
    the speculative dispatch thread both do), each with its own programs,
    under a short switch interval: every output is its own program's."""
    import sys
    import threading

    cpu = torch.device("cpu")
    g = graphs_mod.RenderGraphs(cpu, [(cpu, i, 1) for i in range(4)])
    bound = object()
    g.rebind(bound)
    key = graphs_mod.GraphKey("block", 8, "windows",
                              ((2, 64), "torch.float32"))
    steps = _Steps()
    base = np.arange(24, dtype=np.int32).reshape(8, 3)
    g.render(key, steps, base, bound)
    errors = []

    def worker(t):
        try:
            for r in range(25):
                prog = base * (t + 1) + r
                got, captured = g.render(key, steps, prog, bound)
                want = steps(prog)
                assert not captured
                for name, a, w in zip(RenderOutputs._fields, got, want):
                    assert torch.equal(a, w), (t, r, name)
        except Exception as exc:  # reported by the main thread
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert g.replays == 8 * 25 and g.captures == 1


def test_plan_must_start_on_the_outputs_device():
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="plan starts"):
        graphs_mod.RenderGraphs(cpu, [(torch.device("cuda", 0), 0, 1)])


@pytest.mark.parametrize("chained", [False, True], ids=["one-segment",
                                                         "chained"])
def test_graph_mesh_matches_reference_mesh_engine(chained):
    """The graph mesh engine (2 shards, lookahead 4: horizons replayed)
    against the reference's make_mesh(2) engine on the same session, at the
    bus rule (tests/test_torch_mesh.py)."""
    ref = RefEngine(sample_rate=SR, backend="jax", num_voices=V,
                    mesh=ref_make_mesh(2), lookahead=0, fetch="gather",
                    host_core="numpy")
    want, d0 = run_random_session(ref, blocks=25)
    eng = AudioEngine("cpu", sample_rate=SR, num_voices=V, lookahead=4,
                      mesh=make_mesh(devices=["cpu"] * 2))
    if chained:
        _chained(eng)
    got, d1 = run_random_session(eng, blocks=25)
    eng.drain_speculation()
    assert_engine_rule(got, want, max(d0, d1))
    stats = eng.stats()
    assert stats["render_graphs"] == "graphs"
    assert stats["graph_segments"] == (2 if chained else 1)
    assert stats["graph_replays"] > 0
