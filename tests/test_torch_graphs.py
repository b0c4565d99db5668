"""Render graphs (libzl_tpu_torch/engine/graphs.py) on the CPU.

On the CPU a graph is its plain version: the same keys, static program,
pinned-staging plumbing (unpinned here), flat outputs and one clone a render,
with a replay that re-runs the recorded render on the static buffers. These
tests hold the plumbing: warmup() captures exactly the reference engine's
work list (libzl_tpu AudioEngine.warmup, its render functions spied), a
session with graphs is bit-equal to the same session dispatched eagerly
(render_graphs "off") through a clip load that grows the bank, a strips
change, bucket moves, the gather fallback of an over-envelope pitch and the
speculative horizon chain, with 32 and more blocks' outputs alive at once,
and it matches the reference jax engine at the engine tolerance (voice peaks
rtol 2e-6 / atol 1e-9; master rtol 1e-5 / atol 2e-6 per voice in the
densest lane). The card's replays are held to the eager render in
tests/test_torch_kernels.py and chip_smoke.py.
"""

import types

import numpy as np
import pytest
import torch

from libzl_tpu.engine import commands as ref_commands
from libzl_tpu.engine import render as ref_render
from libzl_tpu.engine.engine import AudioEngine as RefEngine
from libzl_tpu.io import wav as ref_wav
from libzl_tpu.models import clip as ref_clip
from libzl_tpu_torch.engine import graphs as graphs_mod
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


def _tone(seconds, freq, audio_data=AudioData):
    t = np.arange(int(SR * seconds)) / SR
    return audio_data(
        (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)[:, None], SR)


# ------------------------------------------------------------ work list

WORK_CASES = [
    # tests/test_torch_buckets.py's four cases: (options, graphs)
    ({}, 2),
    ({"lookahead": 8}, 4),
    ({"fetch": "windows"}, 3),
    ({"lookahead": 8, "fetch": "windows"}, 6),
]


def _reference_work(monkeypatch, kw) -> tuple:
    """(warmed_graphs, the set of (kind, voices, fetch) renders) of the
    reference engine's warmup with `kw`, its render functions spied; every
    render at the one envelope, 4.0 (at V=128 the reference's ladder keeps
    its top rung alone)."""
    kw = dict(kw)
    kw.setdefault("lookahead", 0)
    ref = RefEngine(sample_rate=SR, backend="jax", block_frames=B,
                    num_voices=V, host_core="numpy", **kw)
    calls = set()

    def spy(kind):
        def render(sound, prog, strips, **k):
            assert float(k["max_pitch_ratio"]) == 4.0
            calls.add((kind, prog.shape[0], k["fetch"]))
            out = types.SimpleNamespace(master=np.zeros((B, 2), np.float32))
            return out if kind == "block" else (out,)
        return render

    monkeypatch.setattr(ref_render, "render_block_fused", spy("block"))
    monkeypatch.setattr(ref_render, "render_horizon_onebuf", spy("horizon"))
    monkeypatch.setenv("LIBZL_TPU_WARMUP_JOBS", "1")
    return ref.warmup(), calls


@pytest.mark.parametrize("kw,graphs", WORK_CASES)
def test_warmup_captures_the_reference_work_list(monkeypatch, kw, graphs):
    """warmup() captures one graph per item of the reference's work list
    (bucket, kind, and the gather fallback of a windows engine), and
    warmed_graphs counts them."""
    want_n, want = _reference_work(monkeypatch, kw)
    kw = dict(kw)
    kw.setdefault("lookahead", 0)
    eng = AudioEngine("cpu", sample_rate=SR, block_frames=B, num_voices=V,
                      **kw)
    ClipAudioSource(eng, audio=_tone(0.25, 220.0))
    assert eng.warmup() == graphs == want_n
    keys = eng._graphs.keys()
    assert {(k.kind, k.voices, k.fetch) for k in keys} == want
    assert len(keys) == graphs
    stats = eng.stats()
    assert stats["warmed_graphs"] == stats["graphs"] == graphs
    assert stats["late_captures"] == 0 and stats["graph_replays"] == 0
    # warming again captures nothing more
    assert eng.warmup() == graphs and len(eng._graphs) == graphs


# ------------------------------------------------------------ session

BLOCKS = 240


def _command(cls, clip_id, note, channel, volume=0.8, loop=True, stop=False):
    cmd = cls.channel(clip_id, channel)
    cmd.midi_note = note
    if stop:
        cmd.stop_playback = True
        return cmd
    cmd.change_volume = True
    cmd.volume = volume
    cmd.start_playback = True
    cmd.looping = loop
    cmd.change_looping = loop
    return cmd


def _session(eng, ref: bool, warm: bool = True) -> tuple:
    """The scripted session: (per-block outputs kept alive as returned,
    voices in the densest lane per block, the engine). Events: notes
    (bucket 64), a strips change, a clip load that grows the port's bank,
    a crowd of 80 short one-shots (bucket 128, then back down as they
    end), a pitch over the windows envelope (the gather fallback) and a
    second strips change; clean runs between them engage the horizon and
    its speculative chain."""
    clip_cls = ref_clip.ClipAudioSource if ref else ClipAudioSource
    data = ref_wav.AudioData if ref else AudioData
    cmd_cls = ref_commands.ClipCommand if ref else ClipCommand
    clips = [clip_cls(eng, audio=_tone(0.5, 220.0, data)),
             clip_cls(eng, audio=_tone(0.04, 660.0, data))]
    eng.start_transport(bpm=120)
    if warm:
        eng.warmup()

    def play(clip, note, channel, **kw):
        eng.schedule_clip_command(
            _command(cmd_cls, clip.id, note, channel, **kw), 0)

    script = {
        0: lambda: play(clips[0], 60, 0),
        6: lambda: [play(clips[0], 64 + i, i) for i in range(1, 4)],
        30: lambda: eng.set_strip(1, dry=0.6, pan=-0.4),
        50: lambda: clips.append(clip_cls(eng, audio=_tone(1.0, 330.0,
                                                           data))),
        52: lambda: play(clips[2], 55, 4),
        70: lambda: [play(clips[1], 48 + i % 30, i % 10, loop=False)
                     for i in range(80)],
        130: lambda: play(clips[0], 85, 5),          # ratio 4.24 > 4.0
        150: lambda: play(clips[0], 85, 5, stop=True),
        200: lambda: eng.set_strip(-1, dry=0.8),
    }
    outs, dens = [], []
    for b in range(BLOCKS):
        if b in script:
            script[b]()
        act = eng.pool.active.copy()
        res = eng.process_block()
        outs.append(res.outputs)
        act |= eng.pool.active
        dens.append(int(np.bincount(eng.pool.lane[act], minlength=12).max())
                    if act.any() else 0)
    if not ref:
        eng.drain_speculation()
    return outs, dens, eng


def _port(render_graphs: str):
    eng = AudioEngine("cpu", sample_rate=SR, block_frames=B, num_voices=V,
                      lookahead=4, fetch="windows",
                      render_graphs=render_graphs)
    # a small bank, so the mid-session clip load grows it
    eng.bank = SoundBank(capacity_frames=1 << 16,
                         tail_guard=eng.bank._tail_guard)
    return eng


@pytest.fixture(scope="module")
def sessions():
    on = _session(_port("auto"), ref=False)
    off = _session(_port("off"), ref=False)
    return on, off


def _arrays(outs, field):
    return np.stack([getattr(o, field).numpy() for o in outs])


def test_graph_session_is_bit_equal_to_eager(sessions):
    (on, _, eng), (off, _, eager) = sessions
    for field in RenderOutputs._fields:
        np.testing.assert_array_equal(_arrays(on, field),
                                      _arrays(off, field), err_msg=field)
    assert np.abs(_arrays(on, "master")).max() > 0.05
    stats, eager_stats = eng.stats(), eager.stats()
    assert stats["render_graphs"] == "graphs"
    assert eager_stats["render_graphs"] == "eager"
    # every path of the script ran
    assert eng.fetch_dispatches["gather"] > 0                 # fallback
    assert stats["slo_by_kind"]["adopt"][1] > 0               # spec chain
    assert stats["graph_recaptures"] == stats["graphs"] > 0   # bank grew
    assert eng.bank.capacity_frames > 1 << 16
    keys = eng._graphs.keys()
    assert {k.voices for k in keys} == {64, 128}
    assert {k.bank[0] for k in keys} == {(2, eng.bank.capacity_frames)}
    # every render replayed a graph or captured one mid-session
    renders = sum(eng.render_dispatches.values())
    assert renders == (stats["graph_replays"] + stats["late_captures"]
                       + stats["graph_stale_renders"])
    assert stats["spec_failures"] == 0


def test_graph_outputs_stay_distinct(sessions):
    """A bounce drain holds 32 blocks' outputs at once (capi/bridge.py):
    each is its own clone, and concatenating them gives the eager blocks."""
    (on, _, _), (off, _, _) = sessions
    for start in range(0, BLOCKS - 32, 32):
        window = on[start:start + 32]
        ptrs = {o.master.data_ptr() for o in window}
        assert len(ptrs) == 32
        drained = torch.cat([o.master for o in window])
        want = torch.cat([o.master for o in off[start:start + 32]])
        assert torch.equal(drained, want)


def test_graph_session_matches_reference(sessions):
    """The graph session against the reference jax engine (the gather
    fetch, the same script) at the engine tolerance."""
    (on, dens, _), _ = sessions
    ref = RefEngine(sample_rate=SR, backend="jax", block_frames=B,
                    num_voices=V, lookahead=4, fetch="gather",
                    host_core="numpy")
    want, _, _ = _session(ref, ref=True, warm=False)
    for b in range(BLOCKS):
        np.testing.assert_allclose(
            on[b].voice_peaks.numpy(), np.asarray(want[b].voice_peaks),
            rtol=2e-6, atol=1e-9, err_msg=f"block {b} voice peaks")
        np.testing.assert_allclose(
            on[b].master.numpy(), np.asarray(want[b].master), rtol=1e-5,
            atol=2e-6 * max(dens[b], 1), err_msg=f"block {b} master")


# ------------------------------------------------------------ plumbing


def _key(kind="block", voices=4):
    return graphs_mod.GraphKey(kind, voices, "windows",
                               ((2, 64), "torch.float32"))


def _fake_render(counted: list):
    """A render of a [4, 3] program that launches the fetch twice and the
    mixdown once, and whose outputs depend on the program."""
    def fn(prog):
        fw._count_launch()
        fw._count_launch()
        md._count_launch()
        counted.append(1)
        s = torch.as_tensor(prog).to(torch.float32).sum()
        return RenderOutputs(*(torch.full((2, 3), float(i)) + s
                               for i in range(len(RenderOutputs._fields))))
    return fn


def test_replays_add_the_captured_launches():
    """A capture tallies the kernels its render launches; every replay adds
    that tally to the wrappers' counts and renders the new program."""
    g = graphs_mod.RenderGraphs("cpu")
    bound = object()
    g.rebind(bound)
    calls = []
    fn = _fake_render(calls)
    f0, m0 = fw.fetch_interp.launches, md.lane_mixdown.launches
    prog = np.ones((4, 3), np.int32)
    out, captured = g.render(_key(), fn, prog, bound)
    assert captured and float(out.master[0, 0]) == 12.0
    assert (fw.fetch_interp.launches - f0, md.lane_mixdown.launches - m0) \
        == (2, 1)
    outs = [out]
    for i in range(1, 6):
        out, captured = g.render(_key(), fn, prog * (i + 1), bound)
        assert not captured
        assert fw.fetch_interp.launches - f0 == 2 * (i + 1)
        assert md.lane_mixdown.launches - m0 == i + 1
        outs.append(out)
    assert g.replays == 5 and g.captures == 1 and len(calls) == 6
    # each replay's outputs are their own: the earlier ones are intact
    assert [float(o.master[0, 0]) for o in outs] == \
        [12.0 * (i + 1) for i in range(6)]
    assert float(outs[0].voice_peaks[1, 2]) == 12.0 + 8
    fw.fetch_interp.launches, md.lane_mixdown.launches = f0, m0


def test_horizon_outputs_are_views_of_one_clone():
    g = graphs_mod.RenderGraphs("cpu")
    bound = object()
    g.rebind(bound)

    def fn(prog):
        s = prog.to(torch.float32).sum()
        return tuple(RenderOutputs(*(torch.full((2,), 10.0 * h + i) + s
                                     for i in range(9))) for h in range(3))

    prog = np.zeros((4, 3), np.int32)
    g.render(_key("horizon"), fn, prog, bound)
    outs, _ = g.render(_key("horizon"), fn, prog + 1, bound)
    assert len(outs) == 3 and all(isinstance(o, RenderOutputs) for o in outs)
    assert float(outs[2].lane_mix[0]) == 20.0 + 1 + 12
    base = outs[0].master.untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base
               for o in outs for t in o)


# ------------------------------------------------------ output slots


def _slot_render(horizon: bool):
    """A render of a [4, 3] program whose every output depends on it: a
    block, or a horizon of 2 slices."""
    def one(h, s):
        return RenderOutputs(*(torch.full((2, 3), 10.0 * h + i) + s
                               for i in range(len(RenderOutputs._fields))))

    def fn(prog):
        s = torch.as_tensor(prog).to(torch.float32).sum()
        return (one(0, s), one(1, s)) if horizon else one(0, s)
    return fn


def _flat_of(outs) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in graphs_mod.flatten(outs)])


def _slot_graphs(kind: str):
    g = graphs_mod.RenderGraphs("cpu")
    bound = object()
    g.rebind(bound)
    key = _key(kind)
    fn = _slot_render(kind == "horizon")
    g.render(key, fn, np.zeros((4, 3), np.int32), bound)   # the capture
    return g, key, fn, bound


@pytest.mark.parametrize("hold", ["outputs", "field", "master_slice"])
@pytest.mark.parametrize("kind", ["block", "horizon"])
def test_held_outputs_survive_later_replays(kind, hold):
    """Outputs held (the whole RenderOutputs, or a tuple of them; one field
    alone; a slice of `master`) stay bit-unchanged across three times the
    ring's depth of later replays, while those later replays keep their
    last two outputs alive and drop the rest."""
    g, key, fn, bound = _slot_graphs(kind)
    out, _ = g.render(key, fn, np.full((4, 3), 7, np.int32), bound)
    first = out[-1] if kind == "horizon" else out
    held = {"outputs": out, "field": first.lane_mix,
            "master_slice": first.master[:, 1]}[hold]
    want = (_flat_of(held) if hold == "outputs" else held).clone()
    del out, first
    recent = []
    depth = 0
    i = 0
    while i < 3 * max(depth, 3):
        prog = np.full((4, 3), 100 + i, np.int32)
        got, _ = g.render(key, fn, prog, bound)
        assert torch.equal(_flat_of(got), _flat_of(fn(prog)))
        recent = (recent + [got])[-2:]
        del got
        depth = len(g._entries[key].out.slots)
        i += 1
    now = _flat_of(held) if hold == "outputs" else held
    assert torch.equal(now, want)
    # the held slot, the two kept and one free to write
    assert depth == 4 and g.out_slots == 4 and g.out_slot_fallbacks == 0


@pytest.mark.parametrize("kind", ["block", "horizon"])
def test_dropped_outputs_let_the_ring_reuse_its_slots(kind):
    g, key, fn, bound = _slot_graphs(kind)
    last = None
    for i in range(200):
        prog = np.full((4, 3), i, np.int32)
        last, _ = g.render(key, fn, prog, bound)
        assert torch.equal(_flat_of(last), _flat_of(fn(prog)))
    # the last block's outputs held while the next renders: two slots
    assert g.out_slots == 2 and g.out_slot_fallbacks == 0
    assert g.replays == 200 and g.native_replays == 0


def test_full_ring_falls_back_to_a_clone(monkeypatch):
    """Past OUT_RING_BYTES a replay clones its outputs: counted, bit-equal,
    and held as long as any other's; the ring's slots serve again once
    their outputs are dropped."""
    monkeypatch.setattr(graphs_mod, "OUT_RING_BYTES",
                        3 * 4 * len(RenderOutputs._fields) * 6)
    g, key, fn, bound = _slot_graphs("block")
    held = []
    for i in range(7):
        out, _ = g.render(key, fn, np.full((4, 3), i, np.int32), bound)
        held.append(out)
    assert g.out_slots == 3 and g.out_slot_fallbacks == 4
    for i, out in enumerate(held):
        assert torch.equal(_flat_of(out),
                           _flat_of(fn(np.full((4, 3), i, np.int32))))
    held.clear()
    for i in range(5):
        g.render(key, fn, np.full((4, 3), i, np.int32), bound)
    assert g.out_slots == 3 and g.out_slot_fallbacks == 4


def test_threads_replaying_one_key_keep_their_outputs():
    """Eight threads replay one key at a shortened switch interval, each
    keeping its last three outputs (whole, or one field alone) and
    dropping older ones: every output held stays its own program's."""
    import os
    import sys
    import threading

    g, key, fn, bound = _slot_graphs("horizon")
    failures = []

    def work(t):
        kept = []
        for i in range(60):
            prog = np.full((4, 3), 1000 * t + i, np.int32)
            out, _ = g.render(key, fn, prog, bound)
            kept.append((prog, out if i % 2 else out[1].lane_rms))
            del out
            kept = kept[-3:]
            for p, held in kept:
                want = fn(p)
                ok = (torch.equal(_flat_of(held), _flat_of(want))
                      if isinstance(held, tuple)
                      else torch.equal(held, want[1].lane_rms))
                if not ok:
                    failures.append((t, i))

    n = max(8, (os.cpu_count() or 1) + 1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not failures, failures[:5]
    assert g.replays == 60 * n and g.out_slot_fallbacks == 0
    # each thread holds at most three outputs and renders a fourth
    assert g.out_slots <= 4 * n


def test_unheld_sees_views_fields_and_numpy_arrays():
    """A slot is held while anything outside the ring refers to it: its
    outputs, a field, a view or a numpy array of a field."""
    ring = graphs_mod._OutRing([((2, 3), 6)] * len(RenderOutputs._fields),
                               False, torch.device("cpu"))
    slot = ring.take()
    assert graphs_mod._unheld(slot)
    for make in (lambda: slot.outs, lambda: slot.outs.lane_rms,
                 lambda: slot.outs.master[1:], lambda: slot.outs.master[0],
                 lambda: slot.outs.voice_peaks.numpy(),
                 lambda: slot.outs.strip_dry.reshape(-1)):
        held = make()
        assert not graphs_mod._unheld(slot)
        assert ring.take() is not slot
        del held
        assert graphs_mod._unheld(slot)
    assert len(ring.slots) == 2


def test_chain_replays_bit_equal_to_eager():
    """A 2-shard CPU mesh planned one segment a shard (the chain a mesh
    across cards replays) through the torch path and the output slots,
    with some blocks' outputs kept and the rest dropped: every block
    bit-equal to the same mesh rendering eagerly."""
    def run(render_graphs, chained):
        mesh = make_mesh(devices=["cpu"] * 2)
        eng = AudioEngine("cpu", sample_rate=SR, block_frames=B,
                          num_voices=32, lookahead=0, mesh=mesh,
                          render_graphs=render_graphs)
        if chained:
            eng._graphs = graphs_mod.RenderGraphs(
                mesh.devices[0],
                [(d, i, 1) for i, d in enumerate(mesh.devices)])
        clip = ClipAudioSource(eng, audio=_tone(0.3, 280.0))
        eng.start_transport(bpm=120)
        for ch in range(5):
            eng.schedule_clip_command(
                _command(ClipCommand, clip.id, 50 + 4 * ch, ch), 0)
        eng.warmup()
        kept, flats = [], []
        for b in range(40):
            outs = eng.process_block().outputs
            flats.append(_flat_of(outs).clone())
            if b % 3 == 0:
                kept.append(outs)
        return kept, flats, eng

    kept, flats, eng = run("auto", True)
    want_kept, want_flats, _ = run("off", False)
    for b, (got, want) in enumerate(zip(flats, want_flats)):
        assert torch.equal(got, want), f"block {b}"
    for got, want in zip(kept, want_kept):
        assert torch.equal(_flat_of(got), _flat_of(want))
    stats = eng.stats()
    assert stats["graph_segments"] == 2 and stats["graph_replays"] >= 39
    assert stats["native_replays"] == 0
    assert 0 < stats["out_slots"] < 40 and stats["out_slot_fallbacks"] == 0
    assert np.abs(torch.stack(want_flats).numpy()).max() > 0.05


def test_replay_is_none_without_a_live_graph():
    """`replay` replays a captured key as `render` does, and returns None
    for a key never captured or dropped by a rebind (the engine then
    builds the render and calls `render`)."""
    g, key, fn, bound = _slot_graphs("block")
    prog = np.full((4, 3), 3, np.int32)
    assert g.replay(_key(voices=8), prog) is None
    assert torch.equal(_flat_of(g.replay(key, prog)), _flat_of(fn(prog)))
    assert g.replays == 1
    g.rebind(object())
    assert g.replay(key, prog) is None and g.replays == 1


def test_capture_failure_raises_and_keeps_no_graph():
    g = graphs_mod.RenderGraphs("cpu")
    bound = object()
    g.rebind(bound)

    def broken(prog):
        raise RuntimeError("render failed")

    with pytest.raises(RuntimeError, match="render failed"):
        g.render(_key(), broken, np.zeros((4, 3), np.int32), bound)
    assert len(g) == 0 and g.captures == 0


def test_captures_hold_off_the_garbage_collector():
    """Collecting an orphaned engine's graphs destroys them, which a
    capturing stream does not permit: the collector stays off while any
    capture is under way (nested, or on two threads) and comes back to its
    state before after the last."""
    import gc

    assert gc.isenabled()
    with graphs_mod._no_gc():
        assert not gc.isenabled()
        with graphs_mod._no_gc():
            assert not gc.isenabled()
        assert not gc.isenabled()
    assert gc.isenabled()
    gc.disable()
    try:
        with graphs_mod._no_gc():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_stale_render_runs_once_without_a_graph():
    """A render prepared for inputs the graphs no longer read (the bank
    grew meanwhile) runs once as it is: nothing is captured for it."""
    g = graphs_mod.RenderGraphs("cpu")
    old, new = object(), object()
    g.rebind(new)
    calls = []
    out, captured = g.render(_key(), _fake_render(calls),
                             np.ones((4, 3), np.int32), old)
    assert not captured and len(g) == 0 and g.stale == 1
    assert float(out.master[0, 0]) == 12.0 and len(calls) == 1


def test_rebind_recaptures_every_graph():
    g = graphs_mod.RenderGraphs("cpu")
    first, second = object(), object()
    g.rebind(first)
    calls = []
    prog = np.full((4, 3), 2, np.int32)
    g.render(_key(), _fake_render(calls), prog, first)
    seen = []

    def recapture(key, cols):
        seen.append((key, cols))
        return key._replace(bank=((2, 128), "torch.float32")), \
            _fake_render(calls)

    assert g.rebind(second, recapture) == 1
    assert seen == [(_key(), 3)] and g.recaptures == 1
    (key,) = g.keys()
    assert key.bank[0] == (2, 128)
    # recaptured on the graph's last program
    out, captured = g.render(key, _fake_render(calls), prog, second)
    assert not captured and float(out.master[0, 0]) == 24.0


def test_render_graphs_option():
    with pytest.raises(ValueError, match="render_graphs"):
        AudioEngine("cpu", num_voices=16, render_graphs="banana")
    assert AudioEngine("cpu", num_voices=16).stats()["render_graphs"] == \
        "graphs"
    assert AudioEngine("cpu", num_voices=16, render_graphs="off").stats()[
        "render_graphs"] == "eager"
    # a mesh of k > 1 replays graphs too: one segment on one device
    mesh = AudioEngine("cpu", num_voices=16,
                       mesh=make_mesh(devices=["cpu"] * 2))
    assert mesh.stats()["render_graphs"] == "graphs"
    assert mesh.stats()["graph_segments"] == 1
    assert mesh._graphs is not None


# ------------------------------------------------------ configurations

CONFIGS = [
    dict(lookahead=0),
    dict(lookahead=0, fetch="windows"),
    dict(lookahead=4),
    dict(lookahead=4, fetch="windows", bank_dtype="int16"),
    dict(lookahead=0, quirk_gain=True),
    dict(lookahead=4, fetch="windows", voice_buckets="off"),
    dict(lookahead=4, host_core="numpy"),
    dict(lookahead=2, block_frames=256),
]


def _short_session(render_graphs: str, opts: dict, blocks: int = 48):
    """A 96-voice engine with `opts`: notes, a strips change, a clip load
    and a note-off; the outputs of every block, kept alive."""
    opts = dict(opts)
    eng = AudioEngine("cpu", sample_rate=SR, num_voices=96,
                      render_graphs=render_graphs,
                      block_frames=opts.pop("block_frames", B), **opts)
    clip = ClipAudioSource(eng, audio=_tone(0.3, 250.0))
    eng.start_transport(bpm=120)
    eng.warmup()

    def play(clip, note, channel, **kw):
        eng.schedule_clip_command(
            _command(ClipCommand, clip.id, note, channel, **kw), 0)

    script = {
        0: lambda: [play(clip, 57 + 3 * i, i) for i in range(6)],
        12: lambda: eng.set_strip(3, wet1=0.4, pan=0.5),
        20: lambda: play(ClipAudioSource(eng, audio=_tone(0.2, 410.0)),
                         62, 7),
        34: lambda: play(clip, 60, 1, stop=True),
    }
    outs = []
    for b in range(blocks):
        if b in script:
            script[b]()
        outs.append(eng.process_block().outputs)
    eng.drain_speculation()
    return outs, eng


@pytest.mark.parametrize("opts", CONFIGS, ids=lambda o: ",".join(
    f"{k}={v}" for k, v in o.items()))
def test_configuration_graphs_equal_eager(opts):
    """Each engine option through graphs and eagerly: every output field
    of every block bit-equal, every render a replay or a capture."""
    on, eng = _short_session("auto", opts)
    off, _ = _short_session("off", opts)
    for field in RenderOutputs._fields:
        np.testing.assert_array_equal(_arrays(on, field),
                                      _arrays(off, field), err_msg=field)
    assert np.abs(_arrays(on, "master")).max() > 0.01
    stats = eng.stats()
    assert sum(eng.render_dispatches.values()) == (
        stats["graph_replays"] + stats["late_captures"]
        + stats["graph_stale_renders"])
    assert stats["graphs"] >= stats["warmed_graphs"] > 0


@pytest.mark.parametrize("fetch,bank_dtype", [
    ("gather", "float32"), ("gather", "int16"),
    ("windows", "float32"), ("windows", "int16")])
def test_graph_keys_name_the_bank(fetch, bank_dtype):
    """A key carries the device bank's shape and dtype; the layout (planar
    for the windows fetch, interleaved for the gather) is in the shape."""
    eng = AudioEngine("cpu", sample_rate=SR, block_frames=B, num_voices=V,
                      fetch=fetch, bank_dtype=bank_dtype)
    ClipAudioSource(eng, audio=_tone(0.1, 300.0))
    eng.warmup()
    (bank,) = eng._device_sound_data.values()
    layout = "planar" if fetch == "windows" else "interleaved"
    assert bank.shape == ((2, eng.bank.capacity_frames) if layout == "planar"
                          else (eng.bank.capacity_frames, 2))
    assert {k.bank for k in eng._graphs.keys()} == {
        (tuple(bank.shape), str(bank.dtype))}
    assert str(bank.dtype) == f"torch.{bank_dtype}"


def test_graph_key_holds_only_what_varies():
    """A key is (kind, voices, fetch, bank): a warmed horizon engine's keys
    carry the bank's (shape, dtype) and none of the engine's constants (H,
    quirk_gain, the bank's layout, the pitch envelope)."""
    assert graphs_mod.GraphKey._fields == ("kind", "voices", "fetch", "bank")
    eng = AudioEngine("cpu", sample_rate=SR, block_frames=B, num_voices=V,
                      lookahead=4, fetch="windows", max_pitch_ratio=3.0)
    ClipAudioSource(eng, audio=_tone(0.1, 300.0))
    eng.warmup()
    (bank,) = eng._device_sound_data.values()
    keys = eng._graphs.keys()
    assert {k.bank for k in keys} == {(tuple(bank.shape), str(bank.dtype))}
    kinds = ("block", "horizon")
    assert {(k.kind, k.voices, k.fetch) for k in keys} == {
        (kind, n, "windows") for kind in kinds for n in (64, 128)} | {
        (kind, V, "gather") for kind in kinds}
    for k in keys:
        assert 4 not in k and 3.0 not in k and "planar" not in k.bank


@pytest.mark.parametrize("suffix", ["", ":grid", ":default,c64", ":g16,loop"])
def test_windows_suffix_is_one_engine(suffix):
    """A windows suffix only steers the reference's TPU schedule: an engine
    built with any valid one is a "windows" engine, warms the same graph
    keys as the plain "windows" engine and renders its bits."""
    engines = []
    for fetch in ("windows", "windows" + suffix):
        eng = AudioEngine("cpu", sample_rate=SR, block_frames=B,
                          num_voices=V, lookahead=4, fetch=fetch)
        clip = ClipAudioSource(eng, audio=_tone(0.2, 300.0))
        eng.start_transport(bpm=120)
        eng.warmup()
        for i, note in enumerate((60, 67, 79)):
            eng.schedule_clip_command(
                _command(ClipCommand, clip.id, note, i), 0)
        engines.append(eng)
    plain, other = engines
    assert other.fetch == "windows"
    (bank,) = other._device_sound_data.values()
    bank = (tuple(bank.shape), str(bank.dtype))
    want = {graphs_mod.GraphKey(kind, n, "windows", bank)
            for kind in ("block", "horizon") for n in (64, 128)}
    want |= {graphs_mod.GraphKey(kind, V, "gather", bank)
             for kind in ("block", "horizon")}
    assert set(other._graphs.keys()) == set(plain._graphs.keys()) == want
    for b in range(12):
        want = plain.process_block().outputs
        got = other.process_block().outputs
        for field in RenderOutputs._fields:
            np.testing.assert_array_equal(
                getattr(got, field).numpy(), getattr(want, field).numpy(),
                err_msg=f"block {b} {field}")
    for eng in engines:
        eng.drain_speculation()
    assert other.fetch_dispatches["windows"] > 0
    assert other.stats()["late_captures"] == 0


@pytest.mark.parametrize("lookahead", [0, 4])
def test_over_envelope_renders_the_full_pool(lookahead):
    """A sparse session whose pitch leaves the envelope renders the whole
    pool through the gather fetch (the fallback's one bucket), and back at
    the smallest bucket through windows once the note stops: both keys
    were warmed, so neither is a late capture."""
    eng = AudioEngine("cpu", sample_rate=SR, block_frames=B, num_voices=V,
                      lookahead=lookahead, fetch="windows")
    clip = ClipAudioSource(eng, audio=_tone(0.3, 300.0))
    eng.start_transport(bpm=120)
    eng.warmup()
    seen = []
    real = eng._render

    def spy(kind, fetch, prog, *a, **k):
        seen.append((fetch, prog.shape[0]))
        return real(kind, fetch, prog, *a, **k)

    eng._render = spy
    eng.schedule_clip_command(_command(ClipCommand, clip.id, 86, 0), 0)
    for _ in range(6):
        eng.process_block()
    eng.drain_speculation()
    assert set(seen) == {("gather", V)}
    seen.clear()
    eng.schedule_clip_command(
        _command(ClipCommand, clip.id, 86, 0, stop=True), 0)
    eng.schedule_clip_command(_command(ClipCommand, clip.id, 67, 1), 0)
    # the stopped voice's release ends within 20 blocks
    for _ in range(30):
        eng.process_block()
    eng.drain_speculation()
    assert ("windows", 64) in seen and ("gather", 64) not in seen
    assert eng.stats()["late_captures"] == 0


@pytest.mark.parametrize("render_graphs", ["auto", "off"])
def test_bank_and_strips_stay_in_place(render_graphs):
    """A new bank version within the capacity and a strips change are
    written into the same device tensors (a graph reads them where they
    lay at capture); a bank that outgrows its capacity is a new tensor,
    and every graph is captured again on it."""
    eng = AudioEngine("cpu", sample_rate=SR, block_frames=B, num_voices=V,
                      render_graphs=render_graphs)
    eng.bank = SoundBank(capacity_frames=1 << 15,
                         tail_guard=eng.bank._tail_guard)
    ClipAudioSource(eng, audio=_tone(0.1, 300.0))
    eng.warmup()
    (bank,) = eng._device_sound_data.values()
    strips = eng._packed_strips_for_backend()
    ClipAudioSource(eng, audio=_tone(0.1, 500.0))
    eng.set_strip(0, dry=0.25)
    (same,) = eng._sound_data_for_backend().values()
    assert same is bank
    assert eng._packed_strips_for_backend() is strips
    np.testing.assert_array_equal(bank.numpy(), eng.bank.data.T)
    assert float(strips[0, 1]) == pytest.approx(0.25)
    graphs = eng.stats()["graphs"]
    ClipAudioSource(eng, audio=_tone(0.5, 700.0))     # outgrows 1 << 15
    (grown,) = eng._sound_data_for_backend().values()
    assert grown is not bank
    assert grown.shape == (eng.bank.capacity_frames, 2)   # interleaved
    stats = eng.stats()
    assert stats["graph_recaptures"] == graphs
    assert stats["graphs"] == graphs
    if render_graphs == "auto":
        assert graphs > 0
        assert {k.bank[0] for k in eng._graphs.keys()} == {
            tuple(grown.shape)}


def test_stage_rejects_a_program_of_another_shape():
    g = graphs_mod.RenderGraphs("cpu")
    bound = object()
    g.rebind(bound)
    g.render(_key(), _fake_render([]), np.ones((4, 3), np.int32), bound)
    with pytest.raises(ValueError, match="program"):
        g.render(_key(), _fake_render([]), np.ones((4, 5), np.int32), bound)


# ------------------------------------------------------- launch tally


def test_recording_tallies_instead_of_counting():
    from libzl_tpu_torch.ops import launch_tally

    f0, m0 = fw.fetch_interp.launches, md.lane_mixdown.launches
    with launch_tally.recording() as outer:
        fw._count_launch()
        with launch_tally.recording() as inner:
            md._count_launch()
            md._count_launch()
        fw._count_launch()
    fw._count_launch()
    assert dict(outer) == {"fetch_interp": 2}
    assert dict(inner) == {"lane_mixdown": 2}
    assert fw.fetch_interp.launches - f0 == 1
    assert md.lane_mixdown.launches == m0
    fw.fetch_interp.launches = f0


def test_recording_is_per_thread():
    """A capture on one thread (CUDA's "thread_local" capture mode) leaves
    the launches other threads make counted."""
    import threading

    from libzl_tpu_torch.ops import launch_tally

    f0 = fw.fetch_interp.launches
    with launch_tally.recording() as tally:
        t = threading.Thread(
            target=lambda: [fw._count_launch() for _ in range(7)])
        t.start()
        t.join(timeout=30)
        fw._count_launch()
    assert fw.fetch_interp.launches - f0 == 7
    assert dict(tally) == {"fetch_interp": 1}
    fw.fetch_interp.launches = f0


# ------------------------------------------------------ C ABI, meshes


@pytest.mark.parametrize("drain", [1, 32])
def test_bridge_stream_graphs_equal_eager(drain):
    """The C ABI runtime's delivered stream with graphs and eagerly, with
    per-block delivery and a 32-block bounce drain (32 blocks' masters
    concatenated in one torch.cat): bit-equal."""
    from libzl_tpu_torch.capi.bridge import EngineRuntime
    from libzl_tpu_torch.io.sinks import AudioSink

    class Capture(AudioSink):
        pacing = False

        def __init__(self):
            self.blocks = []

        def write(self, block):
            self.blocks.append(np.array(block))

    streams = {}
    for mode in ("auto", "off"):
        rt = EngineRuntime(SR, B, 64, device="cpu", bounce_drain=drain,
                           render_graphs=mode)
        sink = Capture()
        rt.set_sink(sink)
        clip = ClipAudioSource(rt.engine, audio=_tone(0.4, 330.0))
        rt.engine.start_transport(bpm=120)
        for ch in range(3):
            rt.engine.schedule_clip_command(
                _command(ClipCommand, clip.id, 55 + 5 * ch, ch), 0)
        rt.step_blocks(70)
        rt.engine.drain_speculation()
        assert rt.engine.stats()["render_graphs"] == (
            "graphs" if mode == "auto" else "eager")
        streams[mode] = np.concatenate(sink.blocks)
    assert streams["auto"].shape == (70 * B, 2)
    np.testing.assert_array_equal(streams["auto"], streams["off"])
    assert np.abs(streams["auto"]).max() > 0.05


@pytest.mark.parametrize("value,mode", [("off", "eager"),
                                        ("auto", "graphs")])
def test_render_graphs_env(monkeypatch, value, mode):
    from libzl_tpu_torch.capi import bridge

    for k, v in dict(LIBZL_TPU_BACKEND="cpu", LIBZL_TPU_VOICES="8",
                     LIBZL_TPU_NO_PUMP="1",
                     LIBZL_TPU_RENDER_GRAPHS=value).items():
        monkeypatch.setenv(k, v)
    bridge.init_engine()
    try:
        eng = bridge._rt().engine
        assert eng.render_graphs == value
        assert eng.stats()["render_graphs"] == mode
    finally:
        bridge.shutdown_engine()


def test_render_graphs_env_rejects_other_values(monkeypatch):
    from libzl_tpu_torch.capi import bridge

    for k, v in dict(LIBZL_TPU_BACKEND="cpu", LIBZL_TPU_VOICES="8",
                     LIBZL_TPU_NO_PUMP="1",
                     LIBZL_TPU_RENDER_GRAPHS="banana").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="render_graphs"):
        bridge.init_engine()
    assert bridge._runtime is None


@pytest.mark.parametrize("k", [2, 4])
def test_mesh_replays_graphs_and_stays_bit_equal(k):
    """A k-shard mesh replays render graphs, as the unsharded engine does,
    and stays bit-equal to it."""
    def run(mesh):
        eng = AudioEngine("cpu", sample_rate=SR, block_frames=B,
                          num_voices=32, lookahead=4, mesh=mesh)
        clip = ClipAudioSource(eng, audio=_tone(0.3, 280.0))
        eng.start_transport(bpm=120)
        for ch in range(5):
            eng.schedule_clip_command(
                _command(ClipCommand, clip.id, 50 + 4 * ch, ch), 0)
        outs = [eng.process_block().outputs for _ in range(30)]
        eng.drain_speculation()
        return outs, eng

    sharded, mesh_eng = run(make_mesh(devices=["cpu"] * k))
    plain, eng = run(None)
    assert mesh_eng.stats()["render_graphs"] == "graphs"
    assert mesh_eng.stats()["graph_replays"] > 0
    assert eng.stats()["render_graphs"] == "graphs"
    assert eng.stats()["graph_replays"] > 0
    for field in RenderOutputs._fields:
        np.testing.assert_array_equal(_arrays(sharded, field),
                                      _arrays(plain, field), err_msg=field)
