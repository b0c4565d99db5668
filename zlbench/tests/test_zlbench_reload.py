"""`Reload` in the plain reference (a clip's playback swapped for a new
buffer: live voices keep their positions and stops, reads past the new end
are silent, later starts read the new buffer), and the harness's check
through a tiny run whose timed window reloads a clip through the port."""

import time

import numpy as np
import pytest

from zlbench import check, harness, reference, run
from zlbench.tests import reload_kind
from zlbench.tests.tiny import KEYS, tiny_cell

# a beat is 2400 frames: 4800 frames are a two-beat loop
CFG = {"block_frames": 64, "sample_rate": 4800, "bpm": 120,
       "adsr": [0.0, 0.1, 1.0, 0.05], "root_note": 60, "clip_volume": 1.0,
       "strip0": [1.0, 0.0, 0.0]}
OLD = 4800
RELOAD_AT = 20
LAST = 85


def _audio(n: int, seed: int) -> np.ndarray:
    a = np.random.default_rng(seed).uniform(-0.5, 0.5, (n, 2))
    return a.astype(np.float32)


def _pads(new: np.ndarray):
    """A pad that reloads clip 0 with `new` at RELOAD_AT, and its twin that
    never reloads but whose bank, from RELOAD_AT on, holds `new`, cut or
    zero-padded to the old length, where clip 0's was: where the reload
    keeps every position and stop, the two render alike, but for reads past
    the new end."""
    clips = [_audio(OLD, 1), _audio(2400, 2)]
    starts = [reference.Start(0, 0, 0, 0, 0, 55, 0.8, True),
              reference.Start(0, 0, 0, 1, 2, 57, 0.5, True),
              reference.Start(10, 10, 0, 0, 1, 58, 0.9, False)]
    later = [reference.Start(RELOAD_AT + 5, 3, 0, 0, 3, 60, 0.7, False)]
    reload = reference.Reload(RELOAD_AT, 0, new)
    events = reference.effect_order(starts + later + [reload])
    fitted = np.zeros((OLD, 2), np.float32)
    fitted[:min(OLD, len(new))] = new[:OLD]
    twin_events = [e for e in events if e is not reload]
    return ((reference.Sketchpad(CFG, [len(c) for c in clips], 8),
             reference.reference_bank(
                 reference.bank_buffers(clips, events), "cpu"), events),
            (reference.Sketchpad(CFG, [len(c) for c in clips], 8),
             (reference.reference_bank(clips, "cpu"),
              reference.reference_bank([fitted, clips[1]], "cpu")),
             twin_events))


def _step(pad, bank_offsets, events, b):
    for ev in events:
        if ev.block == b:
            if isinstance(ev, reference.Start):
                pad.start(ev)
            elif isinstance(ev, reference.Reload):
                pad.reload(ev)
    p = pad.plan()
    master = reference.render(pad, p, *bank_offsets, (1.0, 0.0, 0.0),
                              "cpu").numpy()
    frames = pad.frames_of_block(p)
    pad.advance(p)
    return master, frames


# the new buffer's last frame is 0, as the twin's zero padding after it
SHORTER = np.concatenate([_audio(799, 3), np.zeros((1, 2), np.float32)])
LONGER = _audio(7000, 4)


@pytest.mark.parametrize("new", [SHORTER, LONGER], ids=["shorter",
                                                        "longer"])
def test_reload_keeps_positions_and_reads_the_new_buffer(new):
    (pad, bank, events), (twin, twin_banks, twin_events) = _pads(new)
    n = len(new)
    silent = heard = 0
    for b in range(LAST):
        m, (pos, alpha, valid, gain) = _step(pad, bank, events, b)
        tm, (tpos, talpha, tvalid, tgain) = _step(
            twin, twin_banks[b >= RELOAD_AT], twin_events, b)
        # positions, stops and gains never part
        assert np.array_equal(pos, tpos) and np.array_equal(alpha, talpha)
        assert np.array_equal(pad.stop, twin.stop)
        assert np.array_equal(gain, tgain)
        np.testing.assert_allclose(m, tm, rtol=0, atol=1e-12)
        if b < RELOAD_AT:
            assert np.array_equal(valid, tvalid)
            continue
        # clip 0's voices read the new length: past its end, silence
        ours = (pad.clip == 0)[:, None] & pad.active[:, None]
        want = tvalid & (~ours | (pos < n - 1))
        assert np.array_equal(valid, want)
        past = ours & tvalid & (pos >= n - 1)
        silent += int(past.sum())
        heard += int((ours & valid).sum())
    # the later start of clip 0 read the new length, with the old stop
    v = int(np.flatnonzero(pad.active & (pad.note == 60))[0])
    assert pad.length[v] == n and pad.stop[v] == OLD
    assert heard > 0
    if n < OLD:
        # the loop (position ~959 at the reload) read past the end until
        # its restart at block 75, then read again
        assert silent > 0


def test_reload_regions_cover_every_buffer():
    clips = [_audio(100, 5), _audio(60, 6)]
    events = [reference.Reload(3, 1, _audio(40, 7)),
              reference.Reload(5, 0, _audio(250, 8)),
              reference.Reload(9, 1, _audio(10, 9))]
    buffers = reference.bank_buffers(clips, events)
    assert [len(b) for b in buffers] == [100, 60, 40, 250, 10]
    for lower in (False, True):
        bank, offsets = reference.reference_bank(buffers, "cpu", lower)
        assert bank.shape == (460, 2)
        assert list(offsets) == [0, 100, 160, 200, 450]
        for b, o in zip(buffers, offsets):
            want = torch_round(b) if lower else b
            assert np.array_equal(bank[o:o + len(b)].numpy(), want)
    pad = reference.Sketchpad(CFG, [100, 60], 4)
    for e in events:
        pad.reload(e)
    assert list(pad.region) == [3, 4]
    assert [pad.region_frames[r] for r in pad.region] == [250, 10]
    assert pad.region_frames == [100, 60, 40, 250, 10]


def torch_round(a: np.ndarray) -> np.ndarray:
    import torch
    return torch.as_tensor(a).to(torch.bfloat16).float().numpy()


def test_reload_blocks_are_sampled_with_the_blocks_around():
    blocks = {40, 70, 90, 110, 150, 180}
    events = [reference.Reload(b, 0, SHORTER) for b in sorted(blocks)]
    picks = set(check.sample_blocks(3, 30, 170, events, []))
    drawn = picks & blocks
    assert len(drawn) == check.RELOAD_BLOCKS
    assert picks == {30, 199} | {b + d for b in drawn for d in (-1, 0, 1)}
    keep = check.keep_rule(3, 30, {44, 45})
    assert keep(30) and keep(44) and keep(45)


def test_a_reload_takes_effect_before_its_blocks_starts():
    start = reference.Start(4, 0, 0, 0, 0, 60, 1.0, False)
    reload = reference.Reload(4, 0, SHORTER)
    stop = reference.Stop(3, 10, 0, 0, 60)
    assert reference.effect_order([start, reload, stop]) == [stop, reload,
                                                             start]


# the tiny live cell on the horizon path (lookahead "auto": H=16 on the
# CPU at 128 frames) and the tiny live-seq cell on the card's per-block
# path, with live notes on the reloaded clip
PATHS = {"horizon": ("live-loops", KEYS, None),
         "per-block": ("live-seq-b256", None, 0)}
SEED = 2 ** 31 + 2345


def _run(path: str, frames: int, late: int = 0, control: bool = False,
         seed: int = SEED):
    name, traffic, lookahead = PATHS[path]
    cell = tiny_cell(name, traffic=traffic)
    if lookahead is not None:
        cell.config["runtime"] = dict(cell.config["runtime"],
                                      lookahead=lookahead)
    cell.kinds.append(("reload", reload_kind,
                       {"block": 40, "clip": 0, "frames": frames,
                        "late": late}))
    return run.run_cell(cell, seed, 0.4, False, "cpu", time.perf_counter(),
                        harness.process_age_s(), control=control)


# 4800 frames: the loops of clip 0 are past it at the reload (~0.16 s in,
# at rates 0.5-0.63), its fast notes too; 300000 outgrow every clip's
# region, so the bank appends one
FRAMES = {"shorter": 4800, "longer": 300_000}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("size", sorted(FRAMES))
def test_reload_through_the_port_is_correct(path, size):
    line, checks, _ = _run(path, FRAMES[size])
    assert line["correct"], checks
    assert line["failed"] == 0


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("size", sorted(FRAMES))
@pytest.mark.parametrize("late", [1, -1], ids=["late", "early"])
def test_reload_told_one_block_off_is_not_correct(path, size, late):
    line, checks, _ = _run(path, FRAMES[size], late=late)
    assert not line["correct"], checks


def test_reload_control_fails():
    _, checks, _ = _run("horizon", FRAMES["shorter"], control=True)
    c = checks["control_gap"]
    assert c["value"] > c["limit"], c


@pytest.mark.parametrize("late", [1, -1], ids=["late", "early"])
def test_the_blocks_around_a_reload_catch_one_block_off(monkeypatch, late):
    """With no block drawn at random (at a cell's size few are near the
    reload), the blocks sampled around it alone still fail the run."""
    monkeypatch.setattr(check, "RANDOM_BLOCKS", 0)
    line, checks, _ = _run("per-block", FRAMES["longer"])
    assert line["correct"], checks
    line, checks, _ = _run("per-block", FRAMES["longer"], late=late)
    assert not line["correct"], checks
