"""The inputs repeat for a seed and differ between seeds."""

import numpy as np

from zlbench import session, spec
from zlbench.tests.tiny import KEYS

CFG = dict(spec.load_cell("live-loops").config, clips=4, clip_bars=[1, 2])
NOTES = KEYS["notes"]
SEEDS = (2 ** 31 + 7, 2 ** 33 + 1)


def test_clips_repeat_for_a_seed_and_differ_between_seeds():
    a = session.make_clips(CFG, SEEDS[0], "cpu")
    b = session.make_clips(CFG, SEEDS[0], "cpu")
    c = session.make_clips(CFG, SEEDS[1], "cpu")
    assert all(np.array_equal(x.audio, y.audio) for x, y in zip(a, b))
    assert not all(x.audio.shape == y.audio.shape
                   and np.array_equal(x.audio, y.audio)
                   for x, y in zip(a, c))
    # every seed holds the same bar lengths, in another order
    assert sorted(x.bars for x in a) == sorted(x.bars for x in c)
    assert all(x.audio.dtype == np.float32 and x.audio.shape[1] == 2
               for x in a)


def test_loop_plan_repeats_and_differs():
    a = session.loop_plan(64, 4, SEEDS[0])
    assert a == session.loop_plan(64, 4, SEEDS[0])
    assert a != session.loop_plan(64, 4, SEEDS[1])


def test_no_two_loop_starts_coalesce():
    """Start commands of one clip, channel and note would merge into one
    voice: the cells' plans have none (nor the tiny cells' 20 voices)."""
    for cell in (w["name"] for w in spec.load_benchmark()["workloads"]):
        c = spec.load_cell(cell)
        for count, clips in ((c.traffic["loop_voices"], c.config["clips"]),
                             (20, 4)):
            for seed in SEEDS:
                plan = session.loop_plan(count, clips, seed)
                assert len({(v.clip, v.channel, v.note) for v in plan}) \
                    == len(plan)


def test_note_stream_repeats_and_differs():
    a = session.note_stream(NOTES, 10.0, 128 / 48000, SEEDS[0])
    assert a == session.note_stream(NOTES, 10.0, 128 / 48000, SEEDS[0])
    b = session.note_stream(NOTES, 10.0, 128 / 48000, SEEDS[1])
    assert a != b and len(a) == len(b) == 200
    for n in a:
        assert 36 <= n.pitch <= 96 and n.off_block > n.on_block


def test_keys_clips_never_share_a_loop_pair():
    loops = session.loop_plan(960, 64, SEEDS[0])
    pairs = {(v.clip, v.channel) for v in loops}
    for ch in range(session.NUM_CHANNELS):
        assert (session.keys_clip(ch, 64), ch) not in pairs
