"""The engine's record of applied re-renders and its counters and spans.

`AudioEngine.reload_clip_sound` (a synchronous reload, and the deferred
render worker's swap at a block's start alike) appends (the block it takes
effect at, the clip's id, the clip's render generation) to
`applied_renders`, which keeps the last RENDER_RECORD_KEEP, and counts
`renders_applied` in stats(). A render superseded by a newer change is
never applied, so never recorded. The swap is span `render_swap` inside
`commands`, the bank's refresh span `bank_upload`, and the worker's render
span `clip_render` on the clip's engine's profiler, on the worker's thread
("render" in the span record).
"""

import time

import numpy as np
import pytest

from libzl_tpu_torch.engine.engine import AudioEngine
from libzl_tpu_torch.io.wav import AudioData
from libzl_tpu_torch.models.clip import ClipAudioSource
from libzl_tpu_torch.utils import profiling

SR = 48000
B = 256


def _session(**kw):
    eng = AudioEngine("cpu", sample_rate=SR, block_frames=B, num_voices=16,
                      lookahead=0, **kw)
    rng = np.random.default_rng(3)
    clip = ClipAudioSource(eng, audio=AudioData(
        rng.uniform(-0.5, 0.5, (24_000, 2)).astype(np.float32), SR))
    clip.play(loop=True, midi_channel=0)
    eng.start_transport(bpm=120)
    for _ in range(3):
        eng.process_block()
    return eng, clip


def _wait_for_render(eng, timeout=30.0):
    """Until the render worker has handed the engine a finished render."""
    t0 = time.monotonic()
    while not eng._pending_renders:
        assert time.monotonic() - t0 < timeout, "the render never finished"
        time.sleep(0.005)


def test_a_synchronous_reload_is_recorded_at_the_next_block():
    eng, clip = _session()
    assert list(eng.applied_renders) == []
    clip.set_pitch(2.0)
    assert list(eng.applied_renders) == [(3, clip.id, 1)]
    clip.set_speed_ratio(0.9)
    eng.process_block()
    assert list(eng.applied_renders) == [(3, clip.id, 1), (3, clip.id, 2)]
    stats = eng.stats()
    assert stats["renders_applied"] == 2
    assert stats["bank_uploads_partial"] == 1   # both in one refresh


def test_a_deferred_render_is_recorded_at_the_block_that_swaps_it():
    eng, clip = _session()
    clip.set_speed_ratio(0.85, defer=True)
    eng.process_block()     # block 3: the worker has not finished
    _wait_for_render(eng)
    assert list(eng.applied_renders) == []
    eng.process_block()     # block 4 swaps it in at its start
    assert list(eng.applied_renders) == [(4, clip.id, 1)]
    assert clip.slot.length == round(24_000 / 0.85)
    totals = eng.profiler.totals()
    assert totals["render_swap"]["count"] == 1
    assert totals["clip_render"]["count"] == 1
    # the first upload (block 0) and the swap's
    assert totals["bank_upload"]["count"] == 2
    assert eng.stats()["renders_applied"] == 1


def test_a_superseded_render_is_never_applied():
    eng, clip = _session()
    clip.set_pitch(1.0, defer=True)
    clip.set_pitch(2.0, defer=True)
    clip.set_pitch(3.0, defer=True)
    for _ in range(200):
        eng.process_block()
        if eng.applied_renders:
            break
        time.sleep(0.005)
    for _ in range(20):     # any stale render still in flight
        time.sleep(0.01)
        eng.process_block()
    assert list(eng.applied_renders) == [
        (eng.applied_renders[0][0], clip.id, 3)]
    assert clip._render_generation == 3
    assert eng.stats()["renders_applied"] == 1


def test_the_record_keeps_the_last_ones(monkeypatch):
    monkeypatch.setattr(AudioEngine, "RENDER_RECORD_KEEP", 3)
    eng, clip = _session()
    for p in range(1, 6):
        clip.set_pitch(float(p))
    assert [g for _, _, g in eng.applied_renders] == [3, 4, 5]
    assert eng.stats()["renders_applied"] == 5


def test_the_render_span_is_on_the_worker_thread():
    eng, clip = _session()
    profiling.start_recording(4096)
    try:
        since = profiling.mark()
        clip.set_gain(-3.0, defer=True)
        _wait_for_render(eng)
        eng.process_block()
    finally:
        profiling.stop_recording()
    spans = profiling.export(since)["spans"]
    by_name = {s["name"]: s for s in spans}
    assert by_name["clip_render"]["thread"] == "render"
    assert by_name["render_swap"]["thread"] == "engine"
    assert by_name["render_swap"]["parent"] == by_name["commands"]["id"]
    assert by_name["bank_upload"]["thread"] == "engine"


@pytest.mark.parametrize("defer", [False, True])
def test_no_span_and_no_record_without_a_render(defer):
    eng, clip = _session()
    for _ in range(5):
        eng.process_block()
    totals = eng.profiler.totals()
    assert "render_swap" not in totals and "clip_render" not in totals
    assert totals["bank_upload"]["count"] == 1
    assert eng.stats()["renders_applied"] == 0
    clip.set_pitch(0.0, defer=defer)    # unchanged: no render
    eng.process_block()
    assert eng.stats()["renders_applied"] == 0
