"""How `correct` is decided: the master mix the sink received, at blocks the
seed draws from the window and blocks where the traffic's events take effect
(live notes' starts and releases; reloads, with the blocks around them),
against the plain reference's.

The number compared is `master_gap`: the widest gap between a delivered
master sample and the reference's, over the sampled blocks, as a share of
the reference's peak over them. Its limit is the configuration's
(`limits.master_gap`), set from the readings PERF.md gives. A block that
never reached the sink fails the run too (`blocks_missing`, limit 0).
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference

RANDOM_BLOCKS = 24
ONSET_BLOCKS = 12
RELEASE_BLOCKS = 6
RELOAD_BLOCKS = 4
KEEP_ONE_IN = 64


def keep_rule(seed: int, first: int, blocks: set):
    """Which delivered blocks the sink keeps for the check, decided before
    the window: the window's first block, the `blocks` the event kinds'
    plans ask for, and one block in about KEEP_ONE_IN by a hash of its
    index salted with the seed."""
    salt = int(np.random.default_rng([seed, 5]).integers(0, 1 << 32))
    blocks = frozenset(blocks)

    def keep(index: int) -> bool:
        return (index == first or index in blocks
                or ((index * 0x9E3779B1 + salt) & 0xFFFFFFFF)
                % KEEP_ONE_IN == 0)
    return keep


def sample_blocks(seed: int, first: int, count: int, events: list,
                  kept) -> list:
    """Window blocks to compare: the first and last, RANDOM_BLOCKS drawn
    from the seed among the kept ones, up to ONSET_BLOCKS /
    RELEASE_BLOCKS of the window's live-note starts and releases, and up
    to RELOAD_BLOCKS of its reloads, each with the blocks before and after
    it."""
    rng = np.random.default_rng([seed, 4])
    last = first + count - 1
    picks = {first, last}
    pool = sorted(b for b in kept if first <= b <= last)
    if pool:
        picks.update(int(b) for b in rng.choice(
            pool, min(RANDOM_BLOCKS, len(pool)), replace=False))
    for kind, k in ((reference.Start, ONSET_BLOCKS),
                    (reference.Stop, RELEASE_BLOCKS)):
        blocks = sorted({e.block for e in events if isinstance(e, kind)
                         and not getattr(e, "looping", False)
                         and first <= e.block <= last})
        if blocks:
            picks.update(int(b) for b in rng.choice(
                blocks, min(k, len(blocks)), replace=False))
    # the block before a reload tells it from one that came a block early,
    # the reload's own block from one a block late
    reloads = sorted({e.block for e in events
                      if isinstance(e, reference.Reload)
                      and first <= e.block <= last})
    if reloads:
        for b in rng.choice(reloads, min(RELOAD_BLOCKS, len(reloads)),
                            replace=False):
            picks.update(x for x in range(int(b) - 1, int(b) + 2)
                         if first <= x <= last)
    return sorted(picks)


def reference_masters(config: dict, clips: list, num_voices: int,
                      events: list, blocks: list, device,
                      control: bool = False, work_range=None) -> tuple:
    """Step the reference pool from block 0 to the last of `blocks`
    through `events` (in effect order) and render each of `blocks` with
    the bank (the clips and every reload's buffer) in float32 and, for the
    `control`, in bfloat16 too.
    Returns ({dtype: {block: master [B, 2] float64 numpy}}, work), where
    work (for blocks in `work_range`, a (first, stop) pair) sums the voices
    that rendered and the distinct bank frames their taps read."""
    pad = reference.Sketchpad(config, [c.shape[0] for c in clips],
                              num_voices)
    buffers = reference.bank_buffers(clips, events)
    banks = {"float32": reference.reference_bank(buffers, device)}
    if control:
        banks["bfloat16"] = reference.reference_bank(buffers, device,
                                                     lower=True)
    strip0 = tuple(float(x) for x in config["strip0"])
    want = set(blocks)
    out = {d: {} for d in banks}
    work = {"blocks": 0, "voice_blocks": 0, "read_frames": 0}
    i = 0
    for b in range(max(blocks) + 1):
        while i < len(events) and events[i].block == b:
            ev = events[i]
            if isinstance(ev, reference.Start):
                pad.start(ev)
            elif isinstance(ev, reference.Reload):
                pad.reload(ev)
            else:
                pad.release(ev)
            i += 1
        counting = work_range is not None and work_range[0] <= b < \
            work_range[1]
        steady = b not in want and pad.steady()
        p = pad.steady_plan() if steady else pad.plan()
        if b in want:
            for d, (bank, offsets) in banks.items():
                out[d][b] = reference.render(pad, p, bank, offsets, strip0,
                                             device).cpu().numpy()
        if counting:
            work["blocks"] += 1
            work["voice_blocks"] += int(pad.active.sum())
            work["read_frames"] += pad.read_frames(p)
        if steady:
            pad.advance_steady()
        else:
            pad.advance(p)
    work["dropped_starts"] = pad.dropped
    return out, work


def master_gap(delivered: dict, ref: dict) -> float:
    """max |delivered - reference| over the blocks, over the reference's
    peak over them."""
    peak = max(float(np.abs(r).max()) for r in ref.values())
    gap = max(float(np.abs(delivered[b].astype(np.float64) - r).max())
              for b, r in ref.items())
    return gap / max(peak, 1e-30)


def judge(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def release_device_memory() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
