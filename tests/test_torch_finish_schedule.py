"""The finish kernel's reduction schedule (libzl_tpu_torch/csrc/
finish_block.cu), modelled in numpy float32 on the CPU.

The kernel sums each lane's squares in the halving tree of
ops/finish._tree_sum, but not level by level in memory: tree element i
sits at

    i = row * 512 + warp * 64 + lane * 2 + e      (256 threads, e in {0, 1})

and the levels run as the row bits in registers (rows pushed in
bit-reversed order into a binary counter of partials), the warp bits after
one shared-memory exchange, the lane bits by __shfl_down_sync at 16 .. 1,
then e. Past 16384 frames the tree splits into residue classes r mod R,
each a tree in that schedule, and a second pass halves the R class sums in
it again. The peaks ride the same exchange (a NaN-propagating max: each
thread's frames, an xor shuffle, the warps; the master's chunks of 512
frame pairs, past the first folded by the second pass).

These tests model that mapping element by element and hold it bit for bit
to _tree_sum and to block_peaks, so a change of the kernel's mapping has
to change its model here first. The constants are read from the source.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from libzl_tpu_torch.ops import finish as fin
from libzl_tpu_torch.ops import meters as meter_ops

SOURCE = (Path(__file__).resolve().parents[1] / "libzl_tpu_torch" / "csrc"
          / "finish_block.cu").read_text()


def _constant(pattern: str) -> int:
    return int(re.search(pattern, SOURCE).group(1))


THREADS = _constant(r"constexpr int kThreads = (\d+);")
WARPS = THREADS // 32
ROW = 2 * THREADS
MAX_CLASS = _constant(r"constexpr int64_t kMaxClass = (\d+);")
LEVELS = _constant(r"constexpr int kLevels = (\d+);")
PAIRS = _constant(r"constexpr int kPairs = (\d+);")
MASTER_PAIRS = PAIRS * THREADS
F32 = np.float32


def test_the_model_reads_the_kernels_constants():
    assert (THREADS, ROW, MAX_CLASS, LEVELS) == (256, 512, 16384, 6)
    assert MAX_CLASS // ROW <= 1 << (LEVELS - 1)
    assert PAIRS >= 1


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def reversed_row(q: int, d: int) -> int:
    """The kernel's reversed_row: q's low d bits reversed."""
    return int(f"{q:0{d}b}"[::-1], 2) if d else 0


def schedule_sum(elem: np.ndarray, order=("rows", "warps", "lanes", "e")):
    """The kernel's tree of elem [Q, 2] (Q a power of two, the tree zero
    padded to it), both channels: the row levels in registers, the warp
    levels after the exchange, the lane levels by shuffles, then e.
    `order` permutes the levels' meaning (a wrong mapping, to show that the
    tests can tell)."""
    Q = elem.shape[0]
    padded = np.zeros((max(Q, ROW), 2), F32)
    padded[:Q] = elem
    n = padded.shape[0] // ROW
    d = n.bit_length() - 1
    # [row, warp, lane, e, channel]
    a = padded.reshape(n, WARPS, 32, 2, 2)
    if order != ("rows", "warps", "lanes", "e"):
        a = padded.reshape(n, 32, WARPS, 2, 2).transpose(0, 2, 1, 3, 4)
    part = {}
    for q in range(n):
        v = a[reversed_row(q, d)]
        k = 0
        while (q >> k) & 1:  # Tree.push: the earlier partial on the left
            v = part[k] + v
            k += 1
        assert k < LEVELS
        part[k] = v
    v = part[d]                                   # [warp, lane, e, c]
    half = WARPS // 2
    while half:                                   # warp 0: w + 4, + 2, + 1
        v = v[:half] + v[half:2 * half]
        half //= 2
    v = v[0]                                      # [lane, e, c]
    for off in (16, 8, 4, 2, 1):                  # __shfl_down_sync
        v = v + np.concatenate([v[off:], v[32 - off:]])
    v = v[0]                                      # [e, c]
    return v[0] + v[1]


def kernel_tree(squares: np.ndarray) -> np.ndarray:
    """A lane's squares [B, 2] summed as the kernel sums them: one CTA's
    schedule up to 16384 frames, past it R class trees (frames r, r + R,
    ...) and the R sums in the same schedule."""
    B = squares.shape[0]
    P = next_pow2(B)
    if P <= MAX_CLASS:
        return schedule_sum(np.concatenate(
            [squares, np.zeros((P - B, 2), F32)]))
    R = P // MAX_CLASS
    sums = np.zeros((R, 2), F32)
    for r in range(R):
        cls = squares[r::R]
        sums[r] = schedule_sum(np.concatenate(
            [cls, np.zeros((MAX_CLASS - cls.shape[0], 2), F32)]))
    return schedule_sum(sums)


def squares(seed: int, B: int) -> np.ndarray:
    """Squares over a few binades (so the order of the adds shows in the
    bits), with exact zeros."""
    rng = np.random.default_rng(seed)
    x = (rng.uniform(0.5, 1.5, (B, 2)) * np.exp2(rng.integers(-3, 3, (B, 2)))
         ).astype(F32)
    x[rng.random(x.shape) < 0.05] = 0.0
    x[rng.random(x.shape) < 0.05] = -0.0
    return x * x


def _bits(a) -> np.ndarray:
    return np.asarray(a, F32).view(np.int32)


@pytest.mark.parametrize("p", range(16))
def test_schedule_equals_tree_sum_at_every_power_of_two(p):
    """B = P = 2^p, 1 to 2^15 (past 2^14 through the residue classes)."""
    for seed in (p, p + 100, p + 200):
        sq = squares(seed, 1 << p)
        want = fin._tree_sum(torch.from_numpy(sq)).numpy()
        np.testing.assert_array_equal(_bits(kernel_tree(sq)), _bits(want))


@pytest.mark.parametrize("B", [3, 31, 33, 130, 255, 257, 511, 513, 1000,
                               1023, 1025, 4095, 10240, 16383, 16385])
def test_schedule_equals_tree_sum_at_ragged_b(B):
    for seed in (B, B + 100, B + 200):
        sq = squares(seed, B)
        want = fin._tree_sum(torch.from_numpy(sq)).numpy()
        np.testing.assert_array_equal(_bits(kernel_tree(sq)), _bits(want))


@pytest.mark.parametrize("B", [16512, 40000])
def test_split_classes_equal_tree_sum(B):
    """The split's R class trees and their combine, at the main path's
    large-block cases (R = 2 and 4)."""
    sq = squares(B, B)
    assert next_pow2(B) // MAX_CLASS in (2, 4)
    want = fin._tree_sum(torch.from_numpy(sq)).numpy()
    np.testing.assert_array_equal(_bits(kernel_tree(sq)), _bits(want))


def test_a_wrong_mapping_shows():
    """Lanes in the low bits and warps above them (another valid-looking
    mapping) give other bits on some of a few draws: the tests above pin
    the mapping."""
    differ = 0
    for seed in range(8):
        sq = squares(seed, 1024)
        want = _bits(fin._tree_sum(torch.from_numpy(sq)).numpy())
        wrong = schedule_sum(sq, order=("rows", "lanes", "warps", "e"))
        differ += not np.array_equal(_bits(wrong), want)
    assert differ > 0


def test_special_values_propagate_through_the_schedule():
    sq = squares(3, 1000)
    for value in (np.inf, np.nan):
        s = sq.copy()
        s[517, 1] = value
        got, want = kernel_tree(s), fin._tree_sum(torch.from_numpy(s)).numpy()
        np.testing.assert_array_equal(_bits(got[:1]), _bits(want[:1]))
        assert np.isnan(got[1]) == np.isnan(want[1])
        assert got[1] == want[1] or np.isnan(got[1])


# ------------------------------------------------------------------ peaks


def nan_max(a, b):
    """The kernel's nan_max: a NaN on either side wins."""
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b, np.fmax(a, b)))


def lane_peaks(x: np.ndarray) -> np.ndarray:
    """A lane's [B, 2] peaks as the lane CTA folds them: each thread over its
    frames (padding reads 0), the xor shuffle, warp 0 over the warps; past
    16384 frames each class so and the classes in the combine's schedule."""
    B = x.shape[0]
    P = next_pow2(B)
    R = max(P // MAX_CLASS, 1)
    Q = P // R
    rows = max(Q // ROW, 1)
    classes = np.full((R, 2), -np.inf, F32)
    for r in range(R):
        cls = np.zeros((rows * ROW, 2), F32)
        cls[:x[r::R].shape[0]] = x[r::R]
        t = np.full((WARPS, 32, 2), -np.inf, F32)
        for row in range(rows):
            a = np.abs(cls[row * ROW:(row + 1) * ROW]).reshape(WARPS, 32, 2, 2)
            t = nan_max(t, nan_max(a[:, :, 0], a[:, :, 1]))
        for off in (16, 8, 4, 2, 1):           # __shfl_xor_sync
            t = nan_max(t, t[:, np.arange(32) ^ off])
        p = t[0, 0]
        for w in range(1, WARPS):
            p = nan_max(p, t[w, 0])
        classes[r] = p
    if R == 1:
        return classes[0]
    out = np.full(2, -np.inf, F32)
    for r in range(R):          # order-free; NaN-propagating all the same
        out = nan_max(out, classes[r])
    return out


def master_peak(dry: np.ndarray) -> np.ndarray:
    """The master's [B, 2] dry send's peak as the master CTAs fold it: chunk
    c of MASTER_PAIRS frame pairs, thread t's pairs c * MASTER_PAIRS + j *
    256 + t, a missing odd frame 0; the CTA's fold, then (more than one
    chunk) the second pass over the chunks."""
    B = dry.shape[0]
    pairs = (B + 1) // 2
    chunks = -(-pairs // MASTER_PAIRS)
    padded = np.zeros((2 * pairs, 2), F32)
    padded[:B] = dry
    seen = np.zeros(pairs, int)
    out = np.full(2, -np.inf, F32)
    for c in range(chunks):
        cta = np.full(2, -np.inf, F32)
        for t in range(THREADS):
            for j in range(PAIRS):
                i = c * MASTER_PAIRS + j * THREADS + t
                if i < pairs:
                    seen[i] += 1
                    a = np.abs(padded[2 * i:2 * i + 2])
                    cta = nan_max(cta, nan_max(a[0], a[1]))
        out = nan_max(out, cta)
    assert (seen == 1).all()   # every frame pair in exactly one chunk
    return out


def special_frames(seed: int, B: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, 2)) * 0.3).astype(F32)
    x[rng.random(x.shape) < 0.05] = -0.0
    return x


@pytest.mark.parametrize("B", [1, 31, 33, 128, 257, 1024, 16385, 40000])
@pytest.mark.parametrize("special", [None, np.nan, np.inf, -np.inf])
def test_peaks_exchange_matches_block_peaks(B, special):
    x = special_frames(B, B)
    if special is not None:
        x[(B * 5) // 7, 0] = special
        x[B - 1, 1] = special
    want = meter_ops.block_peaks(torch.from_numpy(x)).numpy()
    for got in (lane_peaks(x), master_peak(x)):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(_bits(np.where(np.isnan(got), 0, got)),
                                      _bits(np.where(np.isnan(want), 0,
                                                     want)))


@pytest.mark.parametrize("B", [1, 2, 31, 33, 128, 130, 1024, 16384, 16385,
                               16512, 40000])
def test_every_frame_has_one_lane_slot(B):
    """The lane CTA's element map (class r, element m -> frame r + R * m;
    each thread's frames 2j and 2j + 1 of a row) reaches every frame of
    [0, B) exactly once: each frame is one tree element, and (unsplit)
    each strip frame is written once; the master's chunks cover every
    frame pair once (master_peak)."""
    P = next_pow2(B)
    R = max(P // MAX_CLASS, 1)
    Q = P // R
    rows = max(Q // ROW, 1)
    d = rows.bit_length() - 1
    t = np.arange(THREADS)
    base = (t // 32) * 64 + (t % 32) * 2
    hits = np.zeros(B, int)
    for r in range(R):
        for q in range(rows):
            m = reversed_row(q, d) * ROW + base
            for e in (0, 1):
                b = r + R * (m + e)
                np.add.at(hits, b[b < B], 1)
    assert (hits == 1).all()
