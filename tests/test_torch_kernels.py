"""The port's kernels (the windows fetch, the in-order lane mixdown, the voice
prep and post around the fetch, and the finish), their plain PyTorch
versions and their build, with no JAX in the file: the tests marked `cuda`
run on the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

(`--noconftest`: tests/conftest.py imports JAX, which the card's machine
does not have). Without a card they skip; the rest run on the CPU in
Tier-1. The plain fetch is held against a float64 two-tap oracle with
hostile positions (atol 3e-6, tests/test_fetch_windows.py:294), out-of-range
lanes exactly 0; the plain mixdown against a scalar float32 fold, bit for
bit. On the card each kernel is held against its plain version: the fetch
at atol 3e-6, the mixdown, the voice prep and post and the finish bit for
bit (`hostile_program` draws the voice kernels' programs; the CPU tests of
their plain versions are in tests/test_torch_voice_kernels.py).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import same_bits
from libzl_tpu_torch import _build
from libzl_tpu_torch.ops import fetch_windows as fw
from libzl_tpu_torch.ops import finish as fin
from libzl_tpu_torch.ops import mixdown as md
from libzl_tpu_torch.ops import voice_render as vr


def hostile_inputs(seed: int, V: int, B: int, n: int, dtype=np.float32,
                   edges: bool = True):
    """Window-relative positions in region A, region B, negative and past
    the end, as tests/test_fetch_windows.py draws them, plus (`edges`) the
    region edges: p = region-1 reads region B's first sample at tap p+1,
    2*region-2 is the last valid position. Edge draws break the TPU
    kernel's host contract (one chunk's in-region positions span at most
    one weight slab), so only the contract-free versions see them."""
    rng = np.random.default_rng(seed)
    region = fw.region_rows(B)
    window_rows = 2 * region
    sound = (rng.standard_normal((2, n)) * 0.5).astype(np.float32)
    if dtype == np.int16:
        sound = np.clip(np.round(sound * np.float32(32767.0)),
                        -32768, 32767).astype(np.int16)
    max_blk = (n - region) // 512
    win_a = rng.integers(0, max_blk, V).astype(np.int32)
    win_b = rng.integers(0, max_blk, V).astype(np.int32)
    kind = rng.integers(0, 5 if edges else 4, (V, B))
    base_a = rng.integers(0, region - 516, V)[:, None]
    base_b = region + rng.integers(0, region - 516, V)[:, None]
    jitter = rng.integers(0, 512, (V, B))
    edge_pos = np.array([region - 1, region, window_rows - 2,
                         window_rows - 1])
    pos = np.select(
        [kind == 0, kind == 1, kind == 2, kind == 3],
        [base_a + jitter, base_b + jitter, rng.integers(-100, 0, (V, B)),
         rng.integers(window_rows - 1, window_rows + 100, (V, B))],
        edge_pos[rng.integers(0, 4, (V, B))],
    ).astype(np.int32)
    alpha = rng.random((V, B)).astype(np.float32)
    return sound, pos, alpha, win_a, win_b


def oracle(sound, pos, alpha, win_a, win_b):
    """Straight two-tap interpolation over each voice's concatenated
    windows (float64), 0 outside 0 <= p < 2*region-1."""
    V, B = pos.shape
    region = fw.region_rows(B)
    s = sound.astype(np.float64)
    if sound.dtype == np.int16:
        s = s * np.float64(np.float32(1.0 / 32767.0))
    out = np.zeros((V, 2, B))
    for v in range(V):
        window = np.concatenate(
            [s[:, win_a[v] * 512: win_a[v] * 512 + region],
             s[:, win_b[v] * 512: win_b[v] * 512 + region]], axis=1)
        for b in range(B):
            p = int(pos[v, b])
            if 0 <= p < 2 * region - 1:
                a = float(alpha[v, b])
                out[v, :, b] = window[:, p] * (1 - a) + window[:, p + 1] * a
    return out


def torch_args(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def assert_out_of_range_zero(out, pos):
    region = fw.region_rows(pos.shape[1])
    bad = (pos < 0) | (pos >= 2 * region - 1)
    assert bad.any()
    assert (out.transpose(1, 0, 2)[:, bad] == 0.0).all()


@pytest.mark.parametrize("B", [128, 1024])
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_plain_matches_oracle(B, dtype):
    args = hostile_inputs(5, 6, B, 1 << 15, dtype)
    got = fw.fetch_interp_plain(*torch_args(*args)).numpy()
    np.testing.assert_allclose(got, oracle(*args), atol=3e-6)
    assert_out_of_range_zero(got, args[1])


def test_plain_reads_zero_past_the_bank():
    """A broken tail guard (a region running past N) reads 0 for the taps
    outside [0, N), never out of bounds."""
    B, n = 128, 4096
    region = fw.region_rows(B)
    sound = np.ones((2, n), np.float32)
    win = np.array([(n - 512) // 512], np.int32)        # region A spills
    pos = np.array([[0, 511, 512, region - 1]], np.int32)
    pos = np.pad(pos, ((0, 0), (0, B - 4)))
    alpha = np.full((1, B), 0.25, np.float32)
    got = fw.fetch_interp_plain(*torch_args(sound, pos, alpha, win, win))
    got = got.numpy()
    np.testing.assert_array_equal(got[0, :, 0], [1.0, 1.0])
    np.testing.assert_array_equal(got[0, :, 1], [0.75, 0.75])  # p+1 == n
    np.testing.assert_array_equal(got[0, :, 2], [0.0, 0.0])


def test_fetch_interp_on_cpu_is_the_plain_version():
    args = torch_args(*hostile_inputs(9, 4, 128, 8192))
    before = fw.fetch_interp.launches
    torch.testing.assert_close(fw.fetch_interp(*args),
                               fw.fetch_interp_plain(*args), rtol=0, atol=0)
    assert fw.fetch_interp.launches == before


def test_fetch_interp_refuses_other_devices():
    args = tuple(t.to("meta") for t in
                 torch_args(*hostile_inputs(9, 4, 128, 8192)))
    with pytest.raises(ValueError):
        fw.fetch_interp(*args)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "missing" / "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_raises_with_nvcc_output(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no such arch' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such arch"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build.library_path()
    (csrc / "k.cu").write_text("// two\n")
    assert _build.library_path() != first


@pytest.mark.cuda
@pytest.mark.parametrize("B", [128, 1024])
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_kernel_matches_plain_on_card(B, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = tuple(t.cuda() for t in
                 torch_args(*hostile_inputs(11, 64, B, 1 << 16, dtype)))
    before = fw.fetch_interp.launches
    got = fw.fetch_interp(*args)
    want = fw.fetch_interp_plain(*args)
    torch.cuda.synchronize()
    assert fw.fetch_interp.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=3e-6)
    assert_out_of_range_zero(got.cpu().numpy(), args[1].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("V,B", [(7, 64), (33, 130), (5, 384), (11, 480),
                                 (5, 514), (9, 1000), (3, 2048), (2, 4096)])
def test_kernel_matches_plain_on_card_at_odd_shapes(V, B):
    """The kernel's other launch shapes: fewer frames than a CTA row, a
    ragged B (scalar rows, no ring), a CTA row longer than B, voice groups
    of 2 at 192 and 256 threads, a partial last voice group, and B split
    into 1024-frame chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = tuple(t.cuda() for t in
                 torch_args(*hostile_inputs(13, V, B, 1 << 16)))
    got = fw.fetch_interp(*args)
    want = fw.fetch_interp_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=3e-6)
    assert_out_of_range_zero(got.cpu().numpy(), args[1].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [128, 1024])
def test_engine_on_card_matches_cpu(B):
    """A small session through AudioEngine on "cuda" (the windows kernel)
    and on "cpu" (plain gather), block by block: voice peaks atol 2e-6;
    master rtol 1e-5, atol 2e-6 per voice in the densest lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from libzl_tpu_torch.engine.engine import AudioEngine

    V = 64
    per_block = dict(lookahead=0, voice_buckets="off")
    gpu = AudioEngine("cuda", block_frames=B, num_voices=V, **per_block)
    cpu = AudioEngine("cpu", block_frames=B, num_voices=V, **per_block)
    assert gpu.fetch == "windows"
    for e in (gpu, cpu):
        chip_smoke.build_session(e, num_voices=V, num_clips=8)
    before = fw.fetch_interp.launches
    for _ in range(8):
        og = gpu.process_block().outputs
        oc = cpu.process_block().outputs
        lanes = np.bincount(gpu.pool.lane[gpu.pool.active], minlength=12)
        atol = 2e-6 * max(int(lanes.max()), 1)
        torch.testing.assert_close(og.voice_peaks.cpu(), oc.voice_peaks,
                                   rtol=0, atol=2e-6)
        torch.testing.assert_close(og.master.cpu(), oc.master, rtol=1e-5,
                                   atol=atol)
    assert fw.fetch_interp.launches - before == 8
    assert gpu.fetch_dispatches == {"windows": 8, "gather": 0}


@pytest.mark.cuda
def test_horizon_engine_on_card_matches_per_block():
    """The horizon engine on "cuda" (lookahead=16, set whatever "auto"
    resolves to: H=16 horizons rendered on the engine thread and,
    speculatively, on the dispatch thread) against the same engine at
    lookahead=0, V=64, B=128, through
    two adoptions and an event-block rebuild (a note-off): voice peaks atol 2e-6; master rtol
    1e-5, atol 2e-6 per voice in the densest lane (the engine tolerance:
    cuBLAS handles are per thread, so bit-equality is not assumed across
    threads). Every horizon slice and per-block block launched the kernel
    once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from libzl_tpu_torch.engine.engine import AudioEngine

    V, B = 64, 128
    hz = AudioEngine("cuda", block_frames=B, num_voices=V, lookahead=16)
    pb = AudioEngine("cuda", block_frames=B, num_voices=V, lookahead=0)
    assert hz._lookahead == 16 and hz.fetch == "windows"
    for e in (hz, pb):
        chip_smoke.build_session(e, num_voices=V, num_clips=8)
    hz.warmup()
    before = fw.fetch_interp.launches
    for b in range(48):
        if b == 40:
            for e in (hz, pb):
                chip_smoke.note_off(e, 3)
        og = hz.process_block().outputs
        op = pb.process_block().outputs
        lanes = np.bincount(pb.pool.lane[pb.pool.active], minlength=12)
        atol = 2e-6 * max(int(lanes.max()), 1)
        torch.testing.assert_close(og.voice_peaks, op.voice_peaks, rtol=0,
                                   atol=2e-6)
        torch.testing.assert_close(og.master, op.master, rtol=1e-5, atol=atol)
    hz.drain_speculation()
    torch.cuda.synchronize()
    stats = hz.stats()
    assert stats["spec_failures"] == 0, stats["spec_last_failure"]
    assert stats["slo_by_kind"]["adopt"][1] >= 2
    assert hz.fetch_dispatches["gather"] == 0
    assert pb.fetch_dispatches["gather"] == 0
    assert fw.fetch_interp.launches - before == \
        hz.fetch_dispatches["windows"] + pb.fetch_dispatches["windows"]


# ------------------------------------------------------ the lane mixdown


# The kernel keeps 128 rows of a lane in flight, adds and refills them 16 at
# a time and lists 1024 voices at a time: lane i of a "ring" draw holds
# RING_COUNTS[i] voices, one below, at and above half that depth, the depth
# and twice it.
RING_COUNTS = (63, 64, 65, 127, 128, 129, 255, 256, 257)
RING_VOICES = sum(RING_COUNTS) + 40          # and 40 voices of no lane


def mixdown_inputs(seed: int, V: int, B: int, H: int = 0,
                   stray: bool = True, init: bool = False,
                   per_slice_lanes: bool = False, lanes: str = "random"):
    """contrib [V, B, 2] (or [H, V, B, 2]) with exact zeros and -0.0 mixed
    in, lanes in [0, 12) plus (`stray`) lanes outside it, and an optional
    non-zero init of the output's shape. `lanes` "one" puts every voice in
    lane 3; "ring" (V = RING_VOICES) shuffles RING_COUNTS' lanes."""
    rng = np.random.default_rng(seed)
    shape = ((H,) if H else ()) + (V, B, 2)
    contrib = rng.standard_normal(shape).astype(np.float32)
    contrib[rng.random(shape) < 0.1] = 0.0
    contrib[rng.random(shape) < 0.05] = -0.0
    lane_shape = (H, V) if H and per_slice_lanes else (V,)
    lane = rng.integers(0, 12, lane_shape)
    if stray:
        odd = rng.random(lane_shape) < 0.15
        lane = np.where(odd, rng.choice([-7, -1, 12, 13, 100], lane_shape),
                        lane)
    if lanes == "one":
        lane = np.full(lane_shape, 3)
    elif lanes == "ring":
        assert V == RING_VOICES and lane_shape == (V,)
        lane = rng.permutation(np.concatenate(
            [np.full(n, i) for i, n in enumerate(RING_COUNTS)]
            + [np.full(40, -1)]))
    out_shape = ((H,) if H else ()) + (12, B, 2)
    start = (rng.standard_normal(out_shape).astype(np.float32)
             if init else None)
    return contrib, lane.astype(np.int32), start


def scalar_fold(contrib, lane, init=None):
    """The mixdown's contract written out: per slice and lane, a float32
    fold of the lane's voices in index order from init (or +0.0)."""
    stacked = contrib.ndim == 4
    c = contrib if stacked else contrib[None]
    H, V = c.shape[:2]
    lanes = np.broadcast_to(lane, (H, V))
    acc = (np.zeros((H, 12) + c.shape[2:], np.float32) if init is None
           else (init if stacked else init[None]).copy())
    for h in range(H):
        for v in range(V):
            ln = int(lanes[h, v])
            if 0 <= ln < 12:
                acc[h, ln] = acc[h, ln] + c[h, v]   # float32, round to nearest
    return acc if stacked else acc[0]


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


@pytest.mark.parametrize("case", [
    dict(V=40, B=16), dict(V=40, B=16, init=True),
    dict(V=33, B=8, H=3), dict(V=33, B=8, H=3, per_slice_lanes=True,
                               init=True),
    dict(V=0, B=8), dict(V=5, B=4, stray=False)])
def test_mixdown_plain_is_the_in_order_fold(case):
    contrib, lane, init = mixdown_inputs(21, **case)
    got = md.lane_mixdown_plain(
        torch.from_numpy(contrib), torch.from_numpy(lane),
        init=None if init is None else torch.from_numpy(init)).numpy()
    np.testing.assert_array_equal(_bits(got),
                                  _bits(scalar_fold(contrib, lane, init)))


# Shapes the kernel's tiling makes special: E = 2B not a multiple of the
# 128-element tile or of 4 (8-byte copies), lanes one below, at and above
# the ring's depth, every voice in one lane (many rings deep), V not a
# multiple of 32 or 256 and past the 1024 of one listing, E = 2.
TILING_CASES = [
    dict(V=RING_VOICES, B=6, lanes="ring"),
    dict(V=RING_VOICES, B=65, lanes="ring", init=True),
    dict(V=1024, B=16, lanes="one"),
    dict(V=2500, B=33, lanes="one", init=True),
    dict(V=1000, B=100),
    dict(V=1025, B=64, H=2, per_slice_lanes=True),
    dict(V=300, B=1, init=True),
    dict(V=77, B=130, H=3, init=True),
]


def _case_id(case):
    return "-".join(f"{k}{v}" for k, v in case.items())


@pytest.mark.parametrize("case", TILING_CASES, ids=_case_id)
def test_mixdown_plain_at_the_kernel_tiling_edges(case):
    contrib, lane, init = mixdown_inputs(26, **case)
    got = md.lane_mixdown_plain(
        torch.from_numpy(contrib), torch.from_numpy(lane),
        init=None if init is None else torch.from_numpy(init)).numpy()
    np.testing.assert_array_equal(_bits(got),
                                  _bits(scalar_fold(contrib, lane, init)))


def test_mixdown_plain_leaves_its_init_alone():
    """The kernel's `out` may alias `init`; the plain version returns a new
    tensor and the same bits."""
    contrib, lane, init = mixdown_inputs(27, 90, 12, init=True)
    start = torch.from_numpy(init.copy())
    got = md.lane_mixdown_plain(torch.from_numpy(contrib),
                                torch.from_numpy(lane), init=start)
    assert torch.equal(start, torch.from_numpy(init))
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(scalar_fold(contrib, lane, init)))


def test_mixdown_plain_from_an_unaligned_view():
    """Contributions that start 4 bytes into their storage (the kernel's
    narrowest path on the card) fold to the same bits."""
    contrib, lane, _ = mixdown_inputs(28, 70, 10)
    flat = torch.zeros(contrib.size + 1)
    flat[1:] = torch.from_numpy(contrib).reshape(-1)
    view = flat[1:].view(70, 10, 2)
    assert view.is_contiguous() and view.storage_offset() == 1
    np.testing.assert_array_equal(
        _bits(md.lane_mixdown(view, torch.from_numpy(lane)).numpy()),
        _bits(scalar_fold(contrib, lane)))


@pytest.mark.parametrize("k", [2, 3, 5, 8])
def test_mixdown_carried_over_chunks_is_one_fold(k):
    """The mesh's carried fold: k chunks of the voices, each starting from
    the one before, give the bits of one call over all of them, for any k
    (k need not divide V)."""
    contrib, lane, _ = mixdown_inputs(22, 61, 32, H=4)
    c, ln = torch.from_numpy(contrib), torch.from_numpy(lane)
    want = md.lane_mixdown_plain(c, ln)
    acc = None
    for part in np.array_split(np.arange(61), k):
        lo, hi = int(part[0]), int(part[-1]) + 1
        acc = md.lane_mixdown(c[:, lo:hi].contiguous(), ln[lo:hi].contiguous(),
                              init=acc)
    assert torch.equal(acc, want)


def test_mixdown_ignores_an_idle_tail():
    """Voices past the rendering ones contribute +0.0: a prefix and the
    whole pool give the same bits (bucketed dispatch)."""
    contrib, lane, _ = mixdown_inputs(23, 48, 16)
    contrib[30:] = 0.0
    c, ln = torch.from_numpy(contrib), torch.from_numpy(lane)
    assert torch.equal(md.lane_mixdown(c[:30].contiguous(), ln[:30].contiguous()),
                       md.lane_mixdown(c, ln))


def test_lane_mixdown_on_cpu_is_the_plain_version():
    contrib, lane, init = mixdown_inputs(24, 50, 16, H=2, init=True)
    args = (torch.from_numpy(contrib), torch.from_numpy(lane))
    before = md.lane_mixdown.launches
    assert torch.equal(md.lane_mixdown(*args, init=torch.from_numpy(init)),
                       md.lane_mixdown_plain(*args,
                                             init=torch.from_numpy(init)))
    assert md.lane_mixdown.launches == before


def test_lane_mixdown_refuses_other_devices():
    contrib, lane, _ = mixdown_inputs(25, 8, 4)
    with pytest.raises(ValueError):
        md.lane_mixdown(torch.from_numpy(contrib).to("meta"),
                        torch.from_numpy(lane).to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(V=1024, B=128), dict(V=1024, B=1024, init=True),
    dict(V=1024, B=128, H=16), dict(V=256, B=128, H=16, init=True,
                                    per_slice_lanes=True),
    dict(V=300, B=100, init=True), dict(V=1, B=1), dict(V=0, B=64, init=True),
    dict(V=513, B=1000, stray=False)])
def test_mixdown_kernel_matches_plain_on_card(case):
    """Bit-equal to the plain version: V not a multiple of 32 (300, 513),
    frames not a multiple of a tile (B=100, 1000), stacked horizons with
    shared and per-slice lanes, lanes outside [0, 12), a non-zero init, no
    voices at all."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    contrib, lane, init = mixdown_inputs(31, **case)
    c, ln = torch.from_numpy(contrib).cuda(), torch.from_numpy(lane).cuda()
    start = None if init is None else torch.from_numpy(init).cuda()
    before = md.lane_mixdown.launches
    got = md.lane_mixdown(c, ln, init=start)
    want = md.lane_mixdown_plain(c, ln, init=start)
    torch.cuda.synchronize()
    assert md.lane_mixdown.launches == before + 1
    assert got.shape == want.shape
    assert torch.equal(got, want)
    np.testing.assert_array_equal(_bits(got.cpu().numpy()),
                                  _bits(want.cpu().numpy()))


def _copy_widths(B: int):
    """The copy widths (floats a chunk) E = 2B allows for 16-byte aligned
    tensors, 0 (the kernel's own choice: the widest) first."""
    return [0] + [vec for vec in (4, 2, 1) if 2 * B % vec == 0]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TILING_CASES + [
    dict(V=1024, B=128, stray=False), dict(V=1024, B=1024, stray=False)],
    ids=_case_id)
def test_mixdown_kernel_matches_plain_at_the_tiling_edges(case):
    """TILING_CASES and the main path's shapes through the kernel's own copy
    width and through each the shape allows: bit-equal to the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    contrib, lane, init = mixdown_inputs(26, **case)
    c, ln = torch.from_numpy(contrib).cuda(), torch.from_numpy(lane).cuda()
    start = None if init is None else torch.from_numpy(init).cuda()
    want = md.lane_mixdown_plain(c, ln, init=start)
    for vec in _copy_widths(case["B"]):
        got = md.launch_kernel(c, ln, init=start, vec=vec)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"copy width {vec}"
    if 2 * case["B"] % 4:
        with pytest.raises(RuntimeError):
            md.launch_kernel(c, ln, init=start, vec=4)


@pytest.mark.cuda
def test_mixdown_kernel_writes_over_its_init_on_card():
    """`out` aliasing `init`, through the C entry point: the bits of a call
    with a separate output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    contrib, lane, init = mixdown_inputs(27, 1024, 128, H=2, init=True)
    c, ln = torch.from_numpy(contrib).cuda(), torch.from_numpy(lane).cuda()
    start = torch.from_numpy(init).cuda()
    want = md.lane_mixdown(c, ln, init=start)
    lib = _build.load()
    code = lib.zl_lane_mixdown(
        c.data_ptr(), ln.data_ptr(), 0, start.data_ptr(), start.data_ptr(),
        2, 1024, 256, 12, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert code == 0
    assert torch.equal(start, want)


@pytest.mark.cuda
def test_mixdown_kernel_from_an_unaligned_view_on_card():
    """Contributions 4 bytes into their storage are copied in one-float
    chunks (wider ones are refused) and keep the bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    contrib, lane, _ = mixdown_inputs(28, 1024, 128)
    flat = torch.zeros(contrib.size + 1, device="cuda")
    flat[1:] = torch.from_numpy(contrib).reshape(-1).cuda()
    view, ln = flat[1:].view(1024, 128, 2), torch.from_numpy(lane).cuda()
    want = md.lane_mixdown_plain(view, ln)
    assert torch.equal(md.lane_mixdown(view, ln), want)
    assert torch.equal(md.launch_kernel(view, ln, vec=1), want)
    with pytest.raises(RuntimeError):
        md.launch_kernel(view, ln, vec=2)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_mixdown_kernel_carried_over_shards_on_card():
    """Four chunks of a 1024-voice horizon, each kernel call starting from
    the one before: the bits of one call over the pool."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    contrib, lane, _ = mixdown_inputs(32, 1024, 128, H=4)
    c, ln = torch.from_numpy(contrib).cuda(), torch.from_numpy(lane).cuda()
    want = md.lane_mixdown(c, ln)
    acc = None
    for lo in range(0, 1024, 256):
        acc = md.lane_mixdown(c[:, lo:lo + 256].contiguous(),
                              ln[lo:lo + 256].contiguous(), init=acc)
    torch.cuda.synchronize()
    assert torch.equal(acc, want)


@pytest.mark.cuda
def test_mixdown_kernel_refuses_what_it_does_not_take():
    """A CUDA tensor never reaches the plain version: a CPU init, a float64
    contrib, int64 lanes or a non-contiguous contrib raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    contrib, lane, init = mixdown_inputs(33, 64, 32, init=True)
    c, ln = torch.from_numpy(contrib).cuda(), torch.from_numpy(lane).cuda()
    with pytest.raises(ValueError):
        md.lane_mixdown(c, ln, init=torch.from_numpy(init))
    with pytest.raises(TypeError):
        md.lane_mixdown(c.double(), ln)
    with pytest.raises(TypeError):
        md.lane_mixdown(c, ln.long())
    with pytest.raises(ValueError):
        md.lane_mixdown(c.transpose(0, 1).contiguous().transpose(0, 1), ln)


@pytest.mark.cuda
@pytest.mark.parametrize("B", sorted(chip_smoke.CARD_LOOKAHEAD))
def test_card_defaults_resolve_as_measured(B):
    """On a card "auto" resolves as the sweep decided (PERF.md §5): the
    engine's lookahead, the bridge's bounce drain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's defaults")
    from libzl_tpu_torch.capi.bridge import EngineRuntime
    from libzl_tpu_torch.engine.engine import AudioEngine

    e = AudioEngine("cuda", block_frames=B, num_voices=64)
    assert e.fetch == "windows"
    assert e._lookahead == chip_smoke.CARD_LOOKAHEAD[B]
    rt = EngineRuntime(block_frames=B, num_voices=64, device="cuda")
    assert rt.bounce_drain_blocks == chip_smoke.CARD_DRAIN
    assert rt.engine._lookahead == chip_smoke.CARD_LOOKAHEAD[B]


@pytest.mark.cuda
def test_render_graphs_on_card_match_eager():
    """The horizon engine (lookahead=16) on "cuda" with render graphs
    (warmed: one CUDA graph a render shape, replayed a block or horizon)
    against the same engine rendering eagerly (render_graphs "off"),
    V=64, B=128, through adoptions and an event-block rebuild: every output
    bit-equal; every render a replay; each replay counted its kernels'
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from libzl_tpu_torch.engine.engine import AudioEngine

    V, B = 64, 128
    on = AudioEngine("cuda", block_frames=B, num_voices=V, lookahead=16)
    off = AudioEngine("cuda", block_frames=B, num_voices=V, lookahead=16,
                      render_graphs="off")
    for e in (on, off):
        chip_smoke.build_session(e, num_voices=V, num_clips=8)
        e.warmup()
    assert on.stats()["graphs"] == on.warmed_graphs > 0
    before = (fw.fetch_interp.launches, md.lane_mixdown.launches)
    for b in range(48):
        if b == 40:
            for e in (on, off):
                chip_smoke.note_off(e, 3)
        got, want = on.process_block().outputs, off.process_block().outputs
        for name, a, w in zip(got._fields, got, want):
            assert torch.equal(a, w), f"block {b} {name}"
    for e in (on, off):
        e.drain_speculation()
    torch.cuda.synchronize()
    stats = on.stats()
    assert stats["spec_failures"] == 0, stats["spec_last_failure"]
    assert stats["render_graphs"] == "graphs"
    assert stats["graph_replays"] == sum(on.render_dispatches.values())
    assert stats["late_captures"] == 0
    assert fw.fetch_interp.launches - before[0] == \
        on.fetch_dispatches["windows"] + off.fetch_dispatches["windows"]
    assert md.lane_mixdown.launches - before[1] == \
        sum(on.render_dispatches.values()) + \
        sum(off.render_dispatches.values())


@pytest.mark.cuda
def test_native_replay_matches_torch_replay_on_card():
    """The native replay (csrc/graph_replay.cu) of every graph of a horizon
    engine (lookahead=16: block and horizon keys), V=64, B=128, on the
    session's programs: bit-equal to the eager render and to the graph's
    replay() + clone() of the same program (chip_smoke.check_replays); each
    capture left the CUDA generator as it was (every entry native); after
    48 blocks every replay went through the native call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from libzl_tpu_torch.engine.engine import AudioEngine

    V, B = 64, 128
    e = AudioEngine("cuda", block_frames=B, num_voices=V, lookahead=16)
    chip_smoke.build_session(e, num_voices=V, num_clips=8)
    e.warmup()
    progs = chip_smoke.session_programs(e, 3 + 2 * e._lookahead + 4)
    assert set(progs) == {"block", "horizon"}
    assert chip_smoke.check_replays(e, progs, "native") == len(e._graphs)
    assert all(entry.native is not None
               for entry in e._graphs._entries.values())
    for _ in range(48):
        e.process_block()
    e.drain_speculation()
    torch.cuda.synchronize()
    counts = chip_smoke.check_native_counts(e, "native")
    print(f"native replays {counts}")
    assert counts["native_replays"] == counts["graph_replays"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["one-card", "one-card-chained",
                                  "across-cards"])
def test_mesh_render_graphs_on_card_match_eager(plan):
    """A 2-shard mesh of the horizon engine (lookahead=16), V=64, B=128,
    with render graphs (one graph a render on cuda:0; the chain of
    per-segment graphs, forced on cuda:0 or across cuda:0 and cuda:1)
    against the same mesh
    rendering eagerly (render_graphs "off") and the unsharded engine,
    through adoptions and an event-block rebuild: every output bit-equal;
    every render of the graph mesh a replay; the kernels launched 2 x the
    mesh engines' windows blocks and renders."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    if plan == "across-cards" and torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from libzl_tpu_torch.engine.engine import AudioEngine
    from libzl_tpu_torch.engine.graphs import RenderGraphs
    from libzl_tpu_torch.parallel.sharding import make_mesh

    V, B = 64, 128
    mesh = make_mesh(devices=["cuda:0", "cuda:1"] if plan == "across-cards"
                     else ["cuda:0"] * 2)
    on = AudioEngine("cuda:0", block_frames=B, num_voices=V, mesh=mesh,
                     lookahead=16)
    if plan == "one-card-chained":
        on._graphs = RenderGraphs(mesh.devices[0], [
            (d, i, 1) for i, d in enumerate(mesh.devices)])
    off = AudioEngine("cuda:0", block_frames=B, num_voices=V, mesh=mesh,
                      lookahead=16, render_graphs="off")
    one = AudioEngine("cuda:0", block_frames=B, num_voices=V, lookahead=16)
    engines = (on, off, one)
    for e in engines:
        chip_smoke.build_session(e, num_voices=V, num_clips=8)
        e.warmup()
    assert on.stats()["graphs"] == on.warmed_graphs > 0
    assert on.stats()["graph_segments"] == (1 if plan == "one-card" else 2)
    before = (fw.fetch_interp.launches, md.lane_mixdown.launches)
    for b in range(48):
        if b == 40:
            for e in engines:
                chip_smoke.note_off(e, 3)
        got, eager, want = (e.process_block().outputs for e in engines)
        for name, a, g, w in zip(got._fields, got, eager, want):
            assert torch.equal(a, w), f"block {b} {name} vs unsharded"
            assert torch.equal(g, w), f"block {b} {name} eager vs unsharded"
    for e in engines:
        e.drain_speculation()
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    stats = on.stats()
    assert stats["spec_failures"] == 0, stats["spec_last_failure"]
    assert stats["render_graphs"] == "graphs"
    assert stats["graph_replays"] == sum(on.render_dispatches.values())
    assert stats["late_captures"] == 0
    assert fw.fetch_interp.launches - before[0] == sum(
        e.mesh.size * e.fetch_dispatches["windows"] for e in engines)
    assert md.lane_mixdown.launches - before[1] == sum(
        e.mesh.size * sum(e.render_dispatches.values()) for e in engines)


# ------------------------------------- the voice prep, voice post and finish


def hostile_program(seed: int, V: int, B: int, W: int = 0):
    """A port VoiceProgram of numpy arrays that reaches every branch of the
    voice prep: every ADSR stage and both release modes, releases at and
    before frame 0, mid-block and past the block, immediate cuts and
    sub-frame releases, starts and stops mid-block, up to S-1 wrap segments
    (duplicates included) with and without a loop period, W beat-quantized
    resets (some at or past B: unused), negative positions, inactive rows,
    pan at -1, +1 and between."""
    from libzl_tpu_torch.ops import adsr, voice

    rng = np.random.default_rng(seed)
    S = voice.MAX_SEGMENTS_PER_BLOCK
    i32, f32 = np.int32, np.float32
    start = np.where(rng.random(V) < 0.3, rng.integers(1, B, V), 0)
    seg_start = np.full((V, S), B)
    seg_start[:, 0] = start
    for v in range(V):
        n = int(rng.integers(0, S))
        seg_start[v, 1:1 + n] = np.sort(rng.integers(start[v] + 1, B + 1, n))
    # juce's release rates at 44.1-48 kHz from 10 ms up (the exponential
    # release's exp2 then spans what a block reaches), none, and a
    # sub-frame release (exp2(-200) cuts to 0), as adsr.make_rates sets them
    inv_rel = rng.choice([0.0, 2e-4, 1e-3, 2e-3, 1.5], V)
    rel_log2 = np.where(inv_rel >= 1, -200.0, np.log2(
        np.float32(1) - np.minimum(inv_rel, 0.5).astype(np.float32)))
    release = rng.choice([0, 1, B // 2, B - 1, B + 5, int(voice.RELEASE_NONE),
                          -1], V)
    release = np.where(rng.random(V) < 0.4, rng.integers(0, B, V), release)
    env = adsr.AdsrProgram(
        stage0=rng.integers(0, 5, V).astype(i32),
        env0=rng.uniform(0, 1, V).astype(f32),
        a_rate=np.where(rng.random(V) < 0.2, 0.0,
                        rng.uniform(0, 0.02, V)).astype(f32),
        d_rate=np.where(rng.random(V) < 0.2, 0.0,
                        rng.uniform(0, 0.002, V)).astype(f32),
        sustain=rng.uniform(0, 1, V).astype(f32),
        rel_rate=rng.uniform(0, 0.002, V).astype(f32),
        inv_rel=inv_rel.astype(f32),
        rel_log2=rel_log2.astype(f32),
        release_frame=release.astype(i32),
        rel_mode=rng.integers(0, 2, V).astype(i32),
    )
    pan = rng.uniform(-1, 1, V)
    pan[rng.random(V) < 0.3] = rng.choice([-1.0, 1.0])
    return voice.VoiceProgram(
        active=(rng.random(V) < 0.85).astype(i32),
        base=rng.integers(0, 4096, V).astype(i32),
        len_minus1=rng.integers(1, 40000, V).astype(i32),
        win_blk_a=rng.integers(0, 64, V).astype(i32),
        win_blk_b=rng.integers(0, 64, V).astype(i32),
        seg_start=seg_start.astype(i32),
        seg_pos_int=rng.integers(-40, 30000, (V, S)).astype(i32),
        seg_pos_frac=rng.random((V, S)).astype(f32),
        rate_int=rng.integers(0, 4, V).astype(i32),
        rate_frac=rng.random(V).astype(f32),
        start_frame=start.astype(i32),
        stop_frame=np.where(rng.random(V) < 0.3, rng.integers(1, B + 1, V),
                            B).astype(i32),
        gain=rng.uniform(0, 1, V).astype(f32),
        clip_volume=rng.uniform(0, 1, V).astype(f32),
        pan=pan.astype(f32),
        lane=rng.integers(0, 12, V).astype(i32),
        loop_period=np.where(rng.random(V) < 0.5, rng.integers(20, 400, V),
                             0).astype(i32),
        bq_reset=np.minimum(np.sort(rng.integers(0, B + B // 2, (V, W)),
                                    axis=1), B).astype(i32),
        env=env,
    )


def device_program(prog, device="cpu"):
    """The program as the engine's render sees a block's: packed, fused,
    on `device`, split back into strided column views."""
    from libzl_tpu_torch.ops import voice

    fused = torch.from_numpy(voice.fuse_packed(*voice.pack_program(prog)))
    return voice.unpack_program(*voice.split_fused(fused.to(device)))


def _pack16(lo, hi):
    """Two 16-bit fields in one int32 word: lo | hi << 16."""
    return ((np.asarray(hi, np.uint32) << 16)
            | np.asarray(lo, np.uint32)).view(np.int32)


def hostile_dynamics(seed: int, V: int, B: int, H: int, W: int = 0):
    """Compact horizon dynamics [V, 1+(H-1)*D] int32 in
    ops/voice.pack_horizon_dynamics' layout that reach every branch of a
    slice's unpack: negative positions (the anchor's clamp at 0), wraps in
    the block and past it (duplicates included), stops mid-block, releases
    at 0, mid-block and none (the 16-bit sentinel), every stage and both
    release modes, inactive rows, W 16-bit resets in and past the block."""
    from libzl_tpu_torch.ops import voice

    rng = np.random.default_rng(seed)
    S = voice.MAX_SEGMENTS_PER_BLOCK
    D = voice.horizon_dyn_cols(W)
    dyn = np.zeros((V, 1 + (H - 1) * D), np.int32)
    bits = dyn.view(np.float32)
    dyn[:, 0] = rng.integers(0, 30000, V)                    # istart
    for t in range(H - 1):
        off = 1 + t * D
        dyn[:, off] = rng.integers(-3000, 30000, V)          # pos_int
        bits[:, off + 1] = rng.random(V)                     # pos_frac
        bits[:, off + 2] = rng.uniform(0, 1, V)              # env0
        bits[:, off + 3] = rng.uniform(0, 0.002, V)          # rel_rate
        wraps = np.sort(rng.integers(1, B + B // 4 + 2, (V, S - 1)), axis=1)
        stop = np.where(rng.random(V) < 0.3, rng.integers(1, B + 1, V), B)
        fields = [wraps[:, i] for i in range(S - 1)] + [stop]
        fields += [np.zeros(V, np.int64)] * (len(fields) % 2)
        for c in range(len(fields) // 2):
            dyn[:, off + 4 + c] = _pack16(fields[2 * c], fields[2 * c + 1])
        npack = (S + 1) // 2
        rf = rng.choice([0, 1, B // 2, B - 1, 0xFFFF], V)
        rf = np.where(rng.random(V) < 0.4, rng.integers(0, B, V), rf)
        dyn[:, off + 4 + npack] = (
            rf | (rng.random(V) < 0.85) << 16
            | rng.integers(0, 5, V) << 17 | rng.integers(0, 2, V) << 20)
        resets = np.minimum(np.sort(rng.integers(0, B + B // 2, (V, W)),
                                    axis=1), 0xFFFF)
        resets = np.concatenate([resets, np.zeros((V, W % 2), np.int64)], 1)
        for c in range((W + 1) // 2):
            dyn[:, off + 5 + npack + c] = _pack16(resets[:, 2 * c],
                                                  resets[:, 2 * c + 1])
    return dyn


def own_columns(prog):
    """The program with every column a tensor of its own (a horizon slice's
    layout): contiguous copies of the strided views."""
    return prog._replace(
        env=prog.env._replace(**{n: getattr(prog.env, n).contiguous()
                                 for n in prog.env._fields}),
        **{n: getattr(prog, n).contiguous() for n in prog._fields
           if n != "env"})


def post_inputs(seed: int, V: int, B: int, device="cpu"):
    """interp [V, 2, B], g [V, B] (zeros and negatives mixed in), valid
    [V, B] and a strided pan column with -1 and +1 in it."""
    rng = np.random.default_rng(seed)
    interp = rng.standard_normal((V, 2, B)).astype(np.float32)
    g = rng.standard_normal((V, B)).astype(np.float32)
    g[rng.random((V, B)) < 0.1] = 0.0
    valid = rng.random((V, B)) < 0.8
    cols = rng.uniform(-1, 1, (V, 7)).astype(np.float32)
    cols[::5, 3] = 1.0
    cols[1::5, 3] = -1.0
    t = [torch.from_numpy(a).to(device) for a in (interp, g, valid, cols)]
    return t[0], t[1], t[2], t[3][:, 3]


def finish_inputs(seed: int, H: int, B: int, device="cpu",
                  specials: bool = False):
    """chip_smoke.finish_inputs drawn from `seed`: a stacked lane mix
    [H, 12, B, 2] with exact zeros and -0.0 mixed in, and packed strips
    [5, 11] with muted strips and pans at -1 and +1. `specials`: a NaN in
    lane 3, +inf in lane 5 and -inf in lane 8 of the last slice (so the
    master, strips 2, 4 and 7, their peaks and RMS meet them), one frame
    each, and +inf in lane 10 beside -inf in lane 11 on one frame (the
    master's inf - inf)."""
    return chip_smoke.finish_inputs(np.random.default_rng(seed), H, B,
                                    device, specials)


# (V, B): one voice, a ragged B under and over one CTA row, B over a CTA's
# 256 threads but not a multiple of them, the engine's geometries
VOICE_SHAPES = [(1, 64), (1, 1024), (1000, 130), (1024, 128), (1000, 1000),
                (1024, 1024)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("V,B", VOICE_SHAPES)
@pytest.mark.parametrize("W", [0, 3])
def test_voice_prep_kernel_matches_plain_on_card(V, B, W):
    """Every output torch.equal to the plain version, from the block's
    strided columns and from a horizon slice's own tensors."""
    _need_card()
    prog = device_program(hostile_program(21 + W, V, B, W), "cuda")
    before = vr.voice_prep.launches
    got = vr.voice_prep(prog, B)
    want = vr.voice_prep_plain(prog, B)
    again = vr.voice_prep(own_columns(prog), B)
    torch.cuda.synchronize()
    assert vr.voice_prep.launches == before + 2
    for name, a, b, c in zip(("pos_local", "alpha", "g", "valid"), got, want,
                             again):
        assert a.dtype == b.dtype and torch.equal(a, b), name
        assert torch.equal(c, b), f"{name} from own columns"


@pytest.mark.cuda
@pytest.mark.parametrize("V,B", VOICE_SHAPES)
def test_voice_post_kernel_matches_plain_on_card(V, B):
    """Contributions and peaks torch.equal to the plain version, also
    written into a slice of a stacked buffer."""
    _need_card()
    args = post_inputs(31, V, B, "cuda")
    before = vr.voice_post.launches
    peak, contrib = vr.voice_post(*args)
    want_peak, want = vr.voice_post_plain(*args)
    buf = torch.full((3, V, B, 2), 7.0, device="cuda")
    peak2, into = vr.voice_post(*args, out=buf[1])
    torch.cuda.synchronize()
    assert vr.voice_post.launches == before + 2
    assert torch.equal(contrib, want) and torch.equal(peak, want_peak)
    assert into.data_ptr() == buf[1].data_ptr()
    assert torch.equal(buf[1], want) and torch.equal(peak2, want_peak)
    assert (buf[0] == 7.0).all() and (buf[2] == 7.0).all()


# (V, B) of the voice prep at W = 67 beat-quantized resets (B=10240 at 48
# kHz needs 67: constants.bq_extra_resets) and of its horizon slices
PREP_SHAPES = [(1024, 128), (1024, 1024), (16, 130), (64, 10240)]


def _assert_prep_equal(got, want, what: str):
    names = ("pos_local", "alpha", "g", "valid", "win_a", "win_b")
    assert len(got) == len(want) == len(names)
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.is_contiguous(), (what, name)
        assert torch.equal(a, b), (what, name)


@pytest.mark.cuda
@pytest.mark.parametrize("V,B", PREP_SHAPES)
def test_voice_prep_kernel_at_many_resets_on_card(V, B):
    """W = 67 resets (past the 64 the first kernel took): every output and
    the anchors torch.equal to the plain version, from strided and from own
    columns."""
    _need_card()
    prog = device_program(hostile_program(23, V, B, 67), "cuda")
    want = vr.voice_prep_plain(prog, B)
    _assert_prep_equal(vr.voice_prep(prog, B), want, "strided")
    _assert_prep_equal(vr.voice_prep(own_columns(prog), B), want, "own")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("V,B", PREP_SHAPES)
@pytest.mark.parametrize("H", [2, 16])
def test_voice_prep_slice_kernel_matches_plain_on_card(V, B, H):
    """Slices 1 and H-1 of a compact horizon with W = 67 resets straight
    from the dynamics (strided, as a view of the horizon's one buffer):
    every output torch.equal to unpack_horizon_slice + voice_prep_plain."""
    _need_card()
    W = 67
    base = device_program(hostile_program(25, V, B, W), "cuda")
    dyn = torch.from_numpy(hostile_dynamics(26, V, B, H, W)).to("cuda")
    buf = torch.cat([torch.zeros((V, 5), dtype=torch.int32, device="cuda"),
                     dyn], dim=1)
    before = vr.voice_prep.launches
    for h in sorted({1, H - 1}):
        want = vr.voice_prep_slice_plain(base, dyn, h, B)
        _assert_prep_equal(vr.voice_prep_slice(base, buf[:, 5:], h, B), want,
                           f"slice {h}")
    torch.cuda.synchronize()
    assert vr.voice_prep.launches == before + len({1, H - 1})


@pytest.mark.cuda
def test_voice_prep_kernel_reads_resets_past_the_staged_ones_on_card():
    """W = 600 resets, past the 512 a voice stages in shared memory: the
    rest read from global memory, block and slice alike."""
    _need_card()
    V, B, W = 16, 1024, 600
    prog = device_program(hostile_program(27, V, B, W), "cuda")
    _assert_prep_equal(vr.voice_prep(prog, B), vr.voice_prep_plain(prog, B),
                       "block")
    dyn = torch.from_numpy(hostile_dynamics(28, V, B, 3, W)).to("cuda")
    _assert_prep_equal(vr.voice_prep_slice(prog, dyn, 2, B),
                       vr.voice_prep_slice_plain(prog, dyn, 2, B), "slice")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [128, 130, 1024])
def test_voice_post_kernel_into_an_8_byte_aligned_out_on_card(B):
    """`out` 8 bytes past a 16-byte boundary (as a slice of a stacked
    buffer may be): contributions and peaks torch.equal to plain."""
    _need_card()
    V = 300
    args = post_inputs(33, V, B, "cuda")
    flat = torch.full((2 + V * B * 2 + 2,), 7.0, device="cuda")
    out = flat[2:2 + V * B * 2].view(V, B, 2)
    assert out.data_ptr() % 16 == 8
    peak, _ = vr.voice_post(*args, out=out)
    want_peak, want = vr.voice_post_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(peak, want_peak)
    assert (flat[:2] == 7.0).all() and (flat[-2:] == 7.0).all()


@pytest.mark.cuda
def test_engine_on_card_at_a_large_block_matches_cpu():
    """64 voices at B=10240 (W = 67 resets a voice at 48 kHz): the card's
    per-block engine against the CPU's, a few blocks, at phase 4's
    tolerances (voice peaks atol 2e-6; master rtol 1e-5, atol 2e-6 per
    voice in the densest lane)."""
    _need_card()
    from libzl_tpu_torch.constants import bq_extra_resets
    from libzl_tpu_torch.engine.engine import AudioEngine

    V, B = 64, 10240
    assert bq_extra_resets(B, 48000) == 67
    opts = dict(block_frames=B, num_voices=V, lookahead=0,
                voice_buckets="off")
    gpu, cpu = AudioEngine("cuda", **opts), AudioEngine("cpu", **opts)
    for e in (gpu, cpu):
        chip_smoke.build_session(e, num_voices=V, num_clips=8)
    for _ in range(3):
        og = gpu.process_block().outputs
        oc = cpu.process_block().outputs
        lanes = np.bincount(gpu.pool.lane[gpu.pool.active], minlength=12)
        atol = 2e-6 * max(int(lanes.max()), 1)
        torch.testing.assert_close(og.voice_peaks.cpu(), oc.voice_peaks,
                                   rtol=0, atol=2e-6)
        torch.testing.assert_close(og.master.cpu(), oc.master, rtol=1e-5,
                                   atol=atol)
    assert float(oc.master.abs().max()) > 0.01
    assert gpu.fetch_dispatches == {"windows": 3, "gather": 0}


FINISH_NAMES = ("dry", "wet1", "wet2", "lane_peaks", "lane_rms",
                "master_peak")


@pytest.mark.cuda
@pytest.mark.parametrize("H,B", chip_smoke.FINISH_CASES)
@pytest.mark.parametrize("specials", [False, True])
def test_finish_kernel_matches_plain_on_card(H, B, specials):
    """Strips, peaks, RMS and master peak bit-equal to the plain version,
    with NaN in the same places (the master chain and the RMS tree in the
    spelled order; past 16384 frames each lane's tree split over CTAs and
    combined in a second pass); `specials`: NaN, +inf and -inf frames in
    some lanes. `finish.launches` counts one a call (past 1024 frames the
    call runs a second kernel, the second pass)."""
    _need_card()
    mix, strips = finish_inputs(41, H, B, "cuda", specials)
    before = fin.finish.launches
    got = fin.finish(mix, strips)
    want = fin.finish_plain(mix, strips)
    torch.cuda.synchronize()
    assert fin.finish.launches == before + 1
    for name, a, b in zip(FINISH_NAMES, got, want):
        assert same_bits(a, b), name
    if specials:
        assert bool(torch.isnan(want[4][-1, 3]).any())
        assert bool(torch.isinf(want[3][-1, 5]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [128, 1024, 40000])
def test_finish_kernel_replays_in_a_graph(B):
    """The same captured finish replayed twice gives the same bits, equal to
    the plain version: nothing the kernel leaves behind (a split's scratch,
    the master chunks' peaks) needs a reset between replays."""
    _need_card()
    mix, strips = finish_inputs(43, 2, B, "cuda", True)
    want = fin.finish_plain(mix, strips)
    fin.finish(mix, strips)  # built and loaded outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fin.finish(mix, strips)
    for _ in range(2):
        for out in got:
            out.fill_(7.0)
        graph.replay()
        torch.cuda.synchronize()
        for name, a, b in zip(FINISH_NAMES, got, want):
            assert same_bits(a, b), name


@pytest.mark.cuda
def test_voice_kernels_refuse_what_they_do_not_take():
    _need_card()
    prog = device_program(hostile_program(5, 8, 128), "cuda")
    with pytest.raises(ValueError):
        vr.voice_prep(prog._replace(gain=prog.gain.to(torch.float64)), 128)
    interp, g, valid, pan = post_inputs(6, 8, 128, "cuda")
    with pytest.raises(ValueError):
        vr.voice_post(interp.transpose(0, 2).contiguous().transpose(0, 2),
                      g, valid, pan)
    with pytest.raises(ValueError):
        vr.voice_post(interp, g, valid.to(torch.uint8), pan)
    mix, strips = finish_inputs(7, 2, 128, "cuda")
    with pytest.raises(ValueError):
        fin.finish(mix[:, :, ::2], strips)
    with pytest.raises(ValueError):
        fin.finish(mix, strips[:, :10])
    with pytest.raises(ValueError):  # the kernel's 12 lanes only
        fin.finish(mix[:, :5].contiguous(), strips[:, :4].contiguous())
