"""The windows fetch kernel's contract, its plain PyTorch version and its
build, with no JAX in the file: the tests marked `cuda` run on the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

(`--noconftest`: tests/conftest.py imports JAX, which the card's machine
does not have). Without a card they skip; the rest run on the CPU in
Tier-1. The plain version is held against a float64 two-tap oracle with
hostile positions (atol 3e-6, tests/test_fetch_windows.py:294), out-of-range
lanes exactly 0; on the card the kernel is held against the plain version.
"""

import numpy as np
import pytest
import torch

from libzl_tpu_torch import _build
from libzl_tpu_torch.ops import fetch_windows as fw


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
@pytest.mark.parametrize("B", [128, 1024])
def test_engine_on_card_matches_cpu(B):
    """A small session through AudioEngine on "cuda" (the windows kernel)
    and on "cpu" (plain gather), block by block: voice peaks atol 2e-6;
    master rtol 1e-5, atol 2e-6 per voice in the densest lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import chip_smoke
    from libzl_tpu_torch.engine.engine import AudioEngine

    V = 64
    gpu = AudioEngine("cuda", block_frames=B, num_voices=V)
    cpu = AudioEngine("cpu", block_frames=B, num_voices=V)
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
