"""The port's thumbnails and WaveFormItem against the reference's.

Min/max envelopes are exact (no arithmetic but comparisons), so every case
is bit-equal to libzl_tpu/ops/thumbnail.py: `thumbnail_batch` to
`thumbnail_jit` (JAX on the CPU) and `thumbnail_region` to its numpy
namesake, on batched, empty, short-window and mono inputs
(tests/test_thumbnail.py:26-33 and its edge cases). The port's WaveFormItem
gives the reference's envelopes and the same SVG. These run on the CPU by
asking for it; the entry points' default device is "cuda", which raises
without a card.
"""

import numpy as np
import pytest
import torch

from libzl_tpu.models.waveform import WaveFormItem as RefWaveFormItem
from libzl_tpu.ops.thumbnail import thumbnail_jit
from libzl_tpu.ops.thumbnail import thumbnail_math as ref_math
from libzl_tpu.ops.thumbnail import thumbnail_region as ref_region
from libzl_tpu_torch.io.wav import AudioData, write_wav
from libzl_tpu_torch.models.waveform import WaveFormItem
from libzl_tpu_torch.ops.thumbnail import (
    thumbnail_batch,
    thumbnail_math,
    thumbnail_region,
)

SR = 48000


def _eq(got, want):
    for g, w in zip(got, want):
        g = g.cpu().numpy() if torch.is_tensor(g) else g
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape,buckets", [
    ((4, 4096, 2), 256),     # batched, whole buckets
    ((3, 5000, 2), 512),     # batched, tail dropped
    ((2, 100, 1), 512),      # batched, shorter than the bucket count
    ((4096, 2), 512),        # one sound
    ((300, 2), 512),         # one sound, edge-padded
    ((0, 2), 64),            # empty
    ((2, 0, 1), 16),         # empty batch rows
    ((777,), 128),           # mono 1-D
])
def test_thumbnail_bit_equal_to_jit(shape, buckets):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    want = thumbnail_jit(x, num_buckets=buckets)
    _eq(thumbnail_batch(x, buckets, device="cpu"), want)
    _eq(thumbnail_math(torch.from_numpy(x), buckets), ref_math(np, x, buckets))


@pytest.mark.parametrize("window", [(0.25, 0.75), (0.9, 0.1), (0.5, 0.5),
                                    (0.0, 0.004), (0.6, 5.0)])
@pytest.mark.parametrize("mono", [False, True])
def test_thumbnail_region_bit_equal(window, mono):
    x = np.linspace(-1, 1, SR, dtype=np.float32)
    x = x if mono else np.stack([x, -0.5 * x], axis=1)
    _eq(thumbnail_region(x, *window, SR, 128, device="cpu"),
        ref_region(x, *window, SR, 128))


def test_thumbnail_batch_stays_on_its_device():
    x = torch.randn(2, 1024, 2)
    mins, maxs = thumbnail_batch(x, 64)
    assert mins.device == x.device and mins.shape == (2, 64, 2)
    assert (maxs >= mins).all()


def test_waveform_item_matches_reference(tmp_path):
    p = tmp_path / "w.wav"
    rng = np.random.default_rng(0)
    write_wav(p, rng.uniform(-0.5, 0.5, (4800, 2)).astype(np.float32), SR)
    port = WaveFormItem(num_buckets=64, device="cpu")
    ref = RefWaveFormItem(num_buckets=64)
    for item in (port, ref):
        item.set_source(str(p))
    assert port.length == ref.length == 0.1
    _eq(port.envelope(), ref.envelope())
    assert port.to_svg(320, 80) == ref.to_svg(320, 80)
    for item in (port, ref):
        item.set_start(0.02)
        item.set_end(0.03)
        item.num_buckets = 128
    _eq(port.envelope(), ref.envelope())
    np.testing.assert_array_equal(port.to_polygon(100.0, 50.0),
                                  ref.to_polygon(100.0, 50.0))


def test_waveform_item_cache_and_callbacks():
    item = WaveFormItem(num_buckets=64, device="cpu")
    repaints = []
    item.repaint_callback = lambda: repaints.append(1)
    x = np.linspace(-1, 1, SR, dtype=np.float32)[:, None]
    item.set_source(AudioData(x, SR))
    assert item.length == 1.0 and item.end == 1.0 and len(repaints) == 1
    e1 = item.envelope()
    assert item.envelope()[0] is e1[0]   # cached
    item.set_start(0.5)
    assert len(repaints) == 2 and item.envelope()[0] is not e1[0]
    for s in np.linspace(0, 0.4, 7):
        item.set_start(float(s))
        item.envelope()
    assert len(item._cache) <= 5
    empty = WaveFormItem(num_buckets=32, device="cpu")
    assert empty.envelope()[0].shape == (32, 1)


@pytest.mark.parametrize("entry", [
    lambda: thumbnail_batch(np.zeros((2, 64, 2), np.float32), 8),
    lambda: thumbnail_region(np.zeros((64, 2), np.float32), 0.0, 1.0, 64, 8),
    lambda: thumbnail_region(np.zeros((64, 2), np.float32), 0.5, 0.1, 64, 8),
    lambda: WaveFormItem(num_buckets=8),
], ids=["batch", "region", "empty_region", "waveform_item"])
def test_entry_points_default_to_cuda(entry):
    """An array's thumbnail, a zoom window's and a WaveFormItem are reduced
    on "cuda" unless the caller asks for the CPU: without a card the default
    raises, as AudioEngine("cuda") does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        entry()
