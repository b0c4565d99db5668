"""WaveFormItem over the port's thumbnails (lib/WaveFormItem.{h,cpp} analog).

The port of libzl_tpu/models/waveform.py, which imports the reference's
thumbnail module and with it JAX. The model owns the data side of the
reference's QQuickPaintedItem: source, zoom window, a 5-entry thumbnail
cache, a repaint callback, and ready-to-draw geometry (polygon, SVG). The
envelopes are reduced on `device` (default "cuda": without a card the
constructor raises, as AudioEngine("cuda") does).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional

import numpy as np

from ..device import resolve_device
from ..io.wav import read_audio
from ..ops.thumbnail import DEFAULT_THUMB_SIZE, thumbnail_region

THUMBNAIL_CACHE_SIZE = 5  # lib/WaveFormItem.cpp:22


class WaveFormItem:
    def __init__(self, num_buckets: int = DEFAULT_THUMB_SIZE, device="cuda"):
        self.num_buckets = num_buckets
        self.device = resolve_device(device)
        self._samples: Optional[np.ndarray] = None
        self._sample_rate = 0.0
        self._source = ""
        self._start = 0.0
        self._end = 0.0
        self._cache: OrderedDict = OrderedDict()
        self.color = "#ffffff"  # parity with the QML color property
        self.repaint_callback: Optional[Callable[[], None]] = None

    # ---------------------------------------------------------- properties

    @property
    def source(self) -> str:
        return self._source

    def set_source(self, path_or_audio) -> None:
        """Accepts a file path or an AudioData (setSource,
        lib/WaveFormItem.cpp:38-55)."""
        if isinstance(path_or_audio, str):
            audio = read_audio(path_or_audio)
            self._source = path_or_audio
        else:
            audio = path_or_audio
            self._source = getattr(path_or_audio, "path", "<memory>")
        self._samples = np.asarray(audio.samples, np.float32)
        self._sample_rate = float(audio.sample_rate)
        self._start = 0.0
        self._end = self.length
        self._cache.clear()
        self._repaint()

    @property
    def length(self) -> float:
        """Total length in seconds (lib/WaveFormItem.cpp:58-66)."""
        if self._samples is None or self._sample_rate <= 0:
            return 0.0
        return self._samples.shape[0] / self._sample_rate

    @property
    def start(self) -> float:
        return self._start

    def set_start(self, seconds: float) -> None:
        self._start = float(seconds)
        self._repaint()

    @property
    def end(self) -> float:
        return self._end

    def set_end(self, seconds: float) -> None:
        self._end = float(seconds)
        self._repaint()

    # ----------------------------------------------------------- rendering

    def envelope(self):
        """(mins, maxs) [buckets, channels] numpy for the current zoom
        window, LRU-cached like the reference's 5-entry thumbnail cache."""
        if self._samples is None:
            z = np.zeros((self.num_buckets, 1), np.float32)
            return z, z
        # num_buckets is a public attribute: it must participate in the
        # key or a resolution change returns stale wrong-sized envelopes
        key = (self._source, round(self._start, 6), round(self._end, 6),
               self.num_buckets)
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key]
        result = thumbnail_region(
            self._samples, self._start, self._end, self._sample_rate,
            self.num_buckets, self.device,
        )
        self._cache[key] = result
        while len(self._cache) > THUMBNAIL_CACHE_SIZE:
            self._cache.popitem(last=False)
        return result

    def _repaint(self) -> None:
        if self.repaint_callback is not None:
            self.repaint_callback()

    # ------------------------------------------------------------- painting
    # Renderer-agnostic geometry in place of the reference's QPainter
    # bridge (lib/QPainterContext.{h,cpp}).

    def to_polygon(self, width: float, height: float):
        """Waveform outline as an [2*buckets, 2] float array of (x, y)
        points (top edge left-to-right, bottom edge back), mono-mixed."""
        mins, maxs = self.envelope()
        lo = mins.mean(axis=1)
        hi = maxs.mean(axis=1)
        n = len(lo)
        xs = np.linspace(0.0, width, n)
        mid, half = height / 2.0, height / 2.0
        top = np.stack([xs, mid - hi * half], axis=1)
        bottom = np.stack([xs[::-1], mid - lo[::-1] * half], axis=1)
        return np.concatenate([top, bottom], axis=0)

    def to_svg(self, width: int = 512, height: int = 128) -> str:
        """Self-contained SVG rendering of the current zoom window (the
        WaveFormItem::paint equivalent, lib/WaveFormItem.cpp:130-143)."""
        pts = self.to_polygon(float(width), float(height))
        path = " ".join(f"{x:.1f},{y:.1f}" for x, y in pts)
        return (
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
            f'height="{height}" viewBox="0 0 {width} {height}">'
            f'<polygon points="{path}" fill="{self.color}"/></svg>'
        )
