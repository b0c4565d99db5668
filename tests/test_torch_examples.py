"""The port's examples stay runnable: each one headless in a subprocess on
the CPU at a small size, as tests/test_examples.py runs the reference's.
Without --device they would take the card ("cuda", the default), so a
default run without one must fail rather than land on the CPU."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from libzl_tpu_torch.io.wav import read_audio

REPO = Path(__file__).resolve().parents[1]


def _run(args, cwd, timeout=300, ok=True):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", *args], cwd=cwd, env=env, timeout=timeout,
        capture_output=True, text=True,
    )
    if ok:
        assert proc.returncode == 0, (
            f"{args[0]} exited {proc.returncode}\nstdout:\n{proc.stdout}\n"
            f"stderr:\n{proc.stderr}")
    return proc


def test_groovebox_demo(tmp_path):
    out = tmp_path / "groove.wav"
    proc = _run(["libzl_tpu_torch.examples.groovebox_demo", str(out),
                 "--device", "cpu", "--bars", "1"], tmp_path)
    audio = read_audio(str(out))
    assert audio.sample_rate == 48000
    assert audio.samples.shape[0] >= 48000      # one bar at 120 bpm = 2 s
    assert float(np.abs(audio.samples).max()) > 0.01
    assert "session checkpoint" in proc.stdout
    doc = json.loads(Path(str(out) + ".zlsession").read_text())
    assert doc["format_version"] == 1 and len(doc["clips"]) == 4
    assert doc["bpm"] == 120.0


def test_multichip_demo(tmp_path):
    out = tmp_path / "mesh.wav"
    proc = _run(["libzl_tpu_torch.examples.multichip_demo", str(out),
                 "--device", "cpu", "--shards", "4", "--voices", "512",
                 "--seconds", "1"], tmp_path)
    assert "mesh: 4 shards on cpu" in proc.stdout
    audio = read_audio(str(out))
    assert audio.samples.shape[0] > 0
    assert float(np.abs(audio.samples).max()) > 0.01


def test_examples_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        return
    for name in ("groovebox_demo", "multichip_demo"):
        proc = _run([f"libzl_tpu_torch.examples.{name}",
                     str(tmp_path / "x.wav")], tmp_path, ok=False)
        assert proc.returncode != 0
        assert "CUDA" in proc.stderr or "is_available" in proc.stderr
        assert not (tmp_path / "x.wav").exists()
