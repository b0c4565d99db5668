"""The port's CLI (libzl_tpu_torch/cli.py) on the CPU.

`render`, `play`, `env`, `trace` and `thumbnail` run with `--device cpu`;
`render` agrees with the reference CLI's render (numpy backend) within the
bus tolerance (rtol 1e-5, atol 2e-6 for the one voice) plus one step of the
16-bit WAV both write (1/32767), and `thumbnail` writes the reference's SVG
byte for byte. `--device cuda` without a card exits 2 with a message.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from libzl_tpu.cli import main as ref_main
from libzl_tpu.engine import hostcore as ref_hostcore
from libzl_tpu_torch.cli import main
from libzl_tpu_torch.io.wav import read_wav, write_wav

SR = 48000
REPO = Path(__file__).resolve().parent.parent
WAV_STEP = 1.0 / 32767.0


def make_tone(path, seconds=0.5, freq=440.0):
    t = np.arange(int(SR * seconds)) / SR
    write_wav(path, (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
              [:, None], SR)


def test_render_loop_cpu(tmp_path, capsys):
    src, out = tmp_path / "in.wav", tmp_path / "out.wav"
    make_tone(src, seconds=0.2)
    assert main(["render", str(src), str(out), "--loop", "--seconds", "1",
                 "--device", "cpu"]) == 0
    assert "device=cpu" in capsys.readouterr().out
    a = read_wav(out)
    assert a.duration_seconds > 0.9
    # still audible at the end: it looped past its 0.2 s length
    assert np.abs(a.samples[-4800:]).max() > 0.05


@pytest.mark.parametrize("extra", [
    [],
    ["--loop", "--note", "67", "--pan", "0.4", "--attack", "0.01"],
])
def test_render_matches_reference_cli(tmp_path, monkeypatch, extra):
    # the reference engine takes its numpy program builder (held bit-equal
    # to the native core by tests/test_hostcore.py): no port test builds
    # the reference's native/ libraries
    monkeypatch.setattr(ref_hostcore, "available", lambda: False)
    src = tmp_path / "in.wav"
    make_tone(src, seconds=0.3)
    outs = {}
    for name, fn, dev in (("port", main, ["--device", "cpu"]),
                          ("ref", ref_main, ["--backend", "numpy"])):
        outs[name] = tmp_path / f"{name}.wav"
        assert fn(["render", str(src), str(outs[name]), "--seconds", "0.6",
                   "--quiet", *dev, *extra]) == 0
    got, want = (read_wav(outs[k]).samples for k in ("port", "ref"))
    assert got.shape == want.shape and np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6 + WAV_STEP)


def test_env_cpu(capsys):
    assert main(["env", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"torch {torch.__version__}" in out
    for line in ("device: cpu", "fetch resolution (auto): gather",
                 "kernel library", "native host core",
                 "lookahead horizon: 16 blocks", "stretch backend"):
        assert line in out, line


def test_env_reports_the_pitch_envelope(capsys):
    """The env report names the fetch and its one pitch envelope, past
    which a block renders through the gather fetch."""
    assert main(["env", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert ("fetch resolution (auto): gather, pitch envelope 4.0 (past it: "
            "the gather fetch)") in out
    assert "ladder" not in out and "rung" not in out


def test_trace_cpu(tmp_path, capsys):
    src, out = tmp_path / "in.wav", tmp_path / "trace"
    make_tone(src, seconds=0.2)
    assert main(["trace", str(src), str(out), "--blocks", "3", "--voices",
                 "16", "--device", "cpu"]) == 0
    files = list(out.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_trace_holds_the_program_spans(tmp_path):
    """The CLI's trace holds the engine's spans (utils/profiling's record)
    on the profiler's clock: each block's process_block with its commands
    inside it, before the profiler's copy of the last block's master."""
    src, out = tmp_path / "in.wav", tmp_path / "trace"
    make_tone(src, seconds=0.2)
    assert main(["trace", str(src), str(out), "--blocks", "3", "--voices",
                 "16", "--device", "cpu"]) == 0
    (path,) = out.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    blocks = [e for e in spans if e["name"] == "process_block"]
    numbers = [e["args"]["block"] for e in blocks]
    assert numbers == list(range(numbers[0], numbers[0] + 3))
    for b in blocks:
        inner = [e for e in spans if e["name"] == "commands"
                 and e["args"]["parent"] == b["args"]["id"]]
        assert len(inner) == 1
        assert b["ts"] <= inner[0]["ts"] <= inner[0]["ts"] + inner[0][
            "dur"] <= b["ts"] + b["dur"] + 1e-3
    # the last block's master is copied to the host after the blocks: the
    # profiler's op starts after the last span ends, within a second
    end = blocks[-1]["ts"] + blocks[-1]["dur"]
    copies = [e["ts"] for e in events if e.get("cat") == "cpu_op"
              and e["name"] == "aten::to" and e["ts"] >= blocks[0]["ts"]]
    assert copies and end <= min(copies) <= end + 1e6


def test_thumbnail_matches_reference_cli(tmp_path):
    src = tmp_path / "in.wav"
    make_tone(src)
    for args in ([], ["--start", "0.1", "--end", "0.15", "--buckets", "64"]):
        port, ref = tmp_path / "port.svg", tmp_path / "ref.svg"
        assert main(["thumbnail", str(src), str(port), "--device", "cpu",
                     "--color", "#3fb950", *args]) == 0
        assert ref_main(["thumbnail", str(src), str(ref), "--color",
                         "#3fb950", *args]) == 0
        assert port.read_text() == ref.read_text()


def test_play_file_sink_cpu(tmp_path, capsys):
    """The wall-clock pump into a file sink. How many blocks land in the
    0.3 s depends on the host's speed (the CPU path may render slower than
    realtime on a loaded host), so the check is on what landed."""
    src, out = tmp_path / "in.wav", tmp_path / "live.wav"
    make_tone(src, seconds=0.3)
    assert main(["play", str(src), "--sink", f"file:{out}", "--device", "cpu",
                 "--seconds", "0.3"]) == 0
    assert "device=cpu" in capsys.readouterr().out
    a = read_wav(out)
    assert a.num_frames > 0 and a.num_frames % 128 == 0
    assert np.abs(np.asarray(a.samples)).max() > 0.05


def test_reference_commands(tmp_path, capsys):
    """info, convert and stretch: the port's copies of the reference's
    commands."""
    src = tmp_path / "in.wav"
    make_tone(src, seconds=0.5)
    assert main(["info", str(src)]) == 0
    assert "48000 Hz" in capsys.readouterr().out
    out = tmp_path / "slow.wav"
    assert main(["stretch", str(src), str(out), "--speed", "0.5",
                 "--quiet"]) == 0
    assert abs(read_wav(out).duration_seconds - 1.0) < 0.01
    assert main(["convert", str(src), str(tmp_path / "x.xyz")]) == 2


@pytest.mark.parametrize("cmd", ["render", "env", "thumbnail"])
def test_cuda_without_a_card_exits_2(tmp_path, capsys, cmd):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = tmp_path / "in.wav"
    make_tone(src, seconds=0.1)
    argv = {"render": ["render", str(src), str(tmp_path / "o.wav")],
            "env": ["env"],
            "thumbnail": ["thumbnail", str(src), str(tmp_path / "t.svg")]}
    assert main(argv[cmd]) == 2           # --device defaults to cuda
    err = capsys.readouterr().err
    assert "--device cuda" in err and "is_available" in err
    assert not (tmp_path / "o.wav").exists()


def test_bad_device_and_missing_file(tmp_path, capsys):
    assert main(["env", "--device", "tpu"]) == 2
    assert "--device tpu" in capsys.readouterr().err
    assert main(["thumbnail", "/nonexistent.wav", str(tmp_path / "x.svg"),
                 "--device", "cpu"]) == 2
    assert "no such file" in capsys.readouterr().err


def test_module_entry_point(tmp_path):
    """`python -m libzl_tpu_torch.cli` (the libzl-tpu-torch script)."""
    src = tmp_path / "in.wav"
    make_tone(src, seconds=0.1)
    proc = subprocess.run(
        [sys.executable, "-m", "libzl_tpu_torch.cli", "info", str(src)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "48000 Hz" in proc.stdout


def test_device_trace(tmp_path):
    """utils/profiling.device_trace: a Chrome trace of the region on the
    CPU; a CUDA trace without a card raises before profiling anything."""
    from libzl_tpu_torch.utils.profiling import device_trace

    with device_trace(str(tmp_path / "t"), "cpu") as path:
        torch.ones(64).sum()
    events = json.loads(Path(path).read_text())["traceEvents"]
    assert any(e.get("name") == "aten::sum" for e in events)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            with device_trace(str(tmp_path / "c"), "cuda"):
                pass
