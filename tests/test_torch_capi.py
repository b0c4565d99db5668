"""The port's libzl.so: native/libzl_shim.cpp built over the port's bridge.

`_build.build_shim` compiles the shim unchanged through
csrc/libzl_shim_torch.cpp, which points its one import at
libzl_tpu_torch.capi.bridge. Here, on the CPU (LIBZL_TPU_BACKEND=cpu): every
bridge name the shim calls is a callable of the port's bridge, the library
exports the reference build's symbols, and it carries the ctypes client
(`libzl_tpu_torch.capi.abi_client`), the C embedding (native/embed_smoke.c)
and the full-symbol drive of tests/test_capi.py — each in a subprocess,
since the shim owns process-global engine state.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_capi import CLIENT_FULL as REF_CLIENT_FULL

REPO = Path(__file__).resolve().parent.parent
NATIVE = REPO / "native"
PORT_IMPORT = "from libzl_tpu_torch.capi import bridge"
# the reference's client with every import of the reference's modules (its
# bridge, clip registry and WAV I/O) pointed at the port's
CLIENT_FULL = REF_CLIENT_FULL.replace("from libzl_tpu.", "from libzl_tpu_torch.")


@pytest.fixture(scope="module")
def libzl_so():
    from libzl_tpu_torch import _build

    return _build.build_shim()


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), LIBZL_TPU_BACKEND="cpu",
               LIBZL_TPU_VOICES="32", JAX_PLATFORMS="cpu")
    env.update(extra)
    return env


def shim_bridge_calls() -> set:
    """Every bridge attribute native/libzl_shim.cpp reaches by name."""
    src = (NATIVE / "libzl_shim.cpp").read_text()
    names = set(re.findall(r'\bcall\("(\w+)"', src))
    names |= set(re.findall(
        r'PyObject_(?:CallMethod|GetAttrString)\(\s*(?:g_bridge|module),\s*'
        r'"(\w+)"', src))
    return names


def test_abi_surface_is_the_port_bridge():
    from libzl_tpu_torch.capi import bridge

    names = shim_bridge_calls()
    # the three call forms: call("..."), CallMethod (init/shutdown),
    # GetAttrString (stopClips)
    assert {"init_engine", "shutdown_engine", "stop_clips", "clip_new",
            "passthrough_get"} <= names
    assert len(names) >= 45
    missing = sorted(n for n in names if not callable(getattr(bridge, n,
                                                              None)))
    assert not missing, missing


def test_library_exports_the_reference_symbols(libzl_so):
    """The port's library exports what libzl.h declares, and imports only
    the port's bridge."""
    header = re.sub(r"/\*.*?\*/|//[^\n]*", "",
                    (NATIVE / "libzl.h").read_text(), flags=re.S)
    declared = set(re.findall(r"\b(\w+)\s*\([^;{]*\)\s*;", header))
    out = subprocess.run(["nm", "-D", "--defined-only", str(libzl_so)],
                         capture_output=True, text=True, check=True).stdout
    exported = {line.split()[-1] for line in out.splitlines()
                if " T " in line}
    assert {"initJuce", "shutdownJuce", "ClipAudioSource_new",
            "SyncTimer_startTimer", "AudioLevels_startRecording",
            "JackPassthrough_setMuted"} <= declared
    assert declared <= exported, sorted(declared - exported)
    blob = Path(libzl_so).read_bytes()
    assert b"libzl_tpu_torch.capi.bridge" in blob
    assert b"libzl_tpu.capi.bridge" not in blob


def test_ctypes_client_end_to_end(libzl_so):
    proc = subprocess.run(
        [sys.executable, "-m", "libzl_tpu_torch.capi.abi_client",
         str(libzl_so)],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CAPI-OK device=cpu" in proc.stdout


def test_c_host_embedding(libzl_so, tmp_path):
    """True embedding: a C binary links the port's libzl.so, initJuce boots
    the interpreter and the port's engine (its pump on the CPU), the clip
    API works, clean shutdown."""
    shutil.copy(libzl_so, tmp_path / "libzl.so")
    binary = tmp_path / "embed_smoke"
    subprocess.run(
        ["gcc", "-O1", "-o", str(binary), str(NATIVE / "embed_smoke.c"),
         "-I", str(NATIVE), "-L", str(tmp_path), "-l:libzl.so",
         f"-Wl,-rpath,{tmp_path}"],
        check=True, capture_output=True,
    )
    wav = tmp_path / "embed.wav"
    t = np.arange(48000) / 48000
    from libzl_tpu_torch.io.wav import write_wav

    write_wav(wav, (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32),
              48000)
    proc = subprocess.run([str(binary), str(wav)], env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "EMBED-OK" in proc.stdout


def test_ctypes_full_symbol_surface(libzl_so, tmp_path):
    """tests/test_capi.py's drive of every public header symbol (parameter
    round trips, callback trampolines, bar-quantized queueing, stopClips
    arrays, port recording, env reload, destroy/byID), against the port."""
    assert CLIENT_FULL.count(PORT_IMPORT) == 1
    env = _env(ZL_REPO=str(REPO), ZL_SO=str(libzl_so),
               ZL_WAV=str(tmp_path / "in.wav"),
               ZL_PORTS=str(tmp_path / "ports.wav"), LIBZL_TPU_NO_PUMP="1")
    env.pop("ZYNTHIAN_MIDI_FILTER_OUTPUT", None)
    proc = subprocess.run([sys.executable, "-c", CLIENT_FULL], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    assert "CAPI-FULL-OK" in proc.stdout
