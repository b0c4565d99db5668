"""The port's loader for the host-side native libraries (libzl_tpu_torch/
_native.py).

It builds native/<stem>.cpp with the reference's g++ line into a hash-named
file under the build directory, through a temporary file that `os.replace`
moves into place, so processes that build at once each load a whole
library, and nothing is written under native/. A library that cannot be
built is None, with its cause reported; the engine's host_core="native"
raises with that cause and "auto" takes the numpy program builder.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from libzl_tpu_torch import _build, _native
from libzl_tpu_torch.engine import hostcore
from libzl_tpu_torch.engine.engine import AudioEngine

REPO = Path(__file__).resolve().parent.parent

LOADER = r"""
import sys, time
from pathlib import Path
from libzl_tpu_torch import _native
start, build_dir, stem, symbol, version, opt = sys.argv[1:]
while time.time() < float(start):
    time.sleep(0.001)
lib = _native.load_native(stem, symbol, int(version), opt=opt,
                          build_dir=Path(build_dir))
assert lib is not None, _native.failure(stem)
print("loaded", getattr(lib, symbol)())
"""


def _native_listing():
    return sorted((p.name, p.stat().st_mtime_ns)
                  for p in (REPO / "native").iterdir())


@pytest.mark.parametrize("stem,symbol,version,opt", [
    ("zl_hostcore", "zl_hostcore_abi_version", 5, "-O2"),
    ("zl_stretch", "zl_stretch_abi_version", 1, "-O3"),
    ("zl_flac", "zl_flac_abi_version", 1, "-O2"),
])
def test_four_processes_build_one_library_at_once(tmp_path, stem, symbol,
                                                   version, opt):
    """Four processes ask for the same library in a fresh build directory
    at the same instant: each loads it and passes the ABI check, one
    hash-named library is left and no temporary file, and native/ is not
    written."""
    before = _native_listing()
    start = time.time() + 3.0
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-c", LOADER, repr(start), str(tmp_path), stem,
         symbol, str(version), opt], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == f"loaded {version}"
    assert [p.name for p in tmp_path.iterdir()] == [
        _native.library_path(stem, opt, tmp_path).name]
    assert _native_listing() == before


def test_missing_source_is_reported(tmp_path):
    assert _native.load_native("zl_no_such", "x", 1,
                               build_dir=tmp_path) is None
    assert "zl_no_such.cpp" in _native.failure("zl_no_such")
    assert not list(tmp_path.iterdir())


def test_wrong_abi_version_is_reported(tmp_path):
    assert _native.load_native("zl_flac", "zl_flac_abi_version", 99,
                               build_dir=tmp_path) is None
    assert "expected 99" in _native.failure("zl_flac")


@pytest.fixture
def no_compiler(tmp_path, monkeypatch):
    """A fresh build directory and no C++ compiler: the host core cannot
    be built."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native, "CXX", "zl-no-such-compiler")
    monkeypatch.setattr(_native, "_cache", {})
    monkeypatch.setattr(_native, "_failures", {})
    monkeypatch.setattr(hostcore, "_lib", None)


def test_native_host_core_raises_with_the_cause(no_compiler):
    with pytest.raises(RuntimeError, match="zl-no-such-compiler"):
        AudioEngine("cpu", num_voices=8, host_core="native")


def test_auto_host_core_reports_and_takes_numpy(no_compiler):
    with pytest.warns(RuntimeWarning, match="zl-no-such-compiler"):
        eng = AudioEngine("cpu", num_voices=8, host_core="auto")
    assert not eng.use_native_host


def test_default_build_lands_under_build_not_native():
    assert hostcore.available()
    path = _native.library_path("zl_hostcore")
    assert path.is_file()
    assert path.parent == REPO / "build" / "libzl_tpu_torch"
    assert path.name.startswith("zl_hostcore_")
