"""No process of the benchmark loads `jax`, `jaxlib`, `flax` or
`libzl_tpu`, by whole top-level name (`libzl_tpu_torch` begins with
`libzl_tpu` and is the program); without the program the command fails
and prints no result."""

import json
import os
import shutil
import subprocess
import sys

from zlbench import harness, spec

SNIPPET = """
import json, sys
from zlbench.tests.tiny import KEYS, run_tiny
line, checks, forbidden = run_tiny("live-loops", seconds=0.3, traffic=KEYS)
print(json.dumps({"correct": line["correct"], "forbidden": forbidden,
                  "loaded": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "libzl_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert "libzl_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "libzl_tpu.ops", sys)
    assert harness.forbidden_modules() == ["libzl_tpu.ops"]


def test_a_run_loads_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", SNIPPET], cwd=spec.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["forbidden"] == []
    assert "libzl_tpu_torch" in res["loaded"]
    assert not {"jax", "jaxlib", "flax", "libzl_tpu"} & set(res["loaded"])


def test_without_the_program_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "zlbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "zlbench.run", "--workload", "live-loops",
         "--seed", str(2 ** 32 + 5), "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env={k: v for k, v in os.environ.items()
                           if k != "PYTHONPATH"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
