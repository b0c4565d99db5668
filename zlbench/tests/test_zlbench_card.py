"""On a card: one short run of each cell through the command the driver
runs, correct and with every metric the cell names. Skips without a card
(decided inside the test)."""

import json
import subprocess
import sys

import pytest
import torch

from zlbench import spec

BENCH = spec.load_benchmark()


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.load_cell(name)
    for traced in (0, 1):
        out = subprocess.run(
            [sys.executable, "-m", "zlbench.run", "--workload", name,
             "--seed", str(2 ** 31 + 99), "--seconds", "2", "--trace",
             str(traced)], cwd=spec.ROOT, capture_output=True, text=True,
            timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"], line["checks"]
        want = cell.per_layer if traced else cell.end_to_end
        assert set(line["metrics"]) == {m["name"] for m in want}
