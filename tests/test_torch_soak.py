"""The randomized soak on the port (libzl_tpu_torch/soak.py), on the CPU.

The reference's three cases (tests/test_soak.py:180-195) on the port's
engine: plain traffic per-block, the shorter run sized by
tests/_budget.fuzz_blocks on the engine's defaults (the lookahead horizon
and its speculative chain), and extended traffic (deferred re-renders,
recording toggles, session checkpoints). Beyond the reference: a run on a
4-shard mesh, extended traffic under the lookahead horizon, and a lockstep
run in which an unsharded and a 4-shard engine take the same command
stream and give the same master and lane meters, bit for bit, every block
(ops/mixdown.py's carried fold under BPM changes, strip fuzz, transport
toggles and lane toggles).
"""

import numpy as np
import pytest

from libzl_tpu_torch.parallel.sharding import make_mesh
from libzl_tpu_torch.soak import Soak, SoakFailure, soak
from tests._budget import fuzz_blocks


def test_soak_random_traffic():
    soak("cpu", 3000, 1234, lookahead=0)


def test_soak_default_engine():
    """Shorter run through the engine's defaults: horizons, the chain,
    events that preempt them."""
    r = soak("cpu", fuzz_blocks(quick=300, full=600), 99)
    assert r["slo_by_kind"]["horizon"][1] > 0


def test_soak_extended_traffic(tmp_path):
    soak("cpu", 1200, 4321, extended=True, tmp_dir=str(tmp_path),
         lookahead=0)


def test_soak_on_a_mesh():
    soak("cpu", 800, 2468, mesh=make_mesh(devices=["cpu"] * 4), lookahead=0)


def test_soak_extended_traffic_with_lookahead(tmp_path):
    r = soak("cpu", 500, 1357, extended=True, tmp_dir=str(tmp_path),
             lookahead="auto")
    assert r["slo_by_kind"]["horizon"][1] > 0


@pytest.mark.parametrize("lookahead", [0, "auto"])
def test_soak_lockstep_mesh_is_bit_equal(lookahead):
    """One seed, two engines: unsharded and on ["cpu"] * 4. Master, lane
    mix, lane peaks and lane RMS bit-equal every block."""
    runs = [Soak("cpu", 777, lookahead=lookahead),
            Soak("cpu", 777, lookahead=lookahead,
                 mesh=make_mesh(devices=["cpu"] * 4))]
    loud = 0
    for b in range(400):
        one, four = (r.step() for r in runs)
        for name in ("master", "lane_mix", "lane_peaks", "lane_rms"):
            np.testing.assert_array_equal(
                getattr(four, name).numpy(), getattr(one, name).numpy(),
                err_msg=f"{name} at block {b}")
        loud += float(one.master.abs().max()) > 0.05
    assert loud > 100
    for r in runs:
        r.finish()


def test_soak_reports_a_broken_invariant(monkeypatch):
    """A non-finite block fails the run with its block number."""
    run = Soak("cpu", 5, lookahead=0)
    real = run.engine.process_block

    def poisoned():
        res = real()
        res.outputs.master[0, 0] = float("nan")
        return res

    monkeypatch.setattr(run.engine, "process_block", poisoned)
    with pytest.raises(SoakFailure, match="non-finite output at block 0"):
        run.step()
