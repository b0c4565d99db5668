"""Run one cell of the port's benchmark once.

    python3 -m zlbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks for.
Prints, as the last line of standard output, one JSON object: `correct`,
`attempted` and `failed` (the window's blocks, and those that never reached
the sink), `metrics` (the cell's end-to-end metrics with `--trace 0`, its
per-layer metrics with `--trace 1`), `device`, with `--trace 1` a
`breakdown` (the device's readings cover the window's last
trace.TRACE_S seconds), and last `checks`: each number compared beside its limit, also
the last lines of standard error. Without a CUDA card, or with fewer cards
than the cell asks for, it prints no result and exits 2; it exits 1 if a
module of `jax`, `jaxlib`, `flax` or `libzl_tpu` was loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import check, harness, spec
from . import trace as trace_mod


def run_cell(cell, seed: int, seconds: float, traced: bool, device: str,
             t_age: float, age: float, control: bool = False) -> tuple:
    """One run: set-up, the window, the metrics, the check. `age` is the
    process's age at the host clock's `t_age`. Returns (the result line,
    the checks, names of forbidden modules loaded). `control`
    (zlbench.control only) also reads the control: the reference with its
    bank in bfloat16, in the program's place."""
    cfg = cell.config
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    s = harness.build(cell, seed, device)
    rt = s.rt
    engine = rt.engine
    run = harness.Run(cell.name, cfg["drive"], int(cfg["block_frames"]),
                      int(cfg["sample_rate"]), 0.0)
    # the traffic's timed commands, planned before the window (a bounce
    # cell names no event kind)
    w = harness.Window(cell, s, seed, seconds, run.period_s)
    plans = harness.plan_events(w)
    s.sink.keep = check.keep_rule(
        seed, s.setup_blocks, set().union(*(p.keep for _, p in plans)))
    harness.fresh_spans(engine)
    ph0 = harness.phase_totals(rt)
    counters0 = harness.engine_counters(engine)
    # the device's trace exists on a card only; it covers the window's
    # last TRACE_S seconds
    traced_device = traced and cuda
    traced_from = {}
    trace_at = None
    if traced_device:
        # prepared before the window: preparing takes seconds on a card,
        # which inside the window stalled its blocks and counted as idle
        prof = trace_mod.profiler()
        prof.prepare_trace()

        def start_trace(block: int) -> None:
            prof.start_trace()
            # the traced part starts once the profiler records
            traced_from.update(ns=time.time_ns(), block=block)
        trace_at = (max(seconds - trace_mod.TRACE_S, 0.0), start_trace)
    if cfg["drive"] == "live":
        log = harness.live(s, seconds, run, harness.sends(plans, w),
                           trace_at)
    else:
        log = harness.bounce(s, seconds, run, trace_at)
    if cuda:
        torch.cuda.synchronize(dev)
    t1_ns = time.time_ns()
    if traced_device:
        prof.stop_trace()
    run.setup_s = age + (run.t0 - t_age)
    run.phases = harness.phase_delta(ph0, harness.phase_totals(rt))
    run.counters = harness.counter_delta(counters0,
                                         harness.engine_counters(engine))
    run.spans = engine.profiler.summary()
    harness.read_events(plans, w)
    if traced_device:
        run.trace = trace_mod.read(prof, traced_from["ns"], t1_ns, log)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    expected = s.setup_blocks + run.blocks
    missing = expected - s.sink.count
    events = harness.events_for(w, plans)
    blocks = check.sample_blocks(seed, s.setup_blocks, run.blocks, events,
                                 s.sink.kept)
    delivered = {b: s.sink.block(b) for b in blocks
                 if s.sink.block(b) is not None}
    clips = [c.audio for c in s.clips]
    num_voices = int(cfg["num_voices"])
    # the program's state goes before the reference runs
    engine.drain_speculation()
    for p in s.port_clips:
        p.destroy()
    del s, rt, engine, w
    check.release_device_memory()
    forbidden = harness.forbidden_modules()
    t_ref = time.perf_counter()
    ref, work = check.reference_masters(
        cfg, clips, num_voices, events, blocks, device,
        control=control,
        work_range=((expected - run.blocks + traced_from["block"], expected)
                    if traced_device else None))
    run.work = work
    print(f"zlbench check: the reference took "
          f"{time.perf_counter() - t_ref:.2f} s for {max(blocks) + 1} "
          f"blocks", file=sys.stderr, flush=True)
    gap = (check.master_gap(delivered, ref["float32"])
           if len(delivered) == len(blocks) else float("inf"))
    checks = {
        "master_gap": {"value": gap,
                       "limit": float(cfg["limits"]["master_gap"])},
        "blocks_missing": {"value": missing, "limit": 0},
    }
    if control:
        checks["control_gap"] = {
            "value": check.master_gap(ref["bfloat16"], ref["float32"]),
            "limit": checks["master_gap"]["limit"]}
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": int(cell.workload["chips"]),
                   "memory_peak_bytes": int(peak)}
    line = {"correct": check.judge(checks), "attempted": run.blocks,
            "failed": max(missing, 0), "metrics": metrics,
            "device": device_info}
    if traced_device:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        line["breakdown"] = trace_mod.breakdown(run.trace)
    line["checks"] = checks
    return line, checks, forbidden


def main(argv=None) -> int:
    age, t_age = harness.process_age_s(), time.perf_counter()
    ap = argparse.ArgumentParser(prog="python3 -m zlbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"zlbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line, checks, forbidden = run_cell(
        cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t_age, age)
    if forbidden:
        print("zlbench: forbidden modules loaded: " + ", ".join(forbidden),
              file=sys.stderr)
        return 1
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
