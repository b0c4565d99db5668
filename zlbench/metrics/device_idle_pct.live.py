"""device_idle_pct.live: 1 - the union of the card's kernel and copy
intervals over the traced window (torch.profiler), %."""


def read(run):
    if run.trace is None or run.drive != "live":
        return None
    return (1.0 - run.trace["busy_s"] / run.trace["window_s"]) * 100
