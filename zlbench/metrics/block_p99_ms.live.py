"""block_p99_ms.live: the 99th percentile, over every block of the window, of
(when the block's master reached the sink) - (its due time on the period
clock), host clock. Its runs spread too widely for a bound: a per-layer
reading beside the cell's DSP load."""

import numpy as np


def read(run):
    if run.drive != "live" or run.delivered is None:
        return None
    return float(np.percentile(run.delivered - run.due, 99)) * 1e3
