"""xrun_pct.live: the share of the window's blocks whose master reached the
sink more than one period after it was due (the sound card would have
played silence), %, host clock. Its runs spread too widely for a bound:
a per-layer reading beside the cell's DSP load."""

import numpy as np


def read(run):
    if run.drive != "live" or run.delivered is None:
        return None
    late = (run.delivered - run.due) > run.period_s
    return float(np.mean(late)) * 100
