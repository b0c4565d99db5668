"""dsp_load_pct: the sum over the window's blocks of (step_blocks(1) began
-> the master reached the sink), over the window's scheduled length
(blocks x period), x 100: the load the reference reports as JACK's CPU load.
It passes 100 when the blocks take longer than their periods."""

import numpy as np


def read(run):
    if run.drive != "live" or run.delivered is None:
        return None
    return (float(np.sum(run.delivered - run.started))
            / (run.blocks * run.period_s) * 100)
