"""bounce_rt: audio seconds the sink received in the window over the
window's wall seconds, host clock."""


def read(run):
    if run.drive != "bounce" or run.window_s <= 0:
        return None
    return run.frames / run.sample_rate / run.window_s
