"""kernels_roofline.bounce: the render's five kernels (voice prep, fetch,
voice post, lane mixdown, finish) against the render's bound, %: the least
time the window's render work needs (zlbench roofline.render_bound_s) over
the five kernels' summed device time in the traced window."""

from zlbench import roofline


def read(run):
    if run.trace is None or run.work is None or not run.work["blocks"]:
        return None
    t = roofline.kernel_seconds(run.trace["ops"], roofline.RENDER_KERNELS)
    if t <= 0:
        return None
    return roofline.render_bound_s(run.work, run.block_frames) / t * 100
