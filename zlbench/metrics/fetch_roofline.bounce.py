"""fetch_roofline.bounce: the fetch kernel (csrc/fetch_interp.cu) against
its bound, %: the least time the window's fetch work needs (zlbench
roofline.fetch_bound_s, from the cell's work) over the kernel's device
time in the traced window (torch.profiler, summed by kernel name)."""

from zlbench import roofline


def read(run):
    if run.trace is None or run.work is None or not run.work["blocks"]:
        return None
    t = roofline.kernel_seconds(run.trace["ops"], ("fetch_interp_kernel",))
    if t <= 0:
        return None
    return roofline.fetch_bound_s(run.work, run.block_frames) / t * 100
