"""setup_s: process start to the first timed block (import, the kernels
from the build cache, the bank made and uploaded, the engine's warmup, the
session started and its first blocks rendered), host clock."""


def read(run):
    return run.setup_s
