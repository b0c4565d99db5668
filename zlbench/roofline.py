"""The least time the card could take for the window's render, counted from
the cell's work and never from a kernel's arguments, so that it reads the
same whatever kernels do the work. The pattern is
libzl_tpu_torch/utils/roofline.py's (bytes at the H100's memory rate
against float32 work at its peak, the larger of the two), frozen here.

The work (check.reference_masters, over the window's blocks): the voices
that rendered a block (`voice_blocks`), the block's frames, and the
distinct bank frames their taps read (`read_frames`, each stereo frame
counted once however many voices read it).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet, at 700 W
F32_OPS_PER_S = 67e12       # float32 outside the tensor cores

LANES = 12                  # the sampler's lanes (master sums all of them)
STRIPS = 11                 # the global strip and the ten channels'
SEGMENTS = 4                # position segments a voice may have in a block


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def fetch_bound_s(work: dict, block_frames: int) -> float:
    """The interpolated fetch: each bank frame its taps need read once (2
    channels of float32), each voice's interpolated stereo frames written
    once; per voice, frame and channel two products and a sum."""
    vb = work["voice_blocks"] * block_frames
    return bound_s(work["read_frames"] * 8 + vb * 8, vb * 2 * 3)


def render_bound_s(work: dict, block_frames: int) -> float:
    """The whole render (voice prep, fetch, voice post, lane mixdown,
    finish): the bank frames read once, and what leaves the render written
    once: the lane mixes [12, B, 2], the three strip sends [11, B, 2], the
    lanes' peaks and RMS, the master peak and a peak a voice. Float32 work a
    voice and frame: the positions and envelope (2 S + 14), the fetch (6),
    gain, pan and peak (11); a block and frame: the master's 11 adds and
    the strips' and meters' 4 an operand."""
    B = block_frames
    nb = work["blocks"]
    vb = work["voice_blocks"]
    nbytes = (work["read_frames"] * 8
              + nb * (LANES * B * 8 + 3 * STRIPS * B * 8 + 2 * LANES * 8 + 8)
              + vb * 4)
    ops = (vb * B * (2 * SEGMENTS + 14 + 6 + 11)
           + nb * B * 2 * ((LANES - 1) + 4 * STRIPS + 4 * LANES))
    return bound_s(nbytes, ops)


# the hand-written kernels of the render, by the names the trace gives them
RENDER_KERNELS = ("voice_prep_kernel", "fetch_interp_kernel",
                  "voice_post_kernel", "lane_mixdown_kernel",
                  "finish_block_kernel", "finish_combine_kernel")


def kernel_seconds(ops: dict, names) -> float:
    """Summed device seconds of the trace's ops whose names hold any of
    `names`; 0.0 when none ran."""
    return sum(s for k, (s, _) in ops.items()
               if any(n in k for n in names))
