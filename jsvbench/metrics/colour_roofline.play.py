"""The colour kernel (kernels/color.py -> csrc/color.cu): the bound of the
frames shown (work.colour_work at the display size) over the kernel's
summed device time; nothing unless the trace holds one launch a frame."""


def read(r):
    frames = r.units["frames"]
    return r.roofline("colour_frame_kernel",
                      r.bounds["colour_s_per_frame"] * frames, frames)
