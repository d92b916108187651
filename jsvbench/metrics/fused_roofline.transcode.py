"""The fused decode kernel (kernels/fused.py -> csrc/fused_decode.cu): the
bound of the pictures decoded in the window (work.picture_work of the
stream's own pictures) over the kernel's summed device time; nothing
when the trace does not hold one launch a picture."""


def read(r):
    b = r.bounds
    gops = r.units["gops"]
    return r.roofline("fused_decode_picture_kernel",
                      b["fused_s_per_gop"] * gops,
                      b["pictures_per_gop"] * gops)
