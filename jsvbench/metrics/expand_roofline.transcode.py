"""The compact wire's expansion kernel (kernels/expand.py ->
csrc/expand.cu): the bound of the GOPs expanded in the window
(work.expand_work) over the kernel's summed device time; nothing unless
the trace holds one launch a GOP."""


def read(r):
    gops = r.units["gops"]
    return r.roofline("expand_gop_kernel",
                      r.bounds["expand_s_per_gop"] * gops, gops)
