"""The benchmark's plain reference: a frozen copy of the port's VLC tables,
pure-Python parser and float64 oracle, in numpy.  It imports nothing of the
program (``jsvx_torch``) and nothing of JAX or ``jsvx``."""
