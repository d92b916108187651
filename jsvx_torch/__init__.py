"""jsvx_torch — the PyTorch / CUDA port of jsvx for one NVIDIA H100.

A second package beside :mod:`jsvx`, the JAX reference.  It imports torch
and never JAX.  The host side it shares with jsvx is framework-free:
the bitstream parsers and the C++ compact parser (``jsvx.bitstream``), the
VLC tables (``jsvx.coding``), the fixture encoder and float64 oracle
(``jsvx.tools``) and the stage metrics (``jsvx.runtime``).

* ``jsvx_torch.kernels``  — the plain PyTorch decode spec, the compact-wire
  expansion, and the hand-written CUDA fused decode kernel with its
  wrapper and build.
* ``jsvx_torch.pipeline`` — compact parse, the one-buffer wire, the GOP
  loop and :func:`transcode`, the end-to-end entry point.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level entry point (importing the package loads no torch)."""
    if name == "transcode":
        from .pipeline.transcode import transcode

        return transcode
    raise AttributeError(f"module 'jsvx_torch' has no attribute {name!r}")
