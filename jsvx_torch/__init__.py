"""jsvx_torch — the PyTorch / CUDA port of jsvx for one NVIDIA H100.

A second package beside :mod:`jsvx`, the JAX reference.  It imports torch
and nothing of JAX or of the jsvx package: it carries its own copies of
the host side (``bitstream``, with the C++ parser in ``native``;
``coding``; ``tools``, the fixture encoder and float64 oracle; ``runtime``,
the stage metrics, sources and GOP manifest; ``utils``).  Its entry points
run on the CUDA card unless the caller passes ``device="cpu"``.

* ``jsvx_torch.kernels``  — the plain PyTorch decode spec, the compact-wire
  expansion, the sideband expansion, and the hand-written CUDA kernels
  (fused decode; motion compensation and reconstruction, the two-kernel
  route) with their wrappers and build.
* ``jsvx_torch.pipeline`` — compact and dense parse, the one-buffer wire,
  the GOP loop, :func:`transcode` (the batch entry point) and
  :class:`StreamDecoder` (the whole-stream decode behind
  ``python -m jsvx_torch decode``).
* ``jsvx_torch.api``      — :class:`Decoder` and :class:`Player`, jsvx's
  streaming API with its device methods on torch (behind
  ``python -m jsvx_torch play``).
* ``jsvx_torch.kernels.color`` — display colour (YCbCr -> RGB): one launch
  of the hand-written colour kernel (``csrc/color.cu``) a frame on a card.
* ``jsvx_torch.shard``     — the multi-rank decode over
  ``torch.distributed`` (row bands, GOPs over ranks).
* ``jsvx_torch.graft_entry`` — the driver entry points: ``entry()`` and
  ``dryrun_multichip(n)`` (``python -m jsvx_torch.graft_entry``).
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level entry points (importing the package loads no torch)."""
    if name == "transcode":
        from .pipeline.transcode import transcode

        return transcode
    if name == "StreamDecoder":
        from .pipeline.stream import StreamDecoder

        return StreamDecoder
    if name in ("Player", "Decoder", "PlayerConfig"):
        from . import api

        return getattr(api, name)
    raise AttributeError(f"module 'jsvx_torch' has no attribute {name!r}")
