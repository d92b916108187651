from . import tables
from .vlc import VLCTable, build_lut

__all__ = ["tables", "VLCTable", "build_lut"]
