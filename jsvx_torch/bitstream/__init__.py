from .bitio import BitReader, BitWriter
from .container import (
    ContainerMeta,
    GopKeyMap,
    find_start_codes,
    parse_container_header,
)
from .parser import FrameTensors, SequenceInfo, StreamParser

__all__ = [
    "BitReader",
    "BitWriter",
    "ContainerMeta",
    "GopKeyMap",
    "find_start_codes",
    "parse_container_header",
    "FrameTensors",
    "SequenceInfo",
    "StreamParser",
]
