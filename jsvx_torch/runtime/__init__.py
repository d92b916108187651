from .source import ByteSource, FileSource, HttpSource, MemorySource

__all__ = ["ByteSource", "FileSource", "HttpSource", "MemorySource"]
