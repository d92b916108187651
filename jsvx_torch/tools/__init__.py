from .encoder import EncoderConfig, JsvEncoder, encode_frames
from .oracle import OracleDecoder, decode_stream_oracle
from .psnr import psnr

__all__ = [
    "EncoderConfig",
    "JsvEncoder",
    "encode_frames",
    "OracleDecoder",
    "decode_stream_oracle",
    "psnr",
]
