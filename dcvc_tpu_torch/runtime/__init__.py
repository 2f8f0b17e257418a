from .image_codec import DMCICodec
from .video_codec import DMCHTCodec, DMCLDCodec

__all__ = ["DMCICodec", "DMCHTCodec", "DMCLDCodec"]
