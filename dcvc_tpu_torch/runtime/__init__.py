from .image_codec import DMCICodec
from .video_codec import DMCHTCodec

__all__ = ["DMCICodec", "DMCHTCodec"]
