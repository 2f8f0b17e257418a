from .image_codec import DMCICodec

__all__ = ["DMCICodec"]
