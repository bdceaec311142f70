from .holder import ColormapHolder

__all__ = ["ColormapHolder"]
