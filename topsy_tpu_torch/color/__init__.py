from . import surface  # noqa: F401  (registers ColorAsSurfaceMap)
from .holder import ColormapHolder

__all__ = ["ColormapHolder"]
