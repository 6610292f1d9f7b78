"""Model zoo of the port: the dense decoder."""

from .zoo import Model, build

__all__ = ["Model", "build"]
