"""Model zoo of the port: the dense and hybrid (Mamba2) decoders."""

from .zoo import Model, build

__all__ = ["Model", "build"]
