"""Model zoo of the port: the dense, hybrid (Mamba2) and SSM (xLSTM) decoders."""

from .zoo import Model, build

__all__ = ["Model", "build"]
