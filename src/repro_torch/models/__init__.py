"""Model zoo of the port: the decoders (dense, MoE, vision cross-attention, hybrid
Mamba2, SSM xLSTM) and the encoder-decoder (whisper)."""

from .zoo import Model, build

__all__ = ["Model", "build"]
