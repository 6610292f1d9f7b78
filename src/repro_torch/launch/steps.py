"""Step factories: prefill_step / serve_step.

The functions the serving loop calls; they close over the model. The
train step waits for the flash backward (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

__all__ = ["make_prefill_step", "make_serve_step"]


def make_prefill_step(model, *, max_len: int = 0):
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len=max_len)

    return prefill_step


def make_serve_step(model):
    def serve_step(params, cache, batch):
        return model.decode(params, cache, batch)

    return serve_step
