"""Deterministic synthetic LM data pipeline (numpy, as in the JAX package).

Generates a learnable token stream (noisy affine next-token process) so
training-loss curves are meaningful without external data. Host-sharded:
every process generates only its slice of the global batch, keyed by
(seed, step, process_index), so batches are restart-safe and equal, bit
for bit, to the reference's. The process index and count default to the
``torch.distributed`` rank and world size when a process group is
initialized, else to 0 and 1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch.distributed as dist

__all__ = ["DataConfig", "SyntheticLM"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05  # fraction of random tokens


def _rank_and_world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class SyntheticLM:
    """next = (5*cur + 17) % vocab with `noise` random replacements."""

    def __init__(self, cfg: DataConfig, process_index: int | None = None,
                 process_count: int | None = None):
        rank, world = _rank_and_world()
        self.cfg = cfg
        self.pi = rank if process_index is None else process_index
        self.pc = world if process_count is None else process_count
        if cfg.global_batch % self.pc:
            raise ValueError(f"global batch {cfg.global_batch} does not split over "
                             f"{self.pc} processes")
        self.local_batch = cfg.global_batch // self.pc

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.pi])
        )
        b, s = self.local_batch, cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, size=b)
        for t in range(1, s + 1):
            toks[:, t] = (5 * toks[:, t - 1] + 17) % cfg.vocab
        mask = rng.random((b, s + 1)) < cfg.noise
        toks[mask] = rng.integers(0, cfg.vocab, size=int(mask.sum()))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
