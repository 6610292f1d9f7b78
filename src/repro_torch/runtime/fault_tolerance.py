"""Fault tolerance: restarts, elastic restore, straggler detection.

As in the JAX package:

- ``run_with_restarts`` supervises a training function; on failure it
  restores the latest checkpoint and re-enters. ``max_restarts`` bounds
  crash loops. Failures are injectable for tests (``FaultInjector``).
  Before it looks for the latest checkpoint it waits for the async
  writes still in flight, so that a restart never reads a step that is
  half written.
- ``elastic_restore`` loads a checkpoint onto a device, or each rank's
  shards of it onto a mesh: checkpoints hold full arrays, so the saving
  mesh may differ (the reference's (4, 2) to (2, 2)).
- ``StragglerWatchdog``: a per-step deadline from a robust moving
  estimate of step time; slow steps are counted and reported. The
  caller ends each step with a device synchronize, so a step's time is
  the device's, not the enqueue's.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import torch

from ..checkpoint import checkpointer
from ..models.params import map_tree
from ..parallel.plan import shard_tree

log = logging.getLogger("repro_torch.runtime")

__all__ = ["run_with_restarts", "elastic_restore", "StragglerWatchdog", "FaultInjector"]


@dataclasses.dataclass
class FaultInjector:
    """Deterministic fault injection for tests: raises at given steps."""

    fail_at_steps: tuple = ()
    fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


class StragglerWatchdog:
    def __init__(self, factor: float = 3.0, warmup: int = 5):
        self.factor = factor
        self.warmup = warmup
        self.times: list[float] = []
        self.slow_steps: list[int] = []
        self._t0 = None

    def start_step(self):
        self._t0 = time.monotonic()

    def end_step(self, step: int) -> bool:
        dt = time.monotonic() - self._t0
        slow = False
        if len(self.times) >= self.warmup:
            med = sorted(self.times)[len(self.times) // 2]
            if dt > self.factor * med:
                self.slow_steps.append(step)
                log.warning("straggler: step %d took %.3fs (median %.3fs)", step, dt, med)
                slow = True
        self.times.append(dt)
        if len(self.times) > 100:
            self.times.pop(0)
        return slow


def elastic_restore(ckpt_dir, step, like, device, *, specs=None, mesh=None):
    """Restore a checkpoint into the structure of ``like`` and place it on
    ``device``: whole, or, given the spec tree ``specs`` of a ``mesh``,
    this rank's shard of each leaf (the saving run may have used another
    device or mesh: checkpoints hold full arrays)."""
    host = map_tree(torch.from_numpy, checkpointer.restore(ckpt_dir, step, like))
    if specs is not None:
        host = shard_tree(host, specs, mesh)
    return map_tree(lambda x: x.to(device), host)


def run_with_restarts(make_state, train_steps, *, ckpt_dir, max_restarts: int = 3):
    """Supervise ``train_steps(state, start_step) -> state``.

    ``make_state(resume_step | None)`` builds (or restores) training
    state; on an exception the latest checkpoint is picked up and the
    loop re-enters. Returns the final state.
    """
    restarts = 0
    while True:
        checkpointer.wait_for_saves()
        resume = checkpointer.latest_step(ckpt_dir)
        state = make_state(resume)
        try:
            return train_steps(state, 0 if resume is None else resume)
        except Exception as e:  # noqa: BLE001 - supervision boundary
            restarts += 1
            log.warning("restart %d/%d after failure: %s", restarts, max_restarts, e)
            if restarts > max_restarts:
                raise
