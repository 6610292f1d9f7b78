"""Distribution: the multi-process work queue the guided search farms its
generation blocks to (``work_queue``); the sharding rules (``axes``), the
placement plans (``plan``) and the collectives (``collectives``) of the
(data, model) mesh; the device-sharded design-space search
(``shard_eval``). The JAX package's pipeline, MoE expert-parallel and
gradient-compression modules are ROADMAP queue 1 item 10 (part 2)."""

from . import work_queue

__all__ = ["work_queue"]
