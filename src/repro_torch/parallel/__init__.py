"""Distribution: the multi-process work queue the guided search farms its
generation blocks to (``work_queue``); the sharding rules (``axes``), the
placement plans (``plan``) and the collectives (``collectives``) of the
(data, model) mesh; the device-sharded design-space search
(``shard_eval``); GPipe pipeline stages (``pipeline``), the
expert-parallel MoE FFN (``moe_ep``) and the int8 error-feedback
gradient all-reduce (``compression``)."""

from . import work_queue

__all__ = ["work_queue"]
