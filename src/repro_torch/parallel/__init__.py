"""Distribution. Ported so far: the multi-process work queue the guided
search farms its generation blocks to (``work_queue``). The sharding,
pipeline, MoE-EP and device-sharded search modules of the JAX package
are ROADMAP queue 1 item 10."""

from . import work_queue

__all__ = ["work_queue"]
