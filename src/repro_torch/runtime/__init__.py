from .fault_tolerance import FaultInjector, StragglerWatchdog, elastic_restore, run_with_restarts

__all__ = ["FaultInjector", "StragglerWatchdog", "elastic_restore", "run_with_restarts"]
