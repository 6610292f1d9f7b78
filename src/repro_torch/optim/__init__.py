from .adamw import OptConfig, adamw_update, global_norm, init_opt_state, schedule

__all__ = ["OptConfig", "adamw_update", "global_norm", "init_opt_state", "schedule"]
