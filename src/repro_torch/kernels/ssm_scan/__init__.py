from .ops import (
    CHUNK, CHUNKS, STATE_DIMS, VARIANTS, plan, ssm_scan, ssm_scan_bwd, ssm_scan_chunked,
)
from .ref import ssm_scan_bwd_ref, ssm_scan_ref, ssm_step_ref

__all__ = ["CHUNK", "CHUNKS", "STATE_DIMS", "VARIANTS", "plan", "ssm_scan", "ssm_scan_bwd",
           "ssm_scan_bwd_ref", "ssm_scan_chunked", "ssm_scan_ref", "ssm_step_ref"]
