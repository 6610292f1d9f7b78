from .ops import VARIANTS, slstm_scan, slstm_scan_bwd
from .ref import slstm_dr, slstm_scan_bwd_ref, slstm_scan_ref

__all__ = ["VARIANTS", "slstm_dr", "slstm_scan", "slstm_scan_bwd", "slstm_scan_bwd_ref",
           "slstm_scan_ref"]
