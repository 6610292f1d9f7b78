"""The port's kernels: hand-written CUDA for Hopper, each beside its
plain PyTorch version.

Each wrapper takes its plain version for CPU tensors and launches its
CUDA kernel (``csrc/*.cu``, built by ``_build`` on first use) for CUDA
tensors, and counts those launches in its ``launches`` attribute and, by
the variant its plan picked, in ``variants``.
"""

from .adamw import adamw
from .dos_matmul import dos_matmul
from .flash_attention import decode_attention, flash_attention, flash_attention_bwd
from .grouped_matmul import grouped_matmul, grouped_matmul_dw
from .slstm import slstm_scan, slstm_scan_bwd
from .ssm_scan import ssm_scan, ssm_scan_bwd, ssm_step_ref

__all__ = ["KERNELS", "adamw", "dos_matmul", "flash_attention", "flash_attention_bwd",
           "decode_attention", "grouped_matmul", "grouped_matmul_dw", "slstm_scan", "slstm_scan_bwd", "ssm_scan",
           "ssm_scan_bwd", "ssm_step_ref", "launch_counts", "reset_launch_counts"]

# Every wrapper that launches a CUDA kernel, by kernel name.
KERNELS = {"dos_matmul": dos_matmul, "flash_attention": flash_attention,
           "flash_attention_bwd": flash_attention_bwd, "ssm_scan": ssm_scan,
           "ssm_scan_bwd": ssm_scan_bwd, "slstm_scan": slstm_scan,
           "slstm_scan_bwd": slstm_scan_bwd, "grouped_matmul": grouped_matmul,
           "grouped_matmul_dw": grouped_matmul_dw, "decode_attention": decode_attention,
           "adamw": adamw}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        fn.variants = dict.fromkeys(fn.variants, 0)
