"""The port's kernels: hand-written CUDA for Hopper, each beside its
plain PyTorch version.

Each wrapper takes its plain version for CPU tensors and launches its
CUDA kernel (``csrc/*.cu``, built by ``_build`` on first use) for CUDA
tensors, and counts those launches in its ``launches`` attribute and, by
the variant its plan picked, in ``variants``.
"""

from .dos_matmul import dos_matmul
from .flash_attention import decode_attention, flash_attention
from .ssm_scan import ssm_scan, ssm_step_ref

__all__ = ["KERNELS", "dos_matmul", "flash_attention", "decode_attention", "ssm_scan",
           "ssm_step_ref", "launch_counts", "reset_launch_counts"]

# Every wrapper that launches a CUDA kernel, by kernel name.
KERNELS = {"dos_matmul": dos_matmul, "flash_attention": flash_attention, "ssm_scan": ssm_scan}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        fn.variants = dict.fromkeys(fn.variants, 0)
