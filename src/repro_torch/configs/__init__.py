"""Architecture config registry of the port: the dense and hybrid families.

``get_config(name)`` returns the full ArchConfig; ``reduced(cfg)``
(from repro_torch.config) gives the smoke-test sizing. The configs are
copies of the JAX package's; only the families whose decoder branch is
ported are registered here.
"""

from __future__ import annotations

from ..config import ArchConfig, ShapeConfig, SHAPES, reduced  # noqa: F401
from .gemma3_1b import CONFIG as gemma3_1b
from .qwen25_3b import CONFIG as qwen25_3b
from .qwen2_72b import CONFIG as qwen2_72b
from .smollm_135m import CONFIG as smollm_135m
from .zamba2_27b import CONFIG as zamba2_27b

REGISTRY: dict[str, ArchConfig] = {
    c.name: c for c in [smollm_135m, qwen25_3b, qwen2_72b, gemma3_1b, zamba2_27b]
}

# Archs of the JAX package whose families the port does not run yet
# (ROADMAP queue 1 orders them), by family.
NOT_PORTED = {
    "llama-3.2-vision-11b": "vlm",
    "whisper-medium": "encdec",
    "deepseek-moe-16b": "moe",
    "llama4-scout-17b-a16e": "moe",
    "xlstm-125m": "ssm",
}


def get_config(name: str) -> ArchConfig:
    if name in NOT_PORTED:
        raise KeyError(
            f"arch {name!r} (family {NOT_PORTED[name]!r}) is not ported to "
            f"repro_torch yet; see ROADMAP queue 1"
        )
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
