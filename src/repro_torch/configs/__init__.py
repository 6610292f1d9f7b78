"""Architecture config registry of the port: the 10 assigned archs.

``get_config(name)`` returns the full ArchConfig; ``reduced(cfg)``
(from repro_torch.config) gives the smoke-test sizing. The configs are
copies of the JAX package's, so the Study front door and the network
lowering see the same zoo. ``models.build`` builds every one of them.
"""

from __future__ import annotations

from ..config import ArchConfig, ShapeConfig, SHAPES, reduced  # noqa: F401
from .deepseek_moe_16b import CONFIG as deepseek_moe_16b
from .gemma3_1b import CONFIG as gemma3_1b
from .llama32_vision_11b import CONFIG as llama32_vision_11b
from .llama4_scout_17b import CONFIG as llama4_scout_17b
from .qwen25_3b import CONFIG as qwen25_3b
from .qwen2_72b import CONFIG as qwen2_72b
from .smollm_135m import CONFIG as smollm_135m
from .whisper_medium import CONFIG as whisper_medium
from .xlstm_125m import CONFIG as xlstm_125m
from .zamba2_27b import CONFIG as zamba2_27b

REGISTRY: dict[str, ArchConfig] = {
    c.name: c
    for c in [
        llama32_vision_11b,
        smollm_135m,
        qwen25_3b,
        qwen2_72b,
        gemma3_1b,
        whisper_medium,
        zamba2_27b,
        deepseek_moe_16b,
        llama4_scout_17b,
        xlstm_125m,
    ]
}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def cells():
    """All live (arch, shape) dry-run cells + documented skips.

    long_500k needs sub-quadratic attention: it runs only for
    SSM/hybrid/sliding-window archs.
    """
    live, skipped = [], []
    for arch in REGISTRY.values():
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not arch.is_subquadratic:
                skipped.append((arch.name, shape.name, "full attention at 500k"))
                continue
            live.append((arch.name, shape.name))
    return live, skipped
