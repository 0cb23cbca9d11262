"""Architecture registry: ``get_config(arch_id)`` + the assigned shape set."""
from repro_torch.configs.base import (
    ModelConfig,
    ShapeConfig,
    SHAPES,
    cell_is_supported,
    reduced,
)

_MODULES = {
    "mamba2-780m": "mamba2_780m",
    "qwen1.5-0.5b": "qwen15_05b",
    "gemma3-12b": "gemma3_12b",
    "olmo-1b": "olmo_1b",
    "gemma-2b": "gemma_2b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "hymba-1.5b": "hymba_1p5b",
    "internvl2-26b": "internvl2_26b",
    "hubert-xlarge": "hubert_xlarge",
}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    import importlib

    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "cell_is_supported",
    "reduced",
    "get_config",
    "ARCH_IDS",
]
