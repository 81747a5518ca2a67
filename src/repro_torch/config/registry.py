"""Architecture registry: configs register themselves on import
(counterpart of ``repro.config.registry``).

``get_arch("qwen2-moe-a2.7b")`` returns the full config and
``get_smoke(...)`` the reduced same-family config of the CPU tests.  The
port registers all ten archs of the JAX package.
"""

from __future__ import annotations

import importlib

from repro_torch.config.base import ModelConfig

_ARCHS: dict[str, ModelConfig] = {}
_SMOKE: dict[str, ModelConfig] = {}

_ARCH_MODULES = {
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "granite-34b": "repro_torch.configs.granite_34b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
}


def register_arch(full: ModelConfig, smoke: ModelConfig) -> None:
    _ARCHS[full.name] = full
    _SMOKE[full.name] = smoke


def _ensure(name: str) -> None:
    if name in _ARCHS:
        return
    if name in _ARCH_MODULES:
        importlib.import_module(_ARCH_MODULES[name])
        return
    raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")


def get_arch(name: str) -> ModelConfig:
    _ensure(name)
    return _ARCHS[name]


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


def get_smoke(name: str) -> ModelConfig:
    _ensure(name)
    return _SMOKE[name]
