"""Configuration of the PyTorch port (counterpart of ``repro.config``)."""

from repro_torch.config.base import ModelConfig, ServeConfig, VMConfig
from repro_torch.config.registry import get_arch, get_smoke, register_arch

__all__ = [
    "ModelConfig", "ServeConfig", "VMConfig",
    "register_arch", "get_arch", "get_smoke",
]
