"""Configuration of the PyTorch port (counterpart of ``repro.config``)."""

from repro_torch.config.base import (
    SHAPES,
    MeshConfig,
    ModelConfig,
    RunConfig,
    ServeConfig,
    ShapeConfig,
    TrainConfig,
    VMConfig,
    shape_runs_for,
)
from repro_torch.config.registry import get_arch, get_smoke, list_archs, register_arch

__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "shape_runs_for", "MeshConfig", "TrainConfig",
    "ServeConfig", "VMConfig", "RunConfig", "register_arch", "get_arch", "get_smoke",
    "list_archs",
]
