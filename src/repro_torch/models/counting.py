"""Analytic parameter counting (counterpart of ``repro.models.counting``,
for the roofline's MODEL_FLOPS = 6 N D).

Counts come from the actual parameter tree, built on the ``meta`` device
where the reference uses ``jax.eval_shape``: shapes only, no allocation,
exact by construction.  For MoE archs the routed-expert leaves are scaled
to the ``num_experts`` real slots (padded slots are never routed), and the
active count by top_k / slots.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.utils.tree import tree_flatten_with_names


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` is ``meta``: the initializers draw
    on ``gen.device``, so every parameter is made on the meta device."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


@functools.lru_cache(maxsize=64)
def _named_shapes(cfg) -> tuple:
    from repro_torch.models.model import build_model

    params = build_model(cfg, "meta").init(_MetaGenerator())
    return tuple((name, tuple(x.shape)) for name, x in tree_flatten_with_names(params))


def _routed(cfg, name: str) -> bool:
    return cfg.num_experts > 0 and "/moe/w" in name and "shared" not in name


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def param_count(cfg) -> int:
    """Total parameters, excluding padded (never-routed) expert slots."""
    total = 0
    for name, shape in _named_shapes(cfg):
        n = _numel(shape)
        if _routed(cfg, name):
            n = n * cfg.num_experts // shape[0]    # (Ep, ...) per layer
        total += n
    return total


def embedding_param_count(cfg) -> int:
    return sum(_numel(shape) for name, shape in _named_shapes(cfg)
               if "embed" in name or "lm_head" in name)


def active_param_count(cfg) -> int:
    """Per-token active parameters (MoE: top_k of num_experts routed)."""
    total = 0
    for name, shape in _named_shapes(cfg):
        n = _numel(shape)
        if _routed(cfg, name):
            n = n * cfg.num_experts_per_tok // shape[0]
        total += n
    return total
