"""Optimizers (counterpart of ``repro.train.optimizer``): AdamW with f32
moments and decoupled weight decay, Lion, and plain SGD; cosine / linear /
constant LR schedules with linear warmup; global-norm clipping.

The arithmetic is the reference's, in its order and in f32: gradients are
clipped in f32, ``upd`` casts p to f32, adds the decay on matrices only
(ndim >= 2) and casts back, so params keep their dtype.  The schedule and
the bias corrections are host numbers, computed in numpy float32 from the
step.  Unlike the reference, the update writes the moments and the params
in place (under ``no_grad``), so a step holds one copy of each on the card.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.config import TrainConfig
from repro_torch.utils.tree import tree_global_norm, tree_leaves, tree_map

_F32 = np.float32


class OptState(NamedTuple):
    step: torch.Tensor   # () int32 on the host
    m: Any               # first moment (f32), a tree like params; () for sgd
    v: Any               # second moment (f32); () for lion and sgd


def lr_schedule(cfg: TrainConfig, step) -> float:
    """The learning rate at ``step`` (an int or a 0-d tensor), in f32."""
    step = _F32(int(step))
    warm = np.minimum(step / _F32(max(cfg.warmup_steps, 1)), _F32(1.0))
    if cfg.lr_schedule == "constant":
        decay = _F32(1.0)
    else:
        frac = np.clip((step - _F32(cfg.warmup_steps))
                       / _F32(max(cfg.total_steps - cfg.warmup_steps, 1)), _F32(0), _F32(1))
        if cfg.lr_schedule == "linear":
            decay = _F32(1.0) - frac
        else:  # cosine
            decay = _F32(0.5) * (_F32(1.0) + np.cos(_F32(np.pi) * frac))
    return float(_F32(cfg.lr) * warm * decay)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in f32; the
    norm before clipping)."""
    norm = tree_global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


def _f32_zeros_like(tree):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), tree)


def _scalar() -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32)


def _step0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def adamw_init(params) -> OptState:
    return OptState(step=_step0(), m=_f32_zeros_like(params), v=_f32_zeros_like(params))


@torch.no_grad()
def _apply(cfg: TrainConfig, params, grads, opt: OptState, upd) -> tuple:
    """Clip, advance the step and call ``upd(p, g32, i)`` on every leaf
    (i its index in ``tree_leaves`` order).  Returns the reference's
    (params, opt, metrics)."""
    gnorm = tree_global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = opt.step + 1
    lr = lr_schedule(cfg, step)
    for i, (p, g) in enumerate(zip(tree_leaves(params), tree_leaves(grads))):
        upd(p, g.to(torch.float32) * scale, i, lr, int(step))
    return params, opt._replace(step=step), {"grad_norm": gnorm, "lr": lr}


def adamw_update(cfg: TrainConfig, params, grads, opt: OptState):
    """Returns (params, opt, metrics); params and moments are updated in
    place.  Grads may be any float dtype; moments and update math are f32;
    params keep their dtype."""
    b1, b2 = cfg.beta1, cfg.beta2
    ms, vs = tree_leaves(opt.m), tree_leaves(opt.v)

    def upd(p, g, i, lr, step):
        bc1 = float(_F32(1.0) - _F32(b1) ** _F32(step))
        bc2 = float(_F32(1.0) - _F32(b2) ** _F32(step))
        m, v = ms[i], vs[i]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))

    return _apply(cfg, params, grads, opt, upd)


def lion_init(params) -> OptState:
    return OptState(step=_step0(), m=_f32_zeros_like(params), v=_scalar())


def lion_update(cfg: TrainConfig, params, grads, opt: OptState):
    b1, b2 = cfg.beta1, cfg.beta2
    ms = tree_leaves(opt.m)

    def upd(p, g, i, lr, step):
        m = ms[i]
        update = torch.sign(b1 * m + (1 - b1) * g)
        if p.ndim >= 2:
            update = update + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * update).to(p.dtype))
        m.mul_(b2).add_((1 - b2) * g)

    return _apply(cfg, params, grads, opt, upd)


def sgd_init(params) -> OptState:
    return OptState(step=_step0(), m=_scalar(), v=_scalar())


def sgd_update(cfg: TrainConfig, params, grads, opt: OptState):
    def upd(p, g, i, lr, step):
        p.copy_((p.to(torch.float32) - lr * g).to(p.dtype))

    return _apply(cfg, params, grads, opt, upd)


def make_optimizer(cfg: TrainConfig):
    if cfg.optimizer == "adamw":
        return adamw_init, adamw_update
    if cfg.optimizer == "lion":
        return lion_init, lion_update
    if cfg.optimizer == "sgd":
        return sgd_init, sgd_update
    raise ValueError(cfg.optimizer)
