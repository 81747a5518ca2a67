"""Loss + train step (counterpart of ``repro.train.train_step``):
cross-entropy with z-loss and the MoE router aux loss, gradient
accumulation over microbatches in f32, and the int8 gradient-compression
hook on the data-parallel reduction (paper C4 applied to gradients).

Gradients come from ``torch.autograd.grad`` over the parameter leaves,
where the reference takes ``jax.value_and_grad``; on CUDA every attention
layer's backward is flash attention's backward kernel
(``kernels/flashattn``, through ``ops.attention``'s ``FlashAttention``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.config import TrainConfig
from repro_torch.sharding import local
from repro_torch.train.compression import compress_decompress_grads
from repro_torch.train.optimizer import make_optimizer
from repro_torch.utils.tree import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: Any
    rng: torch.Tensor       # the state of a CPU torch.Generator seeded with TrainConfig.seed
    step: torch.Tensor      # () int32 on the host


def _trainable(params) -> list:
    """The float leaves, set to require grad (a restored or converted tree
    comes without)."""
    leaves = tree_leaves(params)
    for p in leaves:
        if p.is_floating_point() and not p.requires_grad:
            p.requires_grad_(True)
    return leaves


def init_train_state(model, train_cfg: TrainConfig, seed: int | torch.Generator = 0) -> TrainState:
    """Params from ``model.init(seed)`` (an int or a ``torch.Generator`` on
    the model's device), the optimizer's state, and the seed's generator."""
    params = model.init(seed)
    _trainable(params)
    opt_init, _ = make_optimizer(train_cfg)
    rng = torch.Generator().manual_seed(train_cfg.seed).get_state()
    return TrainState(params=params, opt=opt_init(params), rng=rng,
                      step=torch.zeros((), dtype=torch.int32))


def loss_fn(model, train_cfg: TrainConfig, params, batch, **forward_kw):
    """Next-token CE in f32 with z-loss + MoE aux loss.  ``forward_kw``
    goes to ``model.forward`` (``attention=`` replaces flash attention in
    every layer)."""
    logits, aux = model.forward(params, batch, **forward_kw)
    labels = batch["labels"].long()
    logits = logits.to(torch.float32)
    # standard causal LM shift: predict labels[t] from logits[t]
    logz = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):     # vocab-sharded: each rank picks from its shard
        gold = local.pick(logits, labels.clamp(min=0))
    else:
        gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    ntok = torch.clamp(mask.sum(), min=1.0)
    ce = torch.sum((logz - gold) * mask) / ntok
    zl = torch.sum(torch.square(logz) * mask) / ntok
    total = ce + train_cfg.z_loss * zl + model.cfg.router_aux_loss_coef * aux
    return total, {"ce": ce, "z_loss": zl, "aux": aux}


def make_train_step(model, train_cfg: TrainConfig, **forward_kw):
    """The train step ``(state, batch) -> (state, metrics)``; ``batch`` holds
    ``tokens`` and ``labels`` (B, S) tensors on the model's device.

    With ``train_cfg.microbatches > 1`` the batch is split along axis 0
    and the gradients are summed in f32, one microbatch after another, as
    the reference's ``lax.scan``; the metrics are the last microbatch's,
    the loss their mean.  Params and moments are updated in place."""
    _, opt_update = make_optimizer(train_cfg)
    n_micro = train_cfg.microbatches

    def grads_of(params, batch):
        leaves = _trainable(params)
        loss, metrics = loss_fn(model, train_cfg, params, batch, **forward_kw)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(state: TrainState, batch):
        params = state.params
        if n_micro == 1:
            loss, metrics, grads = grads_of(params, batch)
            grads = [g.to(torch.float32) for g in grads]
        else:
            micro = {k: x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))
                     for k, x in batch.items()}
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in tree_leaves(params)]
            loss = 0.0
            for i in range(n_micro):
                mb_loss, metrics, grads = grads_of(params, {k: x[i] for k, x in micro.items()})
                for a, g in zip(acc, grads):
                    a.add_(g.to(torch.float32))
                loss = loss + mb_loss
                del grads
            grads = [a / n_micro for a in acc]
            loss = loss / n_micro
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)

        if train_cfg.grad_compression == "int8_ef":
            grads = compress_decompress_grads(grads)

        new_params, new_opt, opt_metrics = opt_update(train_cfg, params, grads, state.opt)
        metrics = dict(metrics) | dict(opt_metrics) | {"loss": loss}
        return TrainState(params=new_params, opt=new_opt, rng=state.rng,
                          step=state.step + 1), metrics

    return train_step
