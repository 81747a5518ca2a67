"""Mixture-of-Experts MLP with top-k routing (qwen2-moe / qwen3-moe;
counterpart of ``repro.models.moe``).

  * ``moe_sorted``  — sort-based capacity dispatch (the model's path):
    tokens are sorted by expert id within each group and gathered into
    (E, C, d) slots, the experts run as one grouped product, and the
    results are gathered back through the inverse permutation, weighted by
    the router gate.  Every data movement is a gather, as in the reference.
  * ``moe_dense_ref`` — the oracle: every expert on every token, no
    capacity drop.

The router runs in f32; the aux load-balancing loss follows Switch/GShard.
Top-k and the sort keep the lower index first among equal values, as
``jax.lax.top_k`` and ``jnp.argsort(stable=True)`` do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.common import mlp_swiglu
from repro_torch.sharding import local
from repro_torch.sharding.api import logical


class MoEOutput(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor


def _topk(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: ties go to the lower index
    (``torch.topk`` promises no order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_topk(x, w_router, k: int):
    """x (..., D) -> (weights (..., k) f32, ids (..., k) int64, probs
    (..., E) f32), the router's product in f32."""
    probs = torch.softmax(x.to(torch.float32) @ w_router.to(torch.float32), dim=-1)
    weights, ids = _topk(probs, k)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, ids, probs


def _expert_counts(ids, num_experts: int) -> torch.Tensor:
    """Assignments per expert (E,) in f32: a scatter-add, whose output
    shape (unlike ``bincount``'s) does not depend on the data, so the
    dry-run can count it on tensors without values."""
    flat = ids.reshape(-1)
    return torch.zeros(num_experts, dtype=torch.int64, device=ids.device).scatter_add_(
        0, flat, torch.ones_like(flat)).to(torch.float32)


def load_balance_loss(probs, ids, num_experts):
    """Switch-style aux loss: E * sum_e f_e * P_e."""
    N, k = ids.shape
    counts = _expert_counts(ids, num_experts)
    f = counts / max(N * k, 1)
    p = probs.mean(dim=0)
    return num_experts * torch.sum(f * p)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(a, idx[..., None], axis=1)`` for a (G, n, D)."""
    return torch.gather(a, 1, idx[..., None].expand(-1, -1, a.shape[-1]))


def _dispatch(xt, router, *, num_experts: int, top_k: int, capacity_factor: float, Ep: int):
    """Route the tokens of each group (xt (G, Ng, D)) and gather them into
    (G, Ep, C, D) expert slots.  Returns (expert_in, the state the combine
    needs)."""
    G, Ng, D = xt.shape
    E, k = num_experts, top_k
    dev = xt.device
    weights, ids, probs = router_topk(xt, router, k)                    # (G, Ng, k)

    C = max(int((Ng * k * capacity_factor + E - 1) // E), 1)   # Python floats, as the reference

    flat_ids = ids.reshape(G, Ng * k)
    flat_w = weights.reshape(G, Ng * k)
    token_of = torch.arange(Ng, device=dev).repeat_interleave(k)[None].expand(G, Ng * k)

    # Stable sort by expert id within each group.
    order = torch.argsort(flat_ids, dim=-1, stable=True)
    sorted_ids = torch.gather(flat_ids, -1, order)
    sorted_tok = torch.gather(token_of, -1, order)
    sorted_w = torch.gather(flat_w, -1, order)

    # Position within the expert's segment = index - segment start.
    counts = torch.zeros((G, E), dtype=torch.int64, device=dev).scatter_add_(
        1, sorted_ids, torch.ones_like(sorted_ids))
    seg_start = torch.cumsum(counts, dim=-1) - counts
    pos_in_exp = torch.arange(Ng * k, device=dev)[None] - torch.gather(seg_start, -1, sorted_ids)
    keep = pos_in_exp < C                                        # capacity drop

    # Dispatch: sort the tokens, then gather the (e, c) slots from them.
    x_sorted = _take(xt, sorted_tok)
    s_idx = torch.arange(Ep * C, device=dev)
    e_of_slot, c_of_slot = s_idx // C, s_idx % C
    e_clamped = torch.clamp(e_of_slot, max=E - 1)[None].expand(G, Ep * C)
    seg = torch.gather(seg_start, -1, e_clamped)
    cnt = torch.gather(counts, -1, e_clamped)
    slot_valid = (c_of_slot[None] < cnt) & (e_of_slot[None] < E)
    slot_src = torch.clamp(seg + c_of_slot[None], 0, Ng * k - 1)
    expert_in = torch.where(slot_valid[..., None], _take(x_sorted, slot_src), 0)
    slot_of_sorted = sorted_ids * C + torch.where(keep, pos_in_exp, 0)
    state = (probs, ids, keep, slot_of_sorted, sorted_w, torch.argsort(order, dim=-1))
    return expert_in.reshape(G, Ep, C, D), state


def _combine(expert_out, state, *, k: int):
    """Gather each sorted assignment's slot output, unsort it through the
    inverse permutation, and sum the k copies: (G, Ng, D)."""
    _, _, keep, slot_of_sorted, sorted_w, inv_order = state
    G, Ep, C, D = expert_out.shape
    flat_out = expert_out.reshape(G, Ep * C, D)
    gathered = _take(flat_out, slot_of_sorted)
    contrib = torch.where(keep[..., None], gathered, 0) * sorted_w[..., None].to(expert_out.dtype)
    return _take(contrib, inv_order).reshape(G, -1, k, D).sum(dim=2)


def moe_sorted(
    x,                      # (B, S, D)
    params,                 # dict: router (D,E), w1/w3 (Ep,D,F), w2 (Ep,F,D)
    *,
    num_experts: int,
    top_k: int,
    act,
    capacity_factor: float = 1.25,
    shared: dict | None = None,   # optional shared-expert params (qwen2-moe)
    groups: int = 1,
) -> MoEOutput:
    """Sort-based dispatch within ``groups`` independent shards, with a
    per-group capacity C per expert: an expert's assignments past C drop.
    ``Ep = w1.shape[0] >= E`` expert slots; the padded ones are never
    routed (their slots stay zero).

    Under a ``DeviceMesh`` the groups shard over the data-parallel axes and
    the experts over "model" (EP): the dispatch and the combine, whose
    sort, ``bincount`` and batched gathers have no DTensor sharding
    strategy, run per group shard (``sharding.local.moe_dispatch`` /
    ``moe_combine``), the experts per expert shard (``moe_experts``)."""
    B, S, D = x.shape
    N = B * S
    E, k = num_experts, top_k
    G = groups
    if N % G:
        raise ValueError(f"{N} tokens do not split into {G} groups")
    xt = logical(x.reshape(G, N // G, D), "batch", None, "embed")
    kw = dict(num_experts=E, top_k=k, capacity_factor=capacity_factor, Ep=params["w1"].shape[0])
    w = (params["w1"], params["w3"], params["w2"])

    if isinstance(xt, DTensor):
        expert_in, state = local.moe_dispatch(_dispatch, xt, params["router"], **kw)
        expert_in = logical(expert_in, "batch", "expert", None, "embed")
        expert_out = local.moe_experts(mlp_swiglu, expert_in, *w, act)
        expert_out = logical(expert_out, "batch", "expert", None, "embed")
        y = local.moe_combine(_combine, expert_out, state, k=k)
        probs, ids = state[:2]
        f = local.group_sum(_expert_counts(ids, E), xt) / max(N * k, 1)
        p = local.group_sum(probs.reshape(-1, E).sum(dim=0), xt) / N
        aux = E * torch.sum(f * p)
    else:
        expert_in, state = _dispatch(xt, params["router"], **kw)
        # The grouped expert FFN: one batched product per weight over the slots.
        expert_out = mlp_swiglu(expert_in, *w, act)
        y = _combine(expert_out, state, k=k)
        probs, ids = state[:2]
        aux = load_balance_loss(probs.reshape(N, E), ids.reshape(N, k), E)

    if shared is not None:
        y = y + mlp_swiglu(xt, shared["w1"], shared["w3"], shared["w2"], act)

    return MoEOutput(y.reshape(B, S, D), aux)


def moe_dense_ref(x, params, *, num_experts, top_k, act, shared=None):
    """Reference: run every expert on every token, combine with the gates."""
    B, S, D = x.shape
    N = B * S
    xt = x.reshape(N, D)
    weights, ids, probs = router_topk(xt, params["router"], top_k)
    aux = load_balance_loss(probs, ids, num_experts)

    # (E, N, D) full expert outputs.
    out_all = mlp_swiglu(xt[None], params["w1"], params["w3"], params["w2"], act)

    gate = torch.zeros((N, num_experts), dtype=torch.float32, device=x.device)
    gate.scatter_add_(1, ids, weights)
    y = torch.einsum("ne,end->nd", gate.to(x.dtype), out_all)

    if shared is not None:
        y = y + mlp_swiglu(xt, shared["w1"], shared["w3"], shared["w2"], act)
    return MoEOutput(y.reshape(B, S, D), aux)
