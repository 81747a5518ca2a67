"""Kernel call sites on local shards.

Under a ``DeviceMesh``'s rules the model's tensors are DTensors, and a
CUDA kernel must never receive one.  Each function here takes the
DTensor arguments of one call site, moves them to placements under which
the op is exact shard by shard, hands the local tensors to the op (the
kernel's wrapper, or the plain version that a check passes in), and wraps
the local results back into DTensors with their placements given
explicitly:

  * :func:`attention` (flash attention; the plain blocked attention of
    whisper's cross attention too): per (batch, head) shard.  Where
    the query heads are sharded and the KV heads are not (glm4's 2 KV
    heads on a 16-way axis), each rank takes the KV heads of its own query
    heads, and their gradient is a partial sum over that axis.
  * :func:`wkv` (the rwkv6_scan op) and :func:`ssd` (mamba2's chunked
    SSD, no kernel, but DTensor's einsum fails on it): per (batch, head)
    shard.
  * :func:`quantized_matmul` (fixmatmul): each row quantized whole, then
    one local product per shard of the int8 weight: a weight sharded on
    its output dim gives output columns, one sharded on its input dim
    partial sums, reduced in f32.
  * :func:`moe_dispatch` / :func:`moe_experts` / :func:`moe_combine`: the
    sort-based MoE dispatch has ops with no DTensor sharding strategy
    (``bincount``, the stable sort along the tokens, the batched gathers),
    so routing and combining run per group shard, replicated over
    "model"; the experts run per expert shard (EP), all-gathered for the
    combine; :func:`group_sum` sums the load-balance loss's per-group
    counts over the shards.
  * :func:`embed` and :func:`pick`: the embedding lookup over a
    vocab-sharded table and the loss's gold logit over vocab-sharded
    logits, each a sum over the vocab shards.
  * :func:`decode_attention`: the decode step's attention and KV-cache
    slot write (an in-place write into a view, which DTensor cannot follow)
    on each rank's (batch, KV head, sequence) shard of the cache; over a
    sequence-sharded cache the softmax is combined across the shards.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def _from_local(t, mesh, placements):
    return DTensor.from_local(t, mesh, list(placements), run_check=False)


def _replicated(x, mesh):
    """``x`` as a DTensor (a plain tensor is the same on every rank)."""
    if isinstance(x, DTensor):
        return x
    return _from_local(x, mesh, [Replicate()] * mesh.ndim)


def _coord(mesh, i: int) -> int:
    return mesh.get_coordinate()[i]


def _keep(placements, dims: tuple) -> list:
    """Each mesh dim's placement if it shards one of ``dims``, else
    Replicate."""
    return [p if isinstance(p, Shard) and p.dim in dims else Replicate() for p in placements]


# -- flash attention -------------------------------------------------------------------

def attention(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` (BSHD) on each rank's (batch, head) shard.
    The query's batch and head placements rule; its sequence is gathered."""
    mesh = q.device_mesh
    pq = _keep(q.placements, (0, 2))
    pk, grad_k, split = [], [], None
    for i, p in enumerate(pq):
        if p == Shard(2) and k.placements[i] != Shard(2):
            pk.append(Replicate())
            grad_k.append(Partial())          # each rank's query heads see their own KV heads
            split = i
        else:
            pk.append(p)
            grad_k.append(p)
    q = q.redistribute(mesh, pq)
    k = k.redistribute(mesh, pk)
    v = v.redistribute(mesh, pk)
    ql = q.to_local()
    kl, vl = (t.to_local(grad_placements=grad_k) for t in (k, v))
    if split is not None:
        Hl, KV = ql.shape[2], kl.shape[2]
        G = q.shape[2] // KV
        if Hl % G and G % Hl:
            raise ValueError(f"attention: {Hl} local query heads do not align with groups of {G}")
        lo = _coord(mesh, split) * Hl // G
        n = max(Hl // G, 1)
        kl, vl = kl.narrow(2, lo, n), vl.narrow(2, lo, n)
    return _from_local(fn(ql, kl, vl, **kw), mesh, pq)


# -- per-(batch, head) scans: rwkv6's wkv and mamba2's SSD ------------------------------

def _roles(x, head_dim: int, heads: int) -> list:
    """Per mesh dim of ``x``: "batch" where it shards dim 0, "head" where
    it shards ``head_dim`` into whole heads, else None."""
    out = []
    for p, n in zip(x.placements, x.device_mesh.shape):
        if p == Shard(0):
            out.append("batch")
        elif p == Shard(head_dim) and heads % n == 0:
            out.append("head")
        else:
            out.append(None)
    return out


def _placed(roles, dims: dict) -> list:
    return [Shard(dims[r]) if r in dims else Replicate() for r in roles]


def _grads(roles, dims: dict) -> list:
    """The gradient's placements of an argument placed by ``dims``: on a
    mesh dim that splits the work (by batch or by head) but not this
    argument, each rank holds its own share of the sum."""
    return [Shard(dims[r]) if r in dims else Partial() if r else Replicate() for r in roles]


def _to_local(x, mesh, roles, dims: dict):
    return _replicated(x, mesh).redistribute(mesh, _placed(roles, dims)).to_local(
        grad_placements=_grads(roles, dims))


def _per_head(fn, mesh, roles, args, dims, out_dims, **kw):
    """``fn(*local args, **kw)`` with each tensor argument placed by its
    ``dims`` ({"batch": d, "head": d}; None: a non-tensor argument passed
    as it is) and the outputs wrapped by ``out_dims``."""
    local = [a if d is None else _to_local(a, mesh, roles, d) for a, d in zip(args, dims)]
    outs = fn(*local, **kw)
    return tuple(_from_local(o, mesh, _placed(roles, d)) for o, d in zip(outs, out_dims))


_BSD = {"batch": 0, "head": 2}                  # (B, S, D) or (B, S, H, P)
_STATE = {"batch": 0, "head": 1}                # (B, H, ...)


def wkv(fn, r, k, v, logw, u, state0, head_size: int, **kw):
    """``fn(r, k, v, logw, u, state0, head_size, **kw)`` on each rank's
    (batch, head) shard: r/k/v/logw (B, S, D), u (D,), state0 (B, H, K,
    K).  A ``state_out`` in ``kw`` (a DTensor view of the cache) must
    already lie as the state does; the op writes its local shard."""
    mesh = r.device_mesh
    roles = _roles(r, 2, r.shape[-1] // head_size)
    out = kw.get("state_out")
    if out is not None:
        if tuple(out.placements) != tuple(_placed(roles, _STATE)):
            raise ValueError(f"wkv: state_out lies as {out.placements}, the state as "
                             f"{_placed(roles, _STATE)}")
        kw = kw | {"state_out": out.to_local()}
    return _per_head(fn, mesh, roles, (r, k, v, logw, u, state0, head_size),
                     (_BSD, _BSD, _BSD, _BSD, {"head": 0}, _STATE, None), (_BSD, _STATE), **kw)


def ssd(fn, x, dt, B_, C_, a_log, d_skip, state):
    """mamba2's ``chunked_ssd(x, dt, B_, C_, a_log, d_skip, state)`` on each
    rank's (batch, head) shard (DTensor's einsum fails on its three-operand
    contractions over a head-sharded input): x (B, S, H, P), dt (B, S, H),
    B_/C_ (B, S, N), a_log/d_skip (H,), state (B, H, P, N)."""
    mesh = x.device_mesh
    roles = _roles(x, 2, x.shape[2])
    return _per_head(fn, mesh, roles, (x, dt, B_, C_, a_log, d_skip, state),
                     (_BSD, _BSD, {"batch": 0}, {"batch": 0}, {"head": 0}, {"head": 0}, _STATE),
                     (_BSD, _STATE))


# -- fixmatmul -------------------------------------------------------------------------

def quantized_matmul(x, wq, sw, out_dtype):
    """``kernels.fixmatmul.ops.quantized_matmul`` with x (..., K) a DTensor
    and wq (K, N) / sw (N,) the int8 leaf: each rank quantizes its rows
    whole and multiplies them by its shard of the weight through the
    fixmatmul kernel (``ops.fixmatmul``)."""
    from repro_torch.kernels.fixmatmul import ops

    mesh = x.device_mesh
    lead, K = x.shape[:-1], x.shape[-1]
    x = x.reshape(-1, K)
    px = _keep(x.placements, (0,))
    pw, ps, po, parts = [], [], [], []
    for i, p in enumerate(wq.placements):
        if px[i] != Replicate() or not isinstance(p, Shard):
            pw.append(Replicate()), ps.append(Replicate()), po.append(px[i])
        elif p.dim == 1:
            pw.append(p), ps.append(Shard(0)), po.append(Shard(1))
        else:
            pw.append(p), ps.append(Replicate()), po.append(Partial())
            parts.append(i)
    xl = x.redistribute(mesh, px).to_local()
    wl = wq.redistribute(mesh, pw).to_local()
    sl = _replicated(sw, mesh).redistribute(mesh, ps).to_local()
    xq, sx = ops.quantize_rows(xl)
    for i in parts:                                   # this rank's slice of K
        n = xq.shape[1] // mesh.shape[i]
        xq = xq.narrow(1, _coord(mesh, i) * n, n)
    out = _from_local(ops.fixmatmul(xq, wl, sx, sl.reshape(-1)), mesh, po)
    if parts:
        out = out.redistribute(mesh, [Replicate() if isinstance(p, Partial) else p for p in po])
    return out.reshape(*lead, wq.shape[1]).to(out_dtype)


# -- the embedding lookup ---------------------------------------------------------------

def embed(table, tokens):
    """``table[tokens]`` with the table (V, D) a DTensor, its vocab on
    "model" (DTensor's strategy for the lookup's backward, an
    ``index_put``, fails in torch 2.11): each rank looks up the tokens in
    its vocab shard, zeros elsewhere, and the rows are the sum over the
    shards.  The tokens keep their batch placement; an FSDP shard of the
    table is gathered."""
    mesh = table.device_mesh
    tok = _replicated(tokens, mesh)
    roles = ["batch" if pt == Shard(0) else "head" if pw == Shard(0) else None
             for pt, pw in zip(tok.placements, table.placements)]
    wl = _to_local(table, mesh, roles, {"head": 0})
    tl = _to_local(tok, mesh, roles, {"batch": 0})
    if "head" not in roles:
        return _from_local(wl[tl], mesh, _placed(roles, {"batch": 0}))
    lo, n = 0, table.shape[0]
    for i, r in enumerate(roles):
        if r == "head":
            n //= mesh.shape[i]
            lo = lo * mesh.shape[i] + _coord(mesh, i)
    lo *= n
    inside = (tl >= lo) & (tl < lo + n)
    rows = torch.where(inside[..., None], wl[torch.where(inside, tl - lo, 0)], 0)
    return _from_local(rows, mesh, [Shard(0) if r == "batch" else Partial() if r else Replicate()
                                    for r in roles])


# -- the loss's gold logit ------------------------------------------------------------

def pick(logits, idx):
    """``torch.gather(logits, -1, idx[..., None])[..., 0]`` with logits
    (B, S, V) a DTensor whose vocab may be sharded (DTensor's gather there
    fails when the result is indexed): each rank picks the labels that
    fall in its vocab shard, and the result is their sum over the shards."""
    mesh = logits.device_mesh
    pl = _keep(logits.placements, (0, 2))
    ll = logits.redistribute(mesh, pl).to_local()
    il = _replicated(idx, mesh).redistribute(mesh, _keep(pl, (0,))).to_local()
    lo, n = 0, logits.shape[-1]
    for i, p in enumerate(pl):
        if p == Shard(2):
            n //= mesh.shape[i]
            lo = lo * mesh.shape[i] + _coord(mesh, i)
    lo *= n
    inside = (il >= lo) & (il < lo + n)
    got = torch.gather(ll, -1, torch.where(inside, il - lo, 0)[..., None])[..., 0]
    got = torch.where(inside, got, 0)
    return _from_local(got, mesh, [Partial() if p == Shard(2) else p for p in pl])


# -- MoE -------------------------------------------------------------------------------

def _group_roles(x) -> list:
    """Per mesh dim: "batch" where ``x`` shards its group axis (dim 0)."""
    return ["batch" if p == Shard(0) else None for p in x.placements]


def moe_dispatch(fn, xt, router, **kw):
    """``fn(xt, router, **kw) -> (expert_in, state)`` per group shard:
    ``xt`` (G, Ng, D) keeps its group placement and is gathered elsewhere;
    ``expert_in`` (G, Ep, C, D) comes back placed like it (replicated over
    the other axes), ``state`` local."""
    mesh = xt.device_mesh
    roles = _group_roles(xt)
    expert_in, state = fn(_to_local(xt, mesh, roles, {"batch": 0}),
                          _to_local(router, mesh, roles, {}), **kw)
    return _from_local(expert_in, mesh, _placed(roles, {"batch": 0})), state


def moe_experts(fn, expert_in, w1, w3, w2, act):
    """``fn(expert_in, w1, w3, w2, act)`` per (group, expert) shard: the
    expert weights keep their expert placement and are gathered elsewhere
    (an FSDP shard over "data" is all-gathered)."""
    mesh = expert_in.device_mesh
    roles = ["batch" if p == Shard(0) else "head" if p == Shard(1) else None
             for p in expert_in.placements]
    xl = _to_local(expert_in, mesh, roles, {"batch": 0, "head": 1})
    ws = [_to_local(w, mesh, roles, {"head": 0}) for w in (w1, w3, w2)]
    return _from_local(fn(xl, *ws, act), mesh, _placed(roles, {"batch": 0, "head": 1}))


def moe_combine(fn, expert_out, state, **kw):
    """``fn(expert_out, state, **kw) -> y`` per group shard, over every
    expert's output (gathered over the expert axis)."""
    mesh = expert_out.device_mesh
    roles = _group_roles(expert_out)
    y = fn(_to_local(expert_out, mesh, roles, {"batch": 0}), state, **kw)
    return _from_local(y, mesh, _placed(roles, {"batch": 0}))


def group_sum(t, like):
    """A per-group-shard partial sum ``t`` as a DTensor whose value is its
    sum over the group shards of ``like``."""
    return _from_local(t, like.device_mesh, [Partial() if p == Shard(0) else Replicate()
                                             for p in like.placements])


# -- decode attention -------------------------------------------------------------------

def _all_reduce(mesh, dims, t, op: str):
    """``t`` all-reduced in place by ``op`` ("max" or "sum") over the mesh
    dims ``dims``."""
    for i in dims:
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()), group=mesh.get_group(i))
    return t


def decode_attention(fn, q, k_new, v_new, cache, **kw):
    """``fn(q, k_new, v_new, cache, **kw)`` (``models.attention.
    decode_attention``) on each rank's (batch, KV head, sequence) shard of
    the cache: the token is written into the shard that holds its slot, in
    place, and the query's heads follow their KV heads.  Where the cache
    shards its sequence (a KV-head count the axis does not divide, or
    batch-1 long context) every rank of those mesh dims takes the whole
    query, and ``fn`` combines the softmax across them (its
    ``seq_shard``)."""
    mesh = cache.k.device_mesh
    roles = ["batch" if p == Shard(0) else "seq" if p == Shard(1) else "head" if p == Shard(2)
             else None for p in cache.k.placements]
    qkv = {"batch": 0, "head": 2}
    ql, kl, vl = (_to_local(t, mesh, roles, qkv) for t in (q, k_new, v_new))
    local_cache = cache._replace(**{f: getattr(cache, f).to_local() for f in ("k", "v", "ks", "vs")})
    seq = [i for i, r in enumerate(roles) if r == "seq"]
    if seq:
        lo = 0
        for i in seq:                               # mesh order: the first dim outermost
            lo = lo * mesh.shape[i] + _coord(mesh, i)
        n = local_cache.k.shape[1]
        kw["seq_shard"] = (lo * n, cache.k.shape[1], functools.partial(_all_reduce, mesh, seq))
    out, local_cache = fn(ql, kl, vl, local_cache, **kw)
    return _from_local(out, mesh, _placed(roles, qkv)), cache._replace(pos=local_cache.pos)
