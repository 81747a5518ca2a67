"""Mailbox routing for the VM fleet — the send phase, then the receive
phase, over a stacked state (counterpart of ``repro.core.vm.routing``).

  * send phase — every pending ``send`` is a flat ``(valid, dst, value)``
    descriptor in (node, task) order.  Send ``k`` to destination ``d`` is
    delivered iff fewer than ``space(d)`` valid sends to ``d`` precede it;
    the ranks come from one stable destination-major sort, and all
    deliveries land in one collision-free scatter.  A full mailbox applies
    backpressure (the sender stays suspended); an out-of-range destination
    drops the message and resumes the sender.
  * receive phase — each node pops its own ring, one task per sweep in
    ascending task order.

Byte-for-byte the semantics of ``fleet.reference_round``.  Updates the
state in place.
"""

from __future__ import annotations

import torch

from repro_torch.config import VMConfig
from repro_torch.core.vm.spec import ISA, ST_IOWAIT, ST_YIELD, get_isa

I32 = torch.int32


def build_router(cfg: VMConfig, isa: ISA | None = None, obs: bool = False):
    """Returns ``route(S) -> progress``: ``progress[i]`` is True when any of
    node ``i``'s tasks was resumed this round.

    With ``obs=True`` it returns ``route_obs(S) -> (S, progress, (drops,
    depth))``, as the reference's: ``drops`` the messages dropped this round
    (sends to an out-of-range destination), ``depth`` the mailbox
    high-watermark, the deepest ring on any node right after the send phase
    (before receives pop); both () int32 on the state's device."""
    isa = isa or get_isa()
    T = cfg.max_tasks
    DS = cfg.ds_size
    MB = cfg.mbox_size
    OP_SEND = isa.opcode["send"]
    OP_RECV = isa.opcode["receive"]

    def send_phase(S):
        N = S.pc.shape[0]
        dev = S.pc.device
        is_send = (S.tstatus == ST_IOWAIT) & (S.io_op == OP_SEND)       # (N, T)
        # send ( v dst -- ): dst on top, both still on DS (pc rewound).
        dst = S.ds.gather(2, torch.clamp(S.dsp - 1, 0, DS - 1).long()[..., None])[..., 0]
        val = S.ds.gather(2, torch.clamp(S.dsp - 2, 0, DS - 1).long()[..., None])[..., 0]
        dst_ok = (dst >= 0) & (dst < N)
        dstc = torch.clamp(dst, 0, N - 1).long()
        valid = is_send & dst_ok
        vf = valid.reshape(-1)
        df = dstc.reshape(-1)
        NT = N * T
        k = torch.arange(NT, device=dev)
        key = torch.where(vf, df * NT + k, N * NT + k)
        order = torch.argsort(key, stable=True)
        pos = torch.arange(NT, device=dev)
        sd = df[order]
        is_start = torch.ones(NT, dtype=torch.bool, device=dev)
        is_start[1:] = sd[1:] != sd[:-1]
        seg_start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
        rank = torch.empty(NT, dtype=torch.long, device=dev)
        rank[order] = pos - seg_start
        space0 = torch.clamp(MB - (S.mbox_wr - S.mbox_rd), min=0).long()  # (N,)
        deliver = vf & (rank < space0[df])
        resume = is_send & (~dst_ok | deliver.reshape(N, T))
        # Every delivery owns a distinct (dst, slot).
        d_idx = deliver.nonzero()[:, 0]
        if d_idx.numel():
            drow = df[d_idx]
            slot = torch.remainder(S.mbox_wr.long()[drow] + rank[d_idx], MB)
            S.mbox[drow, 2 * slot] = (d_idx // T).to(I32)
            S.mbox[drow, 2 * slot + 1] = val.reshape(-1)[d_idx]
        sends_to = torch.zeros(N, dtype=torch.long, device=dev).index_add_(0, df, vf.long())
        S.mbox_wr.add_(torch.minimum(sends_to, space0).to(I32))
        S.dsp.copy_(torch.where(resume, S.dsp - 2, S.dsp))
        S.pc.copy_(torch.where(resume, S.pc + 1, S.pc))
        S.io_op.copy_(torch.where(resume, 0, S.io_op))
        S.tstatus.copy_(torch.where(resume, ST_YIELD, S.tstatus))
        return resume.any(dim=1), is_send, dst_ok

    def recv_phase(S):
        N = S.pc.shape[0]
        rows = torch.arange(N, device=S.pc.device)
        progress = torch.zeros(N, dtype=torch.bool, device=S.pc.device)
        for t in range(T):
            deliver = (S.tstatus[:, t] == ST_IOWAIT) & (S.io_op[:, t] == OP_RECV) & (
                S.mbox_wr > S.mbox_rd
            )
            slot = torch.remainder(S.mbox_rd, MB).long()
            src = S.mbox[rows, 2 * slot]
            v = S.mbox[rows, 2 * slot + 1]
            dsp = S.dsp[:, t]
            # receive ( -- src v ): push src, then the value.
            i0 = torch.clamp(dsp, 0, DS - 1).long()
            S.ds[rows, t, i0] = torch.where(deliver, src, S.ds[rows, t, i0])
            i1 = torch.clamp(dsp + 1, 0, DS - 1).long()
            S.ds[rows, t, i1] = torch.where(deliver, v, S.ds[rows, t, i1])
            S.dsp[:, t] = torch.where(deliver, dsp + 2, dsp)
            S.mbox_rd.copy_(torch.where(deliver, S.mbox_rd + 1, S.mbox_rd))
            S.pc[:, t] = torch.where(deliver, S.pc[:, t] + 1, S.pc[:, t])
            S.io_op[:, t] = torch.where(deliver, 0, S.io_op[:, t])
            S.tstatus[:, t] = torch.where(deliver, ST_YIELD, S.tstatus[:, t])
            progress = progress | deliver
        return progress

    def route(S):
        sent, _, _ = send_phase(S)
        received = recv_phase(S)
        return sent | received

    def route_obs(S):
        sent, is_send, dst_ok = send_phase(S)
        drops = (is_send & ~dst_ok).sum(dtype=I32)
        depth = (S.mbox_wr - S.mbox_rd).max().to(I32)
        received = recv_phase(S)
        return S, sent | received, (drops, depth)

    return route_obs if obs else route
