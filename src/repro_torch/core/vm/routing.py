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

Node sharding (a ``vmstate.ShardedState``): the send phase is the one
cross-shard step of a round, and only descriptors cross shards, never
state rows.  Each shard builds its descriptors; those of all shards are
gathered in mesh order, once on each device that holds a shard, so that
the stable destination-major sort sees the global (node, task) order.
Each destination shard counts the ranks of the sends to its own nodes
against its own ``space(d)`` and scatters those deliveries into its own
rings; the delivery flags go back to the senders' shards, and each shard
resumes its own senders.  The receive phase stays node-local.  A meshless
state is the one-shard case of the same code.
"""

from __future__ import annotations

import torch

from repro_torch.config import VMConfig
from repro_torch.core.vm import vmstate as vms
from repro_torch.core.vm.spec import ISA, ST_IOWAIT, ST_YIELD, get_isa

I32 = torch.int32

# The descriptor gather's traffic, summed over the router's rounds:
# ``chunks``/``bytes`` every shard's descriptors (and delivery flags) copied
# into a gather, ``cross_device_*`` those that changed device.
ROUTE_STATS = ("rounds", "chunks", "bytes", "cross_device_chunks", "cross_device_bytes")


def build_router(cfg: VMConfig, isa: ISA | None = None, obs: bool = False):
    """Returns ``route(S) -> progress``: ``progress[i]`` is True when any of
    node ``i``'s tasks was resumed this round (on a sharded state, a tuple
    of per-shard flags in mesh order).

    With ``obs=True`` it returns ``route_obs(S) -> (S, progress, (drops,
    depth))``, as the reference's: ``drops`` the messages dropped this round
    (sends to an out-of-range destination), ``depth`` the mailbox
    high-watermark, the deepest ring on any node right after the send phase
    (before receives pop); both () int32 on the state's (first) device,
    reduced over the shards.

    ``route.stats`` counts the descriptor gather's copies (``ROUTE_STATS``);
    a meshless state copies nothing."""
    isa = isa or get_isa()
    T = cfg.max_tasks
    DS = cfg.ds_size
    MB = cfg.mbox_size
    OP_SEND = isa.opcode["send"]
    OP_RECV = isa.opcode["receive"]
    stats = dict.fromkeys(ROUTE_STATS, 0)

    def descriptors(S, N):
        """One shard's sends: ``(is_send, dst_ok, desc)``, ``desc`` (3, n * T)
        int32 rows valid, destination (clamped), value."""
        is_send = (S.tstatus == ST_IOWAIT) & (S.io_op == OP_SEND)       # (n, T)
        # send ( v dst -- ): dst on top, both still on DS (pc rewound).
        dst = S.ds.gather(2, torch.clamp(S.dsp - 1, 0, DS - 1).long()[..., None])[..., 0]
        val = S.ds.gather(2, torch.clamp(S.dsp - 2, 0, DS - 1).long()[..., None])[..., 0]
        dst_ok = (dst >= 0) & (dst < N)
        desc = torch.stack([(is_send & dst_ok).to(I32), torch.clamp(dst, 0, N - 1), val])
        return is_send, dst_ok, desc.reshape(3, -1)

    def gather(parts, dev):
        """Concatenate per-shard chunks on ``dev``, counting the copies."""
        if len(parts) == 1:
            return parts[0].to(dev)
        for x in parts:
            nbytes = x.numel() * x.element_size()
            stats["chunks"] += 1
            stats["bytes"] += nbytes
            if x.device != dev:
                stats["cross_device_chunks"] += 1
                stats["cross_device_bytes"] += nbytes
        return torch.cat([x.to(dev) for x in parts], dim=-1)

    def deliver_to(S, lo, vf, df, val, rank):
        """Destination shard ``S`` (global nodes ``lo : lo + n``): deliver the
        sends to its nodes that fit its rings, in rank order.  Returns the
        (NT,) delivery flags of the gathered descriptors."""
        n = S.pc.shape[0]
        dev = S.pc.device
        mine = vf & (df >= lo) & (df < lo + n)
        ldst = torch.clamp(df - lo, 0, n - 1)
        space0 = torch.clamp(MB - (S.mbox_wr - S.mbox_rd), min=0).long()  # (n,)
        deliver = mine & (rank < space0[ldst])
        # Every delivery owns a distinct (dst, slot).
        d_idx = deliver.nonzero()[:, 0]
        if d_idx.numel():
            drow = ldst[d_idx]
            slot = torch.remainder(S.mbox_wr.long()[drow] + rank[d_idx], MB)
            S.mbox[drow, 2 * slot] = (d_idx // T).to(I32)
            S.mbox[drow, 2 * slot + 1] = val[d_idx]
        sends_to = torch.zeros(n, dtype=torch.long, device=dev).index_add_(0, ldst, mine.long())
        S.mbox_wr.add_(torch.minimum(sends_to, space0).to(I32))
        return deliver

    def send_phase(S):
        shards = vms.shards_of(S)
        offsets = S.offsets if isinstance(S, vms.ShardedState) else (0,)
        N = sum(sh.pc.shape[0] for sh in shards)
        NT = N * T
        local = []
        for sh, _ in vms.each_shard(S):
            local.append(descriptors(sh, N))
        # Per device: one gather of every shard's descriptors, one global
        # rank, then each destination shard on that device delivers.
        delivered = {}
        for dev in dict.fromkeys(sh.pc.device for sh in shards):
            with vms.on_device(dev):
                g = gather([d for _, _, d in local], dev)
                vf, df, val = g[0] != 0, g[1].long(), g[2]
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
                flags = None
                for sh, lo in zip(shards, offsets):
                    if sh.pc.device == dev:
                        d = deliver_to(sh, lo, vf, df, val, rank)
                        flags = d if flags is None else flags | d
                delivered[dev] = flags
        # Back to the senders: each shard resumes its own sends.
        progress, drops = [], []
        for (sh, lo), (is_send, dst_ok, _) in zip(vms.each_shard(S), local):
            n = sh.pc.shape[0]
            dev = sh.pc.device
            mine = gather([f[lo * T:(lo + n) * T] for f in delivered.values()], dev)
            if len(delivered) > 1:
                mine = mine.reshape(len(delivered), -1).any(dim=0)
            resume = is_send & (~dst_ok | mine.reshape(n, T))
            sh.dsp.copy_(torch.where(resume, sh.dsp - 2, sh.dsp))
            sh.pc.copy_(torch.where(resume, sh.pc + 1, sh.pc))
            sh.io_op.copy_(torch.where(resume, 0, sh.io_op))
            sh.tstatus.copy_(torch.where(resume, ST_YIELD, sh.tstatus))
            progress.append(resume.any(dim=1))
            drops.append((is_send & ~dst_ok).sum(dtype=I32))
        stats["rounds"] += 1
        return progress, drops

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

    def receive(S, sent):
        out = []
        for (sh, _), s in zip(vms.each_shard(S), sent):
            out.append(s | recv_phase(sh))
        return out[0] if not isinstance(S, vms.ShardedState) else tuple(out)

    def route(S):
        sent, _ = send_phase(S)
        return receive(S, sent)

    def route_obs(S):
        sent, drops = send_phase(S)
        dev = vms.first_device(S)
        total = drops[0].to(dev)
        for d in drops[1:]:
            total = total + d.to(dev)
        depth = torch.stack([(sh.mbox_wr - sh.mbox_rd).max().to(dev)
                             for sh in vms.shards_of(S)]).max().to(I32)
        return S, receive(S, sent), (total, depth)

    fn = route_obs if obs else route
    fn.stats = stats
    return fn
