"""VM state as torch tensors, and conversion to and from the reference.

The whole machine — code segment, stacks, task table, event table, output
ring, inter-node mailbox — is one NamedTuple of tensors.  The field list,
the shapes and the int32 dtypes are the reference's (``repro.core.vm.
vmstate.VMState``) with one exception: ``rng`` (the reference's ``uint32``
LCG state) is int64 here, holding a value in ``[0, 2**32)``, because
torch's ``uint32`` has few operations.  ``to_reference`` hands it back as
``uint32``.

A state is either *single* (one node, fields as in the reference) or
*stacked* (a leading node axis on every field).  The batched interpreter,
the vmloop kernel and the router work on stacked states and update them in
place; the single-node frontend (``REXAVM``) keeps its host-canonical state
as a single state of CPU tensors.

A *sharded* state (:class:`ShardedState`) is a stacked state split along
its node axis over a ``NodeMesh`` (``launch/mesh.py``): one stacked
``VMState`` a shard, in mesh order, each on its shard's device and in
storage of its own.  ``take_nodes``/``put_nodes``/``to_host`` address it
by global node index.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.config import VMConfig
from repro_torch.core.vm.spec import NUM_EXC, ST_FREE, ST_YIELD

I32 = torch.int32


class VMState(NamedTuple):
    # memories
    cs: torch.Tensor          # (CS,)  int32 code segment (bytecode + frame data)
    mem: torch.Tensor         # (MEM,) int32 DIOS data memory
    # per-task stacks
    ds: torch.Tensor          # (T, DS) int32
    rs: torch.Tensor          # (T, RS) int32
    fs: torch.Tensor          # (T, FS) int32
    dsp: torch.Tensor         # (T,) int32
    rsp: torch.Tensor         # (T,) int32
    fsp: torch.Tensor         # (T,) int32
    # per-task control
    pc: torch.Tensor          # (T,) int32
    tstatus: torch.Tensor     # (T,) int32 ST_*
    prio: torch.Tensor        # (T,) int32
    deadline: torch.Tensor    # (T,) int32
    timeout: torch.Tensor     # (T,) int32 wake time (virtual ms)
    ev_addr: torch.Tensor     # (T,) int32 awaited variable address
    ev_val: torch.Tensor      # (T,) int32 awaited value
    catch_pc: torch.Tensor    # (T,) int32 exception catch point
    catch_rsp: torch.Tensor   # (T,) int32
    pending_exc: torch.Tensor # (T,) int32 raised, not yet dispatched
    last_exc: torch.Tensor    # (T,) int32 dispatched, readable by `catch`
    io_op: torch.Tensor       # (T,) int32 pending FIOS opcode (0 = none)
    # global
    handlers: torch.Tensor    # (NUM_EXC,) int32 exception handler addresses
    cur: torch.Tensor         # () int32 current task
    now: torch.Tensor         # () int32 virtual time in ms
    steps: torch.Tensor       # () int32 executed instruction count
    rng: torch.Tensor         # () int64 LCG state in [0, 2**32)
    out: torch.Tensor         # (OUT*2,) int32 output ring: [kind, value] pairs
    outp: torch.Tensor        # () int32 entries written (pairs)
    # inter-node mailbox ring (fleet send/receive routing)
    mbox: torch.Tensor        # (MBOX*2,) int32 mailbox ring: [src, value] pairs
    mbox_rd: torch.Tensor     # () int32 messages consumed (monotonic)
    mbox_wr: torch.Tensor     # () int32 messages delivered (monotonic)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Without CUDA the default raises rather than run elsewhere."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device=\"cpu\" to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def init_state(cfg: VMConfig, seed: int = 1, device="cpu") -> VMState:
    """A fresh single-node state on ``device``."""
    T = cfg.max_tasks

    def z(*shape):
        return torch.zeros(shape, dtype=I32, device=device)

    return VMState(
        cs=z(cfg.cs_size),
        mem=z(cfg.mem_size),
        ds=z(T, cfg.ds_size),
        rs=z(T, cfg.rs_size),
        fs=z(T, cfg.fs_size),
        dsp=z(T),
        rsp=z(T),
        fsp=z(T),
        pc=z(T),
        tstatus=torch.full((T,), ST_FREE, dtype=I32, device=device),
        prio=z(T),
        deadline=z(T),
        timeout=z(T),
        ev_addr=z(T),
        ev_val=z(T),
        catch_pc=z(T),
        catch_rsp=z(T),
        pending_exc=z(T),
        last_exc=z(T),
        io_op=z(T),
        handlers=z(NUM_EXC),
        cur=z(),
        now=z(),
        steps=z(),
        rng=torch.tensor(int(seed) & 0xFFFFFFFF, dtype=torch.int64, device=device),
        out=z(cfg.out_ring_size * 2),
        outp=z(),
        mbox=z(cfg.mbox_size * 2),
        mbox_rd=z(),
        mbox_wr=z(),
    )


def state_nbytes(st) -> int:
    """Total byte size of one state (or one stacked or sharded fleet state)."""
    return sum(int(x.numel()) * x.element_size() for sh in shards_of(st) for x in sh)


def clone(st: VMState) -> VMState:
    return VMState(*[x.clone() for x in st])


def to_device(st: VMState, device) -> VMState:
    return VMState(*[x.to(device) for x in st])


def to_host(st) -> VMState:
    """A CPU copy (never a view of device memory); a sharded state comes
    back as one stacked state in node order."""
    if isinstance(st, ShardedState):
        parts = [to_host(sh) for sh in st.shards]
        return VMState(*[torch.cat(xs) for xs in zip(*parts)])
    return VMState(*[x.detach().to("cpu", copy=True) for x in st])


def stack_states(states: list[VMState]) -> VMState:
    """Stack single states along a new leading node axis."""
    return VMState(*[torch.stack([getattr(s, f) for s in states]) for f in VMState._fields])


def stack1(st: VMState) -> VMState:
    """One-node stack: the single-VM view of the batched executors."""
    return VMState(*[x.unsqueeze(0) for x in st])


def unstack(S: VMState, i: int) -> VMState:
    """Node ``i`` of a stacked state as a single state (a copy)."""
    return VMState(*[x[i].clone() for x in S])


def take_nodes(S, idx, device=None) -> VMState:
    """Gather node rows ``idx`` from a stacked or sharded state (a copy),
    onto ``device`` (default: the state's first device).  A sharded state
    gathers each shard's rows on its own device, then moves them."""
    if isinstance(S, ShardedState):
        idx = np.asarray(idx, dtype=np.int64).reshape(-1)
        dev = torch.device(device) if device is not None else S.devices[0]
        parts, order = [], []
        for j, (sh, lo) in enumerate(zip(S.shards, S.offsets)):
            mine = np.flatnonzero((idx >= lo) & (idx < lo + S.sizes[j]))
            if mine.size:
                rows = take_nodes(sh, idx[mine] - lo)
                parts.append(VMState(*[x.to(dev) for x in rows]))
                order.append(mine)
        out = VMState(*[torch.cat(xs) for xs in zip(*parts)])
        inv = torch.as_tensor(np.argsort(np.concatenate(order), kind="stable"), device=dev)
        return VMState(*[x.index_select(0, inv) for x in out])
    idx = torch.as_tensor(idx, dtype=torch.long, device=S.pc.device)
    rows = VMState(*[x.index_select(0, idx) for x in S])
    return rows if device is None else VMState(*[x.to(device) for x in rows])


def put_nodes(S, idx, sub: VMState):
    """Scatter node rows ``sub`` back into ``S`` at rows ``idx`` (in place);
    on a sharded state each shard takes the rows it owns."""
    if isinstance(S, ShardedState):
        idx = np.asarray(idx, dtype=np.int64).reshape(-1)
        for j, (sh, lo) in enumerate(zip(S.shards, S.offsets)):
            mine = np.flatnonzero((idx >= lo) & (idx < lo + S.sizes[j]))
            if mine.size:
                at = torch.as_tensor(mine, device=sub.pc.device)
                put_nodes(sh, idx[mine] - lo, VMState(*[u.index_select(0, at) for u in sub]))
        return S
    idx = torch.as_tensor(idx, dtype=torch.long, device=S.pc.device)
    for x, u in zip(S, sub):
        x.index_copy_(0, idx, u.to(x.device))
    return S


# ---------------------------------------------------------------------------
# Sharded states (the fleet's node axis over a NodeMesh)
# ---------------------------------------------------------------------------

class ShardedState:
    """A stacked state split along the node axis over ``mesh``: shard ``j``
    holds global nodes ``offsets[j] : offsets[j] + sizes[j]`` as a stacked
    ``VMState`` of its own on ``mesh.devices[j]``."""

    def __init__(self, shards, mesh):
        self.shards = tuple(shards)
        self.mesh = mesh
        if len(self.shards) != mesh.size:
            raise ValueError(f"{len(self.shards)} shards for a mesh of {mesh.size}")
        self.sizes = tuple(int(sh.pc.shape[0]) for sh in self.shards)
        self.offsets = tuple(int(o) for o in np.cumsum((0,) + self.sizes[:-1]))
        self.n = sum(self.sizes)

    @property
    def devices(self) -> tuple:
        return tuple(sh.pc.device for sh in self.shards)

    def __len__(self) -> int:
        return self.n


def split_rows(S: VMState, mesh) -> ShardedState:
    """Split a stacked state into ``mesh.size`` equal shards, each a copy
    on its device (storage of its own, even where devices repeat)."""
    k = mesh.size
    N = int(S.pc.shape[0])
    if N % k:
        raise ValueError(f"{N} nodes do not split over {k} shards")
    n = N // k
    return ShardedState(
        [VMState(*[x[j * n:(j + 1) * n].to(d, copy=True) for x in S])
         for j, d in enumerate(mesh.devices)], mesh)


def shards_of(S) -> tuple:
    """The stacked states that make up ``S``: its shards, or ``S`` alone."""
    return S.shards if isinstance(S, ShardedState) else (S,)


def first_device(S) -> torch.device:
    return shards_of(S)[0].pc.device


def on_device(dev):
    """Make ``dev`` the current CUDA device (a no-op for the CPU)."""
    dev = torch.device(dev)
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def each_shard(S):
    """``(shard, offset)`` for each shard of ``S`` in mesh order, each with
    its device current while the caller's loop body runs; a plain stacked
    state is its one shard, at offset 0."""
    if not isinstance(S, ShardedState):
        yield S, 0
        return
    for sh, lo in zip(S.shards, S.offsets):
        with on_device(sh.pc.device):
            yield sh, lo


def join_rows(parts, device):
    """Per-shard outputs joined in node order on ``device``: tensors are
    concatenated, tuples element by element."""
    head = parts[0]
    if len(parts) == 1:
        return head
    if isinstance(head, tuple):
        return tuple(join_rows(list(xs), device) for xs in zip(*parts))
    return torch.cat([p.to(device) for p in parts])


def sum_to(xs, device) -> torch.Tensor:
    """The sum of per-shard tensors on ``device``."""
    total = xs[0].to(device)
    for x in xs[1:]:
        total = total + x.to(device)
    return total


def field_to_host(S, name: str) -> np.ndarray:
    """One field of a stacked or sharded state as a host array in node
    order (one small copy a shard)."""
    return np.concatenate([getattr(sh, name).cpu().numpy() for sh in shards_of(S)])


def launch_task(st: VMState, task: int, entry: int, prio: int = 0, deadline: int = 0) -> VMState:
    """Point task slot ``task`` of a single state at ``entry`` and mark it
    ready (in place)."""
    st.pc[task] = entry
    st.dsp[task] = 0
    st.rsp[task] = 0
    st.fsp[task] = 0
    st.tstatus[task] = ST_YIELD
    st.prio[task] = prio
    st.deadline[task] = deadline
    st.catch_pc[task] = 0       # cell 0 holds a canonical `end`
    st.catch_rsp[task] = 0
    st.pending_exc[task] = 0
    st.last_exc[task] = 0
    st.io_op[task] = 0
    return st


# Output ring entry kinds.
OUT_NUM = 0
OUT_CHR = 1


def decode_output(st: VMState) -> str:
    """Render a single state's output ring as text (host side)."""
    out = st.out.cpu().numpy()
    n = int(st.outp)
    parts: list[str] = []
    for k in range(n):
        kind, val = int(out[2 * k]), int(out[2 * k + 1])
        if kind == OUT_CHR:
            parts.append(chr(val & 0xFF))
        else:
            parts.append(f"{val} ")
    return "".join(parts)


def clear_output(st: VMState) -> VMState:
    st.out.zero_()
    st.outp.zero_()
    return st


# ---------------------------------------------------------------------------
# Carrying state across from the JAX reference
# ---------------------------------------------------------------------------

def from_reference(np_state, device) -> VMState:
    """A reference ``VMState`` of numpy arrays (single or stacked) as the
    port's state on ``device``.  ``rng`` (uint32) becomes int64."""
    fields = []
    for name in VMState._fields:
        a = np.asarray(getattr(np_state, name))
        if name == "rng":
            t = torch.as_tensor(a.astype(np.int64), device=device)
        else:
            t = torch.as_tensor(a.astype(np.int32), device=device)
        fields.append(t.clone())
    return VMState(*fields)


def to_reference(st: VMState):
    """The port's state as a reference-shaped ``VMState``-like NamedTuple
    of numpy arrays with the reference's dtypes (``rng`` as uint32)."""
    fields = []
    for name in VMState._fields:
        a = getattr(st, name).detach().cpu().numpy()
        fields.append(a.astype(np.uint32) if name == "rng" else a.astype(np.int32))
    return VMState(*fields)
