"""Fleet metrics schema — counters, classification, counting slice engines
(counterpart of ``repro.obs.metrics``).

One namespace for everything the fleet can count, with one rule: the
schema is executor-independent.  ``FleetVM.metrics()`` returns the same
key set under the batched interpreter, the Oracle and the vmloop kernel —
a backend that cannot produce a counter reports it as zero, never as a
missing key.

The load-bearing definition is the per-opcode retirement **bin**.  Every
retired instruction — and only retired instructions — lands in exactly one
of ``num_ops + 4`` bins:

  ``0 .. num_ops-1``   the ISA opcode (tag 0, payload clipped to
                       ``num_ops``);
  ``num_ops``          "fios/trap": tag-0 payload >= num_ops (a FIOS host
                       call's suspension step, or an out-of-table trap);
  ``num_ops + 1``      literal push (tag 1);
  ``num_ops + 2``      call (tag 2);
  ``num_ops + 3``      invalid: reserved tag 3, or an out-of-bounds pc (the
                       invalid-pc trap still bumps ``steps``).

Every engine retires byte-identical instruction sequences, so per-bin
counts compare exactly across executors and against the JAX package.  The
counting engines here are built from the batched interpreter's own
``schedule``/``vmloop``/``preempt`` (``vmloop(..., hist=)`` bins each
stepped row), so counting cannot diverge from execution:

  * :func:`make_counting_slice`  — schedule -> counting vmloop -> preempt;
  * :func:`make_counting_finish` — counting vmloop with a per-node bound,
    then preempt;
  * :func:`classify_host`        — the plain-Python mirror for the Oracle's
    ``step_hook``;
  * :func:`trace_spec_hist`      — the trace-JIT's specialized steps in
    closed form over a recorded path's prefix table (never re-executed).

The device classifier is ``core.vm.interp.bins_of``; the vmloop kernel's
counting instance (``vmloop_call(..., obs=True)``) bins the instructions
it retires the same way.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.vm.spec import ISA, TAG_OP

EXTRA_BINS = ("fios/trap", "lit", "call", "invalid")
I32 = torch.int32


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ObsConfig:
    """Observability switchboard.

    ``trace``            — record round-phase spans (one device synchronize
                           per phase, so that span walls are honest);
    ``trace_ring``       — host ring-buffer capacity in span events;
    ``deadline_ms``      — virtual-clock round deadline: a node misses when
                           its per-round clock increment exceeds this many
                           virtual ms (0 disables).  Deterministic and
                           byte-exact across executors;
    ``deadline_wall_ms`` — wall-clock round deadline for the host latency
                           monitor (0 disables);
    ``time_rounds``      — feed the wall-clock latency histogram (one device
                           synchronize per round);
    ``profiler``         — wrap spans in ``torch.profiler.record_function``
                           so device profiles carry the phase names.
    """

    trace: bool = False
    trace_ring: int = 1024
    deadline_ms: int = 0
    deadline_wall_ms: float = 0.0
    time_rounds: bool = True
    profiler: bool = False


def normalize_obs(obs) -> ObsConfig | None:
    """``None``/``False`` -> off, ``True`` -> defaults, a config passes."""
    if obs is None or obs is False:
        return None
    if obs is True:
        return ObsConfig()
    if isinstance(obs, ObsConfig):
        return obs
    raise TypeError(f"obs must be None, a bool, or an ObsConfig; got {type(obs).__name__}")


# ---------------------------------------------------------------------------
# Retirement bins
# ---------------------------------------------------------------------------

def n_bins(isa: ISA) -> int:
    return isa.num_ops + len(EXTRA_BINS)


def bin_names(isa: ISA) -> list[str]:
    return [isa.name[c] for c in range(isa.num_ops)] + list(EXTRA_BINS)


def hist_to_dict(hist, isa: ISA) -> dict[str, int]:
    """Full-key mapping (zeros included) so that schemas compare
    structurally."""
    h = np.asarray(hist)
    return {name: int(h[i]) for i, name in enumerate(bin_names(isa))}


def classify_host(pc_ok: bool, instr: int, num_ops: int) -> int:
    """Bin of one retired instruction, host side (the Oracle's
    ``step_hook``): Python ints share the arithmetic shift and two's
    complement ``&`` of the device classifiers for int32 cells."""
    if not pc_ok:
        return num_ops + 3
    tag = instr & 3
    if tag == TAG_OP:
        return min(max(instr >> 2, 0), num_ops)
    return num_ops + tag


# ---------------------------------------------------------------------------
# Counting slice engines (built from the interpreter's own parts)
# ---------------------------------------------------------------------------

def make_counting_finish(interp) -> Callable:
    """``finish(S, remaining, active=None) -> hist``: the interpreter's
    vmloop with a bound of ``remaining`` instructions (an int, or (N,) per
    node) on the nodes in ``active``, binning every stepped row, then the
    standard preempt.  ``hist`` is (N, num_ops + 4) int32 in node order.
    Updates ``S`` in place."""
    NB = n_bins(interp.isa)

    def finish(S, remaining, active=None):
        N, dev = S.pc.shape[0], S.pc.device
        hist = torch.zeros(N, NB, dtype=I32, device=dev)
        if isinstance(remaining, torch.Tensor):
            interp.vmloop(S, 0, active=active, budget=remaining.to(I32), hist=hist)
        else:
            interp.vmloop(S, int(remaining), active=active, hist=hist)
        interp.preempt(S)
        return hist

    return finish


def make_counting_slice(interp) -> Callable:
    """``slice_obs(S, steps) -> (found, hist)``: one micro-slice (schedule
    -> counting vmloop -> preempt), the composition of ``run_slice``."""
    finish = make_counting_finish(interp)

    def slice_obs(S, steps: int):
        found = interp.schedule(S)
        return found, finish(S, steps, active=found)

    return slice_obs


def trace_spec_hist(n: torch.Tensor, hp, length: int, loop_start: int) -> torch.Tensor:
    """Bin counts of the first ``n`` specialized steps of a recorded path,
    summed over nodes: ``(NB,)`` int32 on ``n``'s device.

    ``hp`` is the trace's ``(TRACE_MAX + 1, NB)`` prefix table (``hp[k]``
    bins the first ``k`` recorded positions).  The trace runs positions
    ``0 .. length - 1`` and then wraps to ``loop_start``, so for ``n``
    retired steps::

        base  = hp[min(n, length)]
        extra = max(n - length, 0)            # steps past the first pass
        cycle = hp[length] - hp[loop_start]   # one full wrap
        tail  = hp[loop_start + extra % len(cycle)] - hp[loop_start]

    Guards only stop consumption, so the retired steps are always exactly
    this prefix of the position sequence."""
    n = n.to(I32)
    hp = torch.as_tensor(np.asarray(hp, np.int32), device=n.device)
    base = hp[torch.clamp(n, max=length).long()]
    extra = torch.clamp(n - length, min=0)
    cyc_len = max(length - loop_start, 1)
    cycle = (hp[length] - hp[loop_start])[None, :]
    tail = hp[(loop_start + extra % cyc_len).long()] - hp[loop_start][None, :]
    return (base + (extra // cyc_len)[:, None] * cycle + tail).sum(dim=0, dtype=I32)


# ---------------------------------------------------------------------------
# Per-slice / per-round device aggregates
# ---------------------------------------------------------------------------

class ExecAux(NamedTuple):
    """Per-round execute-phase counters (device tensors).

    Backends fill what they measure and zero the rest: ``op_hist`` and
    ``io_susp`` are universal (and compare exactly); ``deopts`` is
    backend-specific (the kernel's bailed node-rounds);
    ``kernel_steps``/``bailed``/``bail_hist`` feed ``kernel_stats()``.
    """

    op_hist: Any           # (NB,) int32 — instructions retired per bin
    io_susp: Any           # ()  int32 — tasks newly IO-suspended this slice
    deopts: Any            # ()  int32 — kernel bail-outs
    kernel_steps: Any      # ()  int32 — instructions retired in the kernel
    bailed: Any            # ()  int32 — bailed node-rounds
    bail_hist: Any         # (num_ops+1,) — node-rounds that met each declined word


def zero_exec_aux(isa: ISA, device) -> ExecAux:
    z = torch.zeros((), dtype=I32, device=device)
    return ExecAux(
        op_hist=torch.zeros(n_bins(isa), dtype=I32, device=device),
        io_susp=z, deopts=z, kernel_steps=z, bailed=z,
        bail_hist=torch.zeros(isa.num_ops + 1, dtype=I32, device=device),
    )


class ObsCounters(NamedTuple):
    """The fleet's accumulated device counters: the round loop only adds to
    them; ``metrics()`` is the one synchronizing read."""

    op_retired: Any        # (NB,) int32
    mbox_high: Any         # ()  int32 — deepest mailbox after any send phase
    mbox_drops: Any        # ()  int32 — messages dropped (invalid destination)
    io_susp: Any           # ()  int32
    deopts: Any            # ()  int32
    deadline_miss: Any     # (N,) int32 — virtual-clock deadline misses per node
    rounds: Any            # ()  int32 — rounds observed


def zero_counters(n: int, isa: ISA, device) -> ObsCounters:
    z = torch.zeros((), dtype=I32, device=device)
    return ObsCounters(
        op_retired=torch.zeros(n_bins(isa), dtype=I32, device=device),
        mbox_high=z, mbox_drops=z, io_susp=z, deopts=z,
        deadline_miss=torch.zeros(n, dtype=I32, device=device),
        rounds=z,
    )


# ---------------------------------------------------------------------------
# The unified snapshot
# ---------------------------------------------------------------------------

@dataclass
class FleetMetrics:
    """Schema-stable snapshot of one fleet's telemetry; the sections (and
    their keys) are the reference's under every executor:

    ``executor``  — the active backend name;
    ``rounds``    — fleet rounds driven since construction;
    ``counters``  — the device ObsCounters (zeroed when obs is off);
    ``latency``   — the wall-clock round-latency histogram and deadline
                    misses (``DeadlineMonitor.snapshot()``);
    ``pallas``    — ``kernel_stats()`` (the reference's ``pallas_stats()``)
                    minus the executor key;
    ``trace``     — ``trace_stats()`` minus the executor key (zeroed
                    outside ``executor="trace"``);
    ``transfers`` — ``transfer_stats()`` minus executor and rounds;
    ``executive`` — ``executive_stats()`` minus the executor key: the
                    Executive's and the syscall plane's live counters
                    (zeroed only for a fleet without an Executive).
    """

    executor: str
    rounds: int
    counters: dict = field(default_factory=dict)
    latency: dict = field(default_factory=dict)
    pallas: dict = field(default_factory=dict)
    trace: dict = field(default_factory=dict)
    transfers: dict = field(default_factory=dict)
    executive: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "executor": self.executor,
            "rounds": self.rounds,
            "counters": self.counters,
            "latency": self.latency,
            "pallas": self.pallas,
            "trace": self.trace,
            "transfers": self.transfers,
            "executive": self.executive,
        }

    def __getitem__(self, key):
        return self.as_dict()[key]

    def keys(self):
        return self.as_dict().keys()
