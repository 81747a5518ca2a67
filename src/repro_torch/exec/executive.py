"""The Executive: multi-task nodes with admission-controlled spawning
(counterpart of ``repro.exec.executive``).

The paper's VM (Def. 1, Alg. 6) is explicitly multi-tasking: every node
already materializes a task table in ``VMState`` — per-slot ``pc``,
``tstatus``, ``prio``, ``deadline``, and a private stack window in
``ds``/``rs``/``fs``.  What was missing is an *executive* over that table:

* **device side** — ``Interpreter.schedule_prio`` (and its Oracle mirror), a
  preemptive scheduler that picks the next runnable slot *inside* the round
  loop: runnability classes exactly as Alg. 6 (IO events > timeouts >
  ready), ties broken by ``prio`` and then round-robin rotation from the
  last-run slot, with a ``quantum``-instruction preemption budget per
  micro-slice.  ``ExecutiveConfig`` selects this scheduler fleet-wide via
  ``FleetVM(executive=...)``.
* **host side** — :class:`Executive`, LSA-style admission at ``spawn``
  (``sched/lsa.py``): a task is admitted only if its declared energy cost
  fits the node's :class:`EnergyModel` budget and its predicted duration
  fits the deadline; rejected spawns are counted and logged, never
  launched.

Task-table layout (slot = task id, ``T = cfg.max_tasks``):

====  =========================================================
slot  use
====  =========================================================
0     boot task (``launch``/``run`` default; daemons live here)
1+    spawned tasks — host ``Executive.spawn`` or the ``task`` word
====  =========================================================

A round under the Executive runs ``slices`` micro-slices of ``quantum``
instructions each (``quantum * slices`` replaces ``steps_per_slice``), so a
high-priority wakeup preempts a busy task within one quantum rather than
one round.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.vm import vmstate as vms
from repro_torch.core.vm.spec import ST_FREE
from repro_torch.sched.lsa import EnergyModel


@dataclass(frozen=True)
class ExecutiveConfig:
    """Fleet-wide Executive scheduling parameters.

    Frozen and hashable, like ``VMConfig``.  ``quantum * slices``
    instructions run per fleet round (the defaults cover
    ``steps_per_slice=256``).
    """

    quantum: int = 32        # instructions per Executive micro-slice
    slices: int = 8          # micro-slices per fleet round

    def __post_init__(self):
        if self.quantum < 1 or self.slices < 1:
            raise ValueError("ExecutiveConfig.quantum/slices must be >= 1")

    @property
    def steps_per_round(self) -> int:
        return self.quantum * self.slices


@dataclass
class Admission:
    """One spawn decision (the Executive's audit log row)."""

    node: int
    task: int                # slot launched, -1 if rejected
    prio: int
    deadline: int
    admitted: bool
    reason: str              # "ok" | "no-slot" | "infeasible" | "no-energy"


class Executive:
    """Host-side executive over a fleet's task tables.

    ``spawn`` mutates the *host* node states; call it before
    ``FleetVM.run``/``start`` or between runs — when the fleet is live on
    the device the Executive syncs it first and pushes the refreshed states
    after (a whole-state copy each way per spawn).
    """

    def __init__(self, fleet, energy: Optional[EnergyModel] = None):
        self.fleet = fleet
        self.nodes = fleet.nodes
        # Per-node budget stores, copied from the template (infinite budget
        # when admission is deadline-only).
        tpl = energy or EnergyModel(capacity=float("inf"), level=float("inf"))
        self.energy = [
            EnergyModel(tpl.capacity, tpl.level, tpl.p_source) for _ in self.nodes
        ]
        self._last_now = [0] * len(self.nodes)
        self.log: list[Admission] = []

    # -- admission --------------------------------------------------------------

    def _free_slot(self, st) -> int:
        for t in range(1, len(st.tstatus)):  # slot 0 is the boot task
            if int(st.tstatus[t]) == ST_FREE:
                return t
        return -1

    def spawn(
        self,
        node: int,
        prog,
        prio: int = 0,
        deadline: int = 0,
        e_cost: float = 0.0,
        duration_ms: int = 0,
        task: int | None = None,
    ) -> int:
        """Admit-and-launch ``prog`` on ``node``; returns the slot or -1.

        ``prog`` is program text (compiled via the node's frontend) or an
        entry address.  ``deadline`` is an absolute virtual-clock ms bound
        (0 = none); ``duration_ms`` the declared run-time estimate and
        ``e_cost`` the declared energy draw (LSA Job fields).

        When the caller declares no ``duration_ms`` but sets a deadline,
        the static verifier's WCET bound (``repro_torch.analysis``) stands in:
        ``ceil(wcet_instructions * cfg.us_per_instr / 1000)`` virtual ms —
        a program whose *worst case* cannot meet its deadline is rejected
        before it runs.  Statically unbounded programs (unbounded loops,
        recursion) keep ``duration_ms = 0``: admission stays deadline-only
        and the run-time deadline monitor covers them, quantum by quantum.
        """
        vm = self.nodes[node]
        live = getattr(self.fleet, "_S", None) is not None
        if live:
            self.fleet.sync()
        st = vm.state
        now = int(st.now)
        energy = self.energy[node]
        energy.advance(max(0, now - self._last_now[node]) / 1000.0)
        self._last_now[node] = now

        slot = task if task is not None else self._free_slot(st)
        if slot < 0 or int(st.tstatus[slot]) != ST_FREE:
            return self._reject(node, prio, deadline, "no-slot")
        entry = prog if isinstance(prog, int) else vm.load(prog).entry
        if duration_ms == 0 and deadline > 0:
            duration_ms = self._wcet_ms(vm, entry)
        if deadline > 0 and now + duration_ms > deadline:
            return self._reject(node, prio, deadline, "infeasible")
        if not energy.drain(e_cost):
            return self._reject(node, prio, deadline, "no-energy")
        vm.state = vms.launch_task(vm.state, slot, entry, prio, deadline)
        self.log.append(Admission(node, slot, prio, deadline, True, "ok"))
        if hasattr(self.fleet, "_spawns_admitted"):
            self.fleet._spawns_admitted += 1
        if live:
            self.fleet.push()
        return slot

    def _wcet_ms(self, vm, entry: int) -> int:
        """WCET-backed default duration: the verifier's instruction bound
        scaled by the node's calibrated virtual-clock rate; 0 (no bound)
        when the program is statically unbounded or fails to analyze."""
        import math

        from repro_torch.analysis.verifier import analyze_vm

        rep = analyze_vm(vm, entries=[(entry, 0, 0, 0, 0)])
        if rep.wcet is None:
            return 0
        return int(math.ceil(rep.wcet * vm.cfg.us_per_instr / 1000))

    def _reject(self, node: int, prio: int, deadline: int, reason: str) -> int:
        self.log.append(Admission(node, -1, prio, deadline, False, reason))
        if hasattr(self.fleet, "_spawns_rejected"):
            self.fleet._spawns_rejected += 1
        return -1

    # -- introspection ----------------------------------------------------------

    @property
    def spawns_admitted(self) -> int:
        return sum(1 for a in self.log if a.admitted)

    @property
    def spawns_rejected(self) -> int:
        return sum(1 for a in self.log if not a.admitted)

    def task_table(self, node: int) -> list[dict]:
        """Host view of one node's task table (debug/serve introspection)."""
        st = self.nodes[node].state
        return [
            {
                "task": t,
                "status": int(st.tstatus[t]),
                "pc": int(st.pc[t]),
                "prio": int(st.prio[t]),
                "deadline": int(st.deadline[t]),
            }
            for t in range(len(st.tstatus))
        ]
