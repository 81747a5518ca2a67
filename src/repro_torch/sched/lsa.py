"""Energy-aware real-time scheduling — paper §6 (Alg. 4, LSA of Moser et al.);
counterpart of ``repro.sched.lsa``, plain Python on the host.

At pod scale the "energy" is a consumable budget (wall-clock seconds, token
budget, or joules — the math is identical): a source refills the store at
``p_source`` per second, jobs drain ``e_cost`` when they run, and the Lazy
Scheduling Algorithm defers low-priority work as long as deadlines allow so
the budget is spent on deadline-critical jobs first.  With zero storage LSA
degenerates to EDF, exactly as in the paper.

The trainer uses this to multiplex {train slices, eval, checkpoint, data
compaction} under a budget; the same scheduler drives the VM node demos.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class Job:
    name: str
    priority: int                  # higher runs first within a deadline class
    deadline: float                # absolute time by which it must finish
    e_cost: float                  # energy (budget units) consumed per run
    duration: float                # predicted run time (profiled; paper §6.2)
    fn: Optional[Callable] = None  # the actual work
    period: Optional[float] = None # periodic jobs re-arm after running
    arrival: float = 0.0
    runs: int = 0
    misses: int = 0

    def key(self):
        return (self.deadline, -self.priority, self.name)


@dataclass
class EnergyModel:
    """Budget store: capacity C, refill p_source, drain while running."""

    capacity: float
    level: float
    p_source: float = 0.0          # budget replenishment per second

    def advance(self, dt: float) -> None:
        self.level = min(self.capacity, self.level + self.p_source * dt)

    def drain(self, e: float) -> bool:
        if e > self.level:
            return False
        self.level -= e
        return True


@dataclass
class LSAScheduler:
    """Modified LSA (paper Alg. 4): run a job as late as its deadline allows
    unless the store already holds its energy (laziness saves budget for
    urgent arrivals); EDF order inside the runnable set."""

    energy: EnergyModel
    now: float = 0.0
    jobs: list[Job] = field(default_factory=list)
    log: list[tuple] = field(default_factory=list)

    def add(self, job: Job) -> None:
        job.arrival = max(job.arrival, self.now)
        self.jobs.append(job)

    def _runnable(self) -> list[Job]:
        return sorted(
            (j for j in self.jobs if j.arrival <= self.now),
            key=Job.key,
        )

    def _latest_start(self, job: Job) -> float:
        return job.deadline - job.duration

    def step(self) -> Optional[Job]:
        """One scheduling decision.  Returns the job run, or None if idle."""
        run = self._runnable()
        if not run:
            return None
        for job in run:
            urgent = self.now >= self._latest_start(job)
            affordable = self.energy.level >= job.e_cost
            # LSA: wait when not urgent and the refill can still cover it.
            if not urgent and not affordable:
                continue
            if not urgent and affordable and self.energy.p_source > 0:
                # lazy: idle until latest start unless store is full
                if self.energy.level < self.energy.capacity:
                    continue
            if not affordable:
                # urgent but under-provisioned: deadline miss
                job.misses += 1
                self.log.append((self.now, job.name, True, False))
                self._finish(job, ran=False)
                return None
            return self._run(job)
        # nothing urgent/affordable: advance time toward the next event
        nxt = min(
            min((self._latest_start(j) for j in run), default=self.now + 1.0),
            self.now + self._time_to_afford(run[0]),
        )
        self.advance_to(max(nxt, self.now + 1e-3))
        return None

    def _time_to_afford(self, job: Job) -> float:
        if self.energy.p_source <= 0:
            return 1.0
        need = max(job.e_cost - self.energy.level, 0.0)
        return need / self.energy.p_source + 1e-6

    def _run(self, job: Job) -> Job:
        assert self.energy.drain(job.e_cost)
        start = self.now
        if job.fn is not None:
            job.fn()
        self.advance_to(self.now + job.duration)
        job.runs += 1
        missed = self.now > job.deadline
        if missed:
            job.misses += 1
        self.log.append((start, job.name, missed, True))
        self._finish(job, ran=True)
        return job

    def _finish(self, job: Job, ran: bool) -> None:
        if job.period is not None:
            job.arrival = self.now if ran else job.deadline
            job.deadline = job.deadline + job.period
        else:
            self.jobs.remove(job)

    def advance_to(self, t: float) -> None:
        dt = max(t - self.now, 0.0)
        self.energy.advance(dt)
        self.now = t

    def run_until(self, t_end: float, max_steps: int = 100000) -> None:
        steps = 0
        while self.now < t_end and steps < max_steps:
            before = self.now
            self.step()
            if self.now == before:
                self.advance_to(before + 1e-2)
            steps += 1

    # -- metrics ---------------------------------------------------------------

    def miss_count(self) -> int:
        return sum(j.misses for j in self.jobs) + sum(
            1 for *_, missed, _ran in self.log if missed
        )
