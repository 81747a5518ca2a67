"""VM-driven "measuring job" for the serve engine, on the fleet runtime
(counterpart of ``repro.serve.vmhook``).

Paper C9 binds host functions into the VM word set so that textual active
messages can implement measuring logic.  Here the monitored system is the
serving engine: ``FleetServeMonitor`` attaches to
:attr:`ServeEngine.on_step` and runs N monitor nodes as one device-resident
:class:`~repro_torch.core.vm.fleet.FleetVM`.  Each engine step publishes
the serving counters into every node's ``stats`` DIOS array, relaunches
the resident measuring frame and runs bounded fleet rounds; whatever the
jobs ``out`` lands on each node's host stream (``node.out_stream``).
"""

from __future__ import annotations

import numpy as np

from repro_torch.config import VMConfig
from repro_torch.core.vm.fleet import FleetVM
from repro_torch.serve.engine import ServeStats

# Default measuring job: report the decode-token delta since the last step.
# stats layout (DIOS): [steps, prefill_tokens, decode_tokens]
DEFAULT_JOB = """
( measuring job: decode-token rate )
2 stats get dup           ( -- decode decode )
0 prev get - out          ( report delta to the host stream )
0 prev put                ( remember current count )
"""


class FleetServeMonitor:
    """N VM measuring jobs over one device-resident fleet.

    Usage::

        monitor = FleetServeMonitor(n=2, executor="cuda")
        engine = ServeEngine(model, params, on_step=monitor)
        engine.generate(prompts)
        monitor.reports()      # -> per-node list of reported values

    ``executor`` is ``"batched"``, ``"cuda"`` (the vmloop kernel),
    ``"oracle"`` or ``"trace"`` (the trace-JIT: every node runs the same
    job, one program group); ``device=None`` runs on CUDA and raises when
    there is none.  ``obs`` turns on the monitor fleet's telemetry (an
    ``ObsConfig``, or ``True``), read by :meth:`metrics`.  ``mesh`` (a
    ``launch.mesh.NodeMesh``, exclusive with ``device``) partitions the
    monitor fleet's node axis over it (``FleetVM(mesh=)``).
    """

    STATS_CELLS = 3

    def __init__(
        self,
        n: int = 1,
        job: str = DEFAULT_JOB,
        cfg: VMConfig | None = None,
        rounds_per_step: int = 8,
        mesh=None,
        executor: str = "batched",
        obs=None,
        device=None,
    ):
        self.cfg = cfg or VMConfig()
        self.rounds_per_step = rounds_per_step
        self.fleet = FleetVM(self.cfg, n=n, executor=executor, device=device, obs=obs,
                             mesh=mesh)
        self._frames = []
        for node in self.fleet.nodes:
            node.dios_add("stats", np.zeros(self.STATS_CELLS, np.int32))
            node.dios_add("prev", np.zeros(1, np.int32))
            self._frames.append(node.load(job, persistent=True))
        self.steps_seen = 0

    def __call__(self, stats: ServeStats) -> None:
        """ServeEngine.on_step: publish counters, run the measuring jobs."""
        row = [stats.steps, stats.prefill_tokens, stats.decode_tokens]
        for node, frame in zip(self.fleet.nodes, self._frames):
            node.dios_write("stats", row)
            node.launch(frame)
        self.fleet.run(max_rounds=self.rounds_per_step)
        self.steps_seen += 1

    def reports(self) -> list[list[int]]:
        """Per-node values reported via ``out`` so far."""
        return [list(node.out_stream) for node in self.fleet.nodes]

    def transfer_stats(self) -> dict:
        """The monitor's own overhead: the fleet's transfer counters."""
        return self.fleet.transfer_stats()

    def trace_stats(self) -> dict:
        """The monitor fleet's trace-engine counters (``FleetVM.
        trace_stats()``: zeroed unless ``executor="trace"``)."""
        return self.fleet.trace_stats()

    def metrics(self):
        """The monitor fleet's ``FleetMetrics``: the measuring jobs' own
        retirement counters, mailbox pressure and round latency, so the
        observer's cost is itself observable.  The same schema whether or
        not ``obs`` was given."""
        return self.fleet.metrics()
