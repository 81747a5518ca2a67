"""Observability plane for the VM fleet (counterpart of ``repro.obs``).

``metrics.py``   — the counter schema: per-opcode instructions retired,
                   mailbox high-watermark/drops, IO suspensions and kernel
                   bail-outs, accumulated on the device and read by
                   ``FleetVM.metrics()`` with identical keys under every
                   executor; the counting slice engines;
``tracing.py``   — the round-phase tracer: wall-clock spans per round phase
                   in a host ring buffer, exportable as Chrome trace-event
                   JSON (``FleetVM.export_trace``);
``deadline.py``  — the real-time monitor: a log-bucketed per-round latency
                   histogram and wall-clock round deadlines (virtual-clock
                   misses are counted per node on the device).

Off by default, with no extra device outputs; turn it on with
``FleetVM(..., obs=ObsConfig(...))`` (or ``obs=True``).
"""

from repro_torch.obs.deadline import DeadlineMonitor
from repro_torch.obs.metrics import ExecAux, FleetMetrics, ObsConfig, ObsCounters
from repro_torch.obs.tracing import RoundTracer, export_chrome_trace, validate_chrome_trace

__all__ = [
    "DeadlineMonitor",
    "ExecAux",
    "FleetMetrics",
    "ObsConfig",
    "ObsCounters",
    "RoundTracer",
    "export_chrome_trace",
    "validate_chrome_trace",
]
