"""Round-phase tracer — host span ring buffer + Chrome trace-event export
(counterpart of ``repro.obs.tracing``).

One fleet round decomposes into the phases the round is built from:
``schedule`` (wake/elect tasks) -> ``execute`` (the micro-slice) ->
``router`` (the clock and mailbox delivery) -> ``io_service`` (host FIOS
servicing, when it happens) -> ``warp`` (virtual-time warp).  With
``ObsConfig(trace=True)`` the fleet wraps each phase in a
:meth:`RoundTracer.span`, which records the wall-clock begin and duration
into a bounded host ring buffer (a ``deque``: old rounds fall off, memory
stays at ``trace_ring`` events).

CUDA launches are asynchronous, so a span's wall time means something only
if the phase's work is finished inside it: the fleet synchronizes its
device at the end of each traced phase.  That is why tracing is opt-in;
the default round loop adds no synchronization.

Export is the Chrome trace-event format (the ``traceEvents`` JSON that
``chrome://tracing`` and ui.perfetto.dev open): one "X" (complete) event a
span with microsecond ``ts``/``dur``, phases on ``tid`` lanes.
:func:`validate_chrome_trace` is the schema check.
"""

from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager

PHASES = ("schedule", "execute", "router", "io_service", "warp")


class RoundTracer:
    """Ring-buffered span recorder for the fleet round loop.

    ``enabled=False`` builds a no-op tracer (``span`` yields at once and
    records nothing), so call sites never branch.  Each event is a dict
    ``{name, round, t0, dt}``: ``t0`` in seconds from the tracer's epoch,
    ``dt`` the span's duration in seconds.  ``profiler=True`` also wraps
    each span in ``torch.profiler.record_function("fleet/<phase>")``.
    """

    def __init__(self, ring: int = 1024, enabled: bool = True, profiler: bool = False):
        self.enabled = bool(enabled)
        self.profiler = bool(profiler)
        self.events: deque = deque(maxlen=max(int(ring), 1))
        self.round = 0
        self.epoch = time.perf_counter()

    @contextmanager
    def span(self, name: str):
        """Record one phase span (a no-op when disabled)."""
        if not self.enabled:
            yield
            return
        ann = None
        if self.profiler:
            import torch

            ann = torch.profiler.record_function(f"fleet/{name}")
            ann.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if ann is not None:
                ann.__exit__(None, None, None)
            self.events.append({"name": name, "round": self.round, "t0": t0 - self.epoch, "dt": dt})

    def tick(self):
        """Advance the round counter (once a fleet round)."""
        if self.enabled:
            self.round += 1

    def snapshot(self) -> list[dict]:
        return list(self.events)


def export_chrome_trace(tracer_or_events, path=None, pid: int = 1):
    """Serialize spans as Chrome trace-event JSON.

    Accepts a :class:`RoundTracer` or a raw event list.  Each span becomes
    an "X" event with microsecond ``ts``/``dur``; phases get stable ``tid``
    lanes; a metadata ("M") event names the track.  Returns the payload
    dict, and writes it to ``path`` as JSON when given."""
    events = (tracer_or_events.snapshot() if isinstance(tracer_or_events, RoundTracer)
              else list(tracer_or_events))
    lanes = {name: i + 1 for i, name in enumerate(PHASES)}
    out = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "fleet-round"}}]
    for ev in events:
        out.append({
            "name": ev["name"],
            "ph": "X",
            "ts": round(ev["t0"] * 1e6, 3),
            "dur": round(ev["dt"] * 1e6, 3),
            "pid": pid,
            "tid": lanes.get(ev["name"], len(PHASES) + 1),
            "args": {"round": ev["round"]},
        })
    payload = {"traceEvents": out, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(payload, f)
    return payload


def validate_chrome_trace(trace) -> int:
    """Validate a Chrome trace-event payload (a file path, a payload dict
    or a raw event list); return its number of "X" spans.  Raises
    ``ValueError`` on a missing key, a non-numeric time or an unknown
    structure."""
    if isinstance(trace, (str, bytes)):
        with open(trace) as f:
            trace = json.load(f)
    if isinstance(trace, dict):
        if "traceEvents" not in trace:
            raise ValueError("trace object missing 'traceEvents'")
        events = trace["traceEvents"]
    elif isinstance(trace, list):
        events = trace
    else:
        raise ValueError(f"unsupported trace payload: {type(trace).__name__}")
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    n_spans = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev:
            raise ValueError(f"event {i}: not a trace event object")
        if ev["ph"] != "X":
            continue
        for key in ("name", "ts", "dur", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i}: X event missing '{key}'")
        for key in ("ts", "dur"):
            if not isinstance(ev[key], (int, float)):
                raise ValueError(f"event {i}: '{key}' must be numeric")
        n_spans += 1
    return n_spans
