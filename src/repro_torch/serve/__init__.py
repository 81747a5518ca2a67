from repro_torch.serve.engine import ServeEngine, ServeStats
from repro_torch.serve.vmhook import FleetServeMonitor

__all__ = ["ServeEngine", "ServeStats", "FleetServeMonitor"]
