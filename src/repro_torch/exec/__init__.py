"""repro_torch.exec — the fleet Executive (paper Def. 1 / Alg. 6
multi-tasking; counterpart of ``repro.exec``).

``executive.py`` — ``ExecutiveConfig`` (preemptive scheduling on the
                   device: priority + round-robin quanta inside the
                   round loop) and ``Executive`` (host-side LSA-style
                   energy/deadline admission at spawn).
``syscalls.py``  — the numbered SVC table replacing string-keyed FIOS
                   registration, and ``VectorSyscallService``: one batched
                   handler call per syscall per round-chunk instead of
                   O(nodes) Python callbacks.
``services.py``  — the first three services: UART→serve stream sink,
                   FS→checkpoint store, CAN→mailbox bridge.
"""

from repro_torch.exec.executive import Admission, Executive, ExecutiveConfig
from repro_torch.exec.services import (
    CANService,
    FSService,
    ServiceSet,
    UARTService,
    install_services,
)
from repro_torch.exec.syscalls import (
    Syscall,
    SyscallRow,
    SyscallTable,
    VectorSyscallService,
)

__all__ = [
    "Admission",
    "Executive",
    "ExecutiveConfig",
    "Syscall",
    "SyscallRow",
    "SyscallTable",
    "VectorSyscallService",
    "UARTService",
    "FSService",
    "CANService",
    "ServiceSet",
    "install_services",
]
