"""The REXA VM in PyTorch: compiler, batched interpreter, the plain-Python
Oracle, the trace-JIT, single node, device-resident fleet and voting ensemble
(counterpart of ``repro.core.vm``; imports no JAX)."""

from repro_torch.core.vm.spec import (
    ISA,
    LinearSearchTable,
    PerfectHashTable,
    WORDS,
    Word,
    get_isa,
)
from repro_torch.core.vm.compiler import Compiler, CompileError, tokenize
from repro_torch.core.vm.frames import CodeFrame, Dictionary, FrameManager
from repro_torch.core.vm.ios import DiosRegistry, FiosRegistry, FleetIOService, HostLink
from repro_torch.core.vm.routing import build_router
from repro_torch.core.vm.interp import Interpreter, interp_for
from repro_torch.core.vm.oracle import Oracle
from repro_torch.core.vm.executor import (
    BatchedSliceExecutor,
    CudaSliceExecutor,
    OracleExecutor,
    OracleFleetExecutor,
    TorchExecutor,
    make_executor,
)
from repro_torch.core.vm.trace import TraceJitExecutor, program_key
from repro_torch.core.vm.machine import REXAVM, RunResult
from repro_torch.core.vm.fleet import FleetKernels, FleetResult, FleetVM, reference_round
from repro_torch.core.vm.ensemble import EnsembleVM, VoteResult, replicate_state
from repro_torch.core.vm import vmstate

__all__ = [
    "ISA", "WORDS", "Word", "get_isa", "PerfectHashTable", "LinearSearchTable",
    "Compiler", "CompileError", "tokenize", "CodeFrame", "Dictionary", "FrameManager",
    "FiosRegistry", "DiosRegistry", "FleetIOService", "HostLink", "build_router",
    "Interpreter", "interp_for", "Oracle", "BatchedSliceExecutor", "CudaSliceExecutor",
    "OracleExecutor", "OracleFleetExecutor", "TorchExecutor", "TraceJitExecutor",
    "make_executor", "program_key", "REXAVM",
    "RunResult", "FleetKernels", "FleetResult", "FleetVM", "reference_round", "EnsembleVM",
    "VoteResult", "replicate_state", "vmstate",
]
