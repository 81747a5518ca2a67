"""Static analysis over compiled REXAVM bytecode, the Auditor
(counterpart of ``repro.analysis``; imports no JAX).

Three passes, all on the host and run before a program executes:

* ``verifier``    — CFG + abstract interpretation: prove ``EXC_STACK``
                    unreachable, calls/jumps in bounds; verdicts admit a
                    fleet to vmloop's checks-elided instance;
* ``feasibility`` — static opcode footprint vs. the vmloop kernel's
                    claimed set and the trace-JIT's branch sets: resolves
                    ``FleetVM(executor="auto")``;
* ``cli``         — ``python -m repro_torch.analysis`` verify/lint over
                    source files (the CI gate).
"""

from repro_torch.analysis.verifier import (
    ERROR,
    FLAGGED,
    VERIFIED,
    Diagnostic,
    EntryReport,
    ProgramReport,
    analyze_entry,
    analyze_program,
    analyze_source,
    analyze_vm,
)
from repro_torch.analysis.feasibility import (
    BackendPlan,
    bail_words,
    plan_backend,
    predict_branch_set,
    predict_branch_sets,
)

__all__ = [
    "ERROR",
    "FLAGGED",
    "VERIFIED",
    "BackendPlan",
    "Diagnostic",
    "EntryReport",
    "ProgramReport",
    "analyze_entry",
    "analyze_program",
    "analyze_source",
    "analyze_vm",
    "bail_words",
    "plan_backend",
    "predict_branch_set",
    "predict_branch_sets",
]
