"""The port's batched interpreter against the JAX package's: three
``run_slice`` calls (schedule -> vmloop -> preempt) over every sweep
program of ``tests/test_torch_vmloop.py`` (all 99 words plus a FIOS call,
with the edge values), exact on every field."""

import numpy as np
import torch

from repro.core.vm import REXAVM as JVM
from repro.core.vm.executor import BatchedSliceExecutor as JBatched
from test_torch_vmloop import (  # noqa: F401  (ref_states is a fixture)
    CFG, JCFG, PAIRS, STEPS, _compare, _jax_state, _running, ref_states,
)

from repro_torch.core.vm import vmstate as vms
from repro_torch.core.vm.interp import interp_for
from repro_torch.kernels.vmloop import ref as pref

# The suite runs in several worker processes on shared cores: keep torch's
# CPU kernels to one thread each so these tests do not crowd out the rest.
torch.set_num_threads(1)


def test_run_slice_equals_reference(ref_states):
    """Three schedule -> vmloop -> preempt slices of every sweep program
    (all 99 words plus FIOS) through the reference's batched interpreter
    and the port's."""
    jb = JBatched(JCFG)
    JS = _jax_state(ref_states)
    PS = vms.from_reference(ref_states, "cpu")
    it = interp_for(CFG)
    for k in range(3):
        JS, jfound = jb.run_slice_batched(JS, STEPS)
        pfound = it.run_slice(PS, STEPS)
        assert np.array_equal(np.asarray(jfound), pfound.numpy()), k
    _compare(PS, (), JS, (), "run_slice")


def test_int_min_division_matches_interp_not_oracle(ref_states):
    """INT_MIN / 3 is 715827883 in the reference interpreter and kernel
    (abs wraps at INT_MIN) and so in the port; the reference Oracle gives
    -715827882.  A known difference of the reference, kept in the sweep."""
    prog = "-2147483648 3 / halt"
    i = PAIRS.index(("/", prog))
    PS = vms.from_reference(_running(ref_states), "cpu")
    pref.vmloop_ref(PS, STEPS, CFG)
    assert int(PS.ds[i, 0, 0]) == 715827883
    vm = JVM(JCFG, backend="oracle")
    vm.run(vm.load(prog))
    assert int(vm.state.ds[0, 0]) == -715827882


