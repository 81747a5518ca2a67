"""The vmloop CUDA kernel on the card: byte-identical to its plain version
over the per-opcode sweep and random node states, and the fleet's
``executor="cuda"`` identical to ``executor="batched"``.  Needs an NVIDIA
GPU with nvcc; every test here skips without one.

Run on the card with ``python -m pytest tests/test_torch_cuda.py``.
"""

import pytest
import torch

from repro_torch.config import VMConfig
from repro_torch.core.vm import FleetVM, vmstate as vms
from repro_torch.kernels.vmloop import check, vmloop as kmod
from repro_torch.kernels.vmloop.ref import core_of, vmloop_ref

pytestmark = pytest.mark.cuda

CFGS = [VMConfig(cs_size=2048, steps_per_slice=64, mbox_size=4), VMConfig()]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _kernel_vs_plain(S, cfg, steps):
    P = vms.clone(S)
    launches = kmod.vmloop_call.launches
    _, *k = kmod.vmloop_call(core_of(S), steps, cfg)
    _, *p = vmloop_ref(P, steps, cfg)
    torch.cuda.synchronize()
    assert kmod.vmloop_call.launches == launches + 1
    for name, a, b in zip(("n_exec", "bailed", "bail_op"), k, p):
        assert torch.equal(a, b), name
    assert check.max_abs_diff(S, P) == (0, [])
    return k


@pytest.mark.parametrize("cfg", CFGS, ids=["small", "default"])
def test_kernel_sweep_matches_plain_version(cfg, cuda):
    pairs, S = check.sweep_states(cfg, cuda)
    n_exec, bailed, _ = _kernel_vs_plain(S, cfg, cfg.steps_per_slice)
    for (word, _), n, b in zip(pairs, n_exec.tolist(), bailed.tolist()):
        if word in ("task", "rnd", "fios/trap"):
            assert b == 1, word


@pytest.mark.parametrize("cfg", CFGS, ids=["small", "default"])
def test_kernel_random_states_match_plain_version(cfg, cuda):
    _kernel_vs_plain(check.random_states(cfg, 512, 3, cuda), cfg, 64)


def test_fleet_cuda_equals_batched(cuda):
    cfg = CFGS[0]
    n = 64

    def ring(i):
        return (f"1 {1 % n} send receive swap . . halt" if i == 0
                else f"receive swap . 1+ {(i + 1) % n} send 7 rnd drop halt")

    out = {}
    for executor in ("cuda", "batched"):
        fleet = FleetVM(cfg, n=n, executor=executor, device=cuda)
        for i, node in enumerate(fleet.nodes):
            node.launch(node.load(ring(i)))
        res = fleet.run(max_rounds=300, service_every=4)
        assert res.statuses == ["halt"] * n
        out[executor] = (res, vms.stack_states([vm.state for vm in fleet.nodes]), fleet)
    (rc, Sc, fc), (rb, Sb, _) = out["cuda"], out["batched"]
    assert rc.outputs == rb.outputs and rc.rounds == rb.rounds
    assert check.max_abs_diff(Sc, Sb) == (0, [])
    stats = fc.kernel_stats()
    assert stats["kernel_steps"] > 0 and stats["bail_hist"].get("rnd", 0) > 0
