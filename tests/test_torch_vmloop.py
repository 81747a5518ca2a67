"""The vmloop kernel's plain version, the batched interpreter and the CPU
build of the kernel's C++ op bodies, against the JAX package.

The batched interpreter's ``run_slice`` against the reference's is in
``tests/test_torch_interp.py`` (each file compiles one JAX function).

Inputs: the reference's per-opcode sweep (``tests/test_vm_pallas.py``),
the port's edge-value sweep (``repro_torch.kernels.vmloop.check``: int32
extremes, divisor 0 and INT_MIN, shifts >= 32, addresses outside cs/mem)
and random node states.  Every comparison is exact on every field.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import VMConfig as JCfg
from repro.core.vm import REXAVM as JVM
from repro.core.vm import vmstate as jvms
from repro.kernels.vmloop import ref as jref
from test_vm_pallas import BAIL_PROGRAMS, PURE_PROGRAMS

from repro_torch.config import VMConfig
from repro_torch.core.vm import vmstate as vms
from repro_torch.core.vm.spec import ST_RUN, get_isa
from repro_torch.kernels.vmloop import check, ref as pref
from repro_torch.kernels.vmloop.ops import fleet_vmloop
from repro_torch.kernels.vmloop import vmloop as kmod
from repro_torch.kernels.vmloop.vmloop import vmloop_call

# The suite runs in several worker processes on shared cores: keep torch's
# CPU kernels to one thread each so these tests do not crowd out the rest.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "vmloop" / "csrc"
JCFG = JCfg(cs_size=2048, steps_per_slice=64, mbox_size=4)
CFG = VMConfig(cs_size=2048, steps_per_slice=64, mbox_size=4)
STEPS = CFG.steps_per_slice

PAIRS = list(dict.fromkeys(
    [(w, p) for w, ps in PURE_PROGRAMS.items() for p in ps]
    + [(w, p) for w, ps in BAIL_PROGRAMS.items() for p in ps]
    + check.sweep_programs(CFG)
))
N = len(PAIRS)


def _np_state(S):
    return jvms.VMState(*[np.array(x) for x in S])


def _jax_state(S):
    return jvms.VMState(*[jnp.array(np.array(x)) for x in S])


@pytest.fixture(scope="module")
def ref_states():
    """The sweep compiled by the reference (one node per program), stacked
    numpy; the FIOS program registers `seven` first."""
    states = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for _, prog in PAIRS:
            vm = JVM(JCFG, backend="oracle")
            vm.fios_add("seven", lambda: 7, args=0, ret=1)
            vm.launch(vm.load(prog))
            states.append(vm.state)
    return jvms.stack_states(states)


def _running(S):
    """Task 0 of every node ST_RUN and current, as the scheduler leaves a
    freshly launched node."""
    S = _np_state(S)
    S.tstatus[:, 0] = ST_RUN
    S.cur[:] = 0
    return S


@pytest.fixture(scope="module")
def jax_vmloop():
    return jax.jit(lambda S: jref.vmloop_ref(S, STEPS, JCFG))


def _compare(port_S, port_out, ref_S, ref_out, what):
    R = vms.to_reference(port_S)
    for f in jvms.VMState._fields:
        a, b = np.asarray(getattr(ref_S, f)), getattr(R, f)
        if not np.array_equal(a, b):
            rows = [i for i in range(a.shape[0]) if not np.array_equal(a[i], b[i])]
            pytest.fail(f"{what}: field {f} differs on nodes {rows[:8]}")
    for name, a, b in zip(("n_exec", "bailed", "bail_op"), ref_out, port_out):
        a = np.asarray(a).astype(np.int32)
        assert np.array_equal(a, b.numpy()), (what, name, np.flatnonzero(a != b.numpy())[:8])


def test_classification_equals_reference():
    assert pref.SUPPORTED_WORDS == jref.SUPPORTED_WORDS
    assert pref.BAILOUT_WORDS == jref.BAILOUT_WORDS
    assert np.array_equal(pref.supported_mask(), jref.supported_mask())
    for a, b in zip(pref.make_tables(), jref.make_tables()):
        assert np.array_equal(a, b)
    assert pref.CORE_FIELDS == jref.CORE_FIELDS
    check.check_sweep_covers_isa()


def test_header_opcodes_match_isa():
    text = (CSRC / "vmloop_core.h").read_text()
    found = {m.group(2): int(m.group(1)) for m in re.finditer(r"OP_\w+ = (\d+),\s+// (\S+)", text)}
    assert found == dict(get_isa().opcode)
    assert f"NUM_OPS = {get_isa().num_ops}" in text


def test_port_compiles_the_sweep_identically(ref_states):
    _, S = check.sweep_states(CFG, "cpu")
    pairs = check.sweep_programs(CFG)
    idx = [PAIRS.index(p) for p in pairs]
    assert np.array_equal(vms.to_reference(S).cs, ref_states.cs[idx])


def test_vmloop_ref_sweep_equals_reference(ref_states, jax_vmloop):
    S0 = _running(ref_states)
    JS, *jout = jax_vmloop(_jax_state(S0))
    PS = vms.from_reference(S0, "cpu")
    PS, *pout = pref.vmloop_ref(PS, STEPS, CFG)
    _compare(PS, pout, JS, jout, "sweep")
    n_exec, bailed = pout[0].tolist(), pout[1].tolist()
    for (word, prog), n, b in zip(PAIRS, n_exec, bailed):
        if word in pref.BAILOUT_WORDS or word == "fios/trap":
            assert b == 1, (word, prog)
    ran = {w for (w, _), n, b in zip(PAIRS, n_exec, bailed) if n > 0 and not b}
    assert set(pref.SUPPORTED_WORDS) <= ran


@pytest.mark.parametrize("seed", [0, 1])
def test_vmloop_ref_random_states_equal_reference(seed, jax_vmloop):
    PS = check.random_states(CFG, N, seed, "cpu")
    S0 = vms.to_reference(PS)
    JS, *jout = jax_vmloop(_jax_state(S0))
    PS, *pout = pref.vmloop_ref(PS, STEPS, CFG)
    _compare(PS, pout, JS, jout, f"random seed {seed}")


def test_state_round_trip(ref_states):
    single = jvms.VMState(*[np.array(x[3]) for x in ref_states])
    single = single._replace(rng=np.uint32(0xFFFFFFFE))
    for st in (single, ref_states):
        P = vms.from_reference(st, "cpu")
        assert P.rng.dtype == torch.int64 and P.cs.dtype == torch.int32
        back = vms.to_reference(P)
        for f in jvms.VMState._fields:
            a, b = np.asarray(getattr(st, f)), getattr(back, f)
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f
    assert int(vms.from_reference(single, "cpu").rng) == 0xFFFFFFFE


def test_vmloop_call_on_cpu_takes_the_plain_version(ref_states):
    S0 = _running(ref_states)
    A = vms.from_reference(S0, "cpu")
    B = vms.clone(A)
    launches = vmloop_call.launches
    _, *a = fleet_vmloop(A, STEPS, CFG)
    _, *b = pref.vmloop_ref(B, STEPS, CFG)
    assert vmloop_call.launches == launches
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert check.max_abs_diff(A, B) == (0, [])
    with pytest.raises(ValueError, match="int32"):
        vmloop_call(pref.core_of(A._replace(pc=A.pc.long())), STEPS, CFG)


# ---------------------------------------------------------------------------
# The kernel's C++ op bodies, built for the CPU with g++
# ---------------------------------------------------------------------------

def _build_host():
    """The header's CPU build (vmloop_host.cpp), bound: ``run(S, cfg,
    steps, rows=None, budget=None, obs=False, elide=False) -> [n_exec,
    bailed, bail_op]`` (and ``op_hist`` with ``obs=True``, the counting
    instance; ``elide=True`` runs the checks-elided instance)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's op bodies for the CPU")
    src = CSRC / "vmloop_host.cpp"
    digest = hashlib.sha256(src.read_bytes()
                            + (CSRC / "vmloop_core.h").read_bytes()).hexdigest()[:16]
    out = ROOT / "build" / "repro_torch_test" / f"libvmloop_host_{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Werror",
                        "-o", str(tmp), str(src)], check=True, capture_output=True, text=True)
        tmp.replace(out)
    lib = ctypes.CDLL(str(out))
    head = [ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32] + [ctypes.c_void_p] * 3
    lib.vmloop_host.argtypes = lib.vmloop_host_elide.argtypes = head
    lib.vmloop_host_obs.argtypes = head + [ctypes.c_void_p]
    for fn in (lib.vmloop_host, lib.vmloop_host_obs, lib.vmloop_host_elide):
        fn.restype = ctypes.c_int

    def run(S, cfg, steps, rows=None, budget=None, obs=False, elide=False):
        core = pref.core_of(S)
        tb, meta = kmod._tables(None, "cpu")
        n = S.pc.shape[0] if rows is None else rows.shape[0]
        outs = [torch.full((n,), 12345, dtype=torch.int32) for _ in range(3)]
        if obs:
            outs.append(torch.full((n, get_isa().num_ops + 4), 12345, dtype=torch.int32))
        fields = (ctypes.c_void_p * 24)(*[getattr(core, f).data_ptr() for f in pref.CORE_FIELDS])
        tabs = (ctypes.c_void_p * 9)(*[t.data_ptr() for t in tb])
        dims = kmod._dims(cfg)
        ptr = [None if x is None else x.data_ptr() for x in (rows, budget)]
        fn = lib.vmloop_host_obs if obs else lib.vmloop_host_elide if elide else lib.vmloop_host
        assert fn(fields, tabs, meta.data_ptr(), dims, S.pc.shape[0], steps, *ptr, n,
                  *[o.data_ptr() for o in outs]) == 0
        return outs
    return run


@pytest.fixture(scope="module")
def host_kernel():
    return _build_host()


@pytest.mark.parametrize("cfg", [CFG, VMConfig()], ids=["small", "default"])
def test_host_build_of_kernel_matches_plain_version(cfg, host_kernel):
    _, S = check.sweep_states(cfg, "cpu")
    for A in (S, check.random_states(cfg, 256, cfg.cs_size, "cpu")):
        B = vms.clone(A)
        _, *plain = pref.vmloop_ref(A, cfg.steps_per_slice, cfg)
        kern = host_kernel(B, cfg, cfg.steps_per_slice)
        for name, a, b in zip(("n_exec", "bailed", "bail_op"), plain, kern):
            assert torch.equal(a, b), name
        assert check.max_abs_diff(A, B) == (0, [])


def _rows_cases(n: int, steps: int, seed: int) -> dict:
    """Row lists and budgets over n nodes: (rows, budget), either None."""
    rng = np.random.default_rng(seed)
    i32 = functools.partial(torch.tensor, dtype=torch.int32)
    skip = np.sort(rng.choice(n, size=n // 3, replace=False))
    return {
        "budget_only": (None, i32(rng.integers(-3, steps + 5, size=n))),
        "zero_budgets": (None, i32(np.zeros(n, np.int64))),
        "rows_skip_nodes": (i32(skip), None),
        "rows_shuffled_ragged_budget": (i32(rng.permutation(n)[: n - 5]),
                                        i32(rng.integers(0, 9, size=n - 5))),
        "rows_outside_fleet": (i32([n + 3, -1, 0, n - 1]), i32([5, 5, 2, 7])),
        "no_rows": (i32(np.zeros(0, np.int64)), None),
    }


def _host_vs_plain(run, A, cfg, steps, rows, budget, obs=False):
    B = vms.clone(A)
    _, *plain = pref.run_core(pref.core_of(A), pref.device_tables(None, "cpu"), steps, cfg,
                              rows=rows, budget=budget, obs=obs)
    kern = run(B, cfg, steps, rows=rows, budget=budget, obs=obs)
    assert len(plain) == len(kern) == (4 if obs else 3)
    for name, a, b in zip(("n_exec", "bailed", "bail_op", "op_hist"), plain, kern):
        assert torch.equal(a, b), name
    assert check.max_abs_diff(A, B) == (0, [])
    return plain


@pytest.mark.parametrize("case", list(_rows_cases(8, 8, 0)))
def test_host_build_rows_and_budget_match_plain_version(case, host_kernel):
    """Row lists and per-row budgets, on the sweep (INT_MIN operands kept)
    and on random states where some nodes are not ST_RUN; 37 and 203 nodes
    are no multiple of any block."""
    for A in (check.sweep_states(CFG, "cpu")[1], check.random_states(CFG, 203, 5, "cpu")):
        N = A.pc.shape[0]
        if A.pc.shape[0] == 203:                      # some current tasks not ST_RUN
            A.tstatus[torch.arange(0, N, 4), A.cur[::4].long()] = 7
        rows, budget = _rows_cases(N, STEPS, N)[case]
        plain = _host_vs_plain(host_kernel, A, CFG, STEPS, rows, budget)
        if case == "zero_budgets":
            assert int(plain[0].abs().sum()) == 0 and bool((plain[2] == -1).all())


def test_plain_rows_equal_whole_fleet_where_they_cover_it():
    """The plain version over a row list with budgets equal to ``steps``
    leaves the same state as over the whole fleet, row outputs in row
    order; rows left out keep their state."""
    A = check.random_states(CFG, 64, 9, "cpu")
    B, C = vms.clone(A), vms.clone(A)
    tb = pref.device_tables(None, "cpu")
    _, *whole = pref.run_core(pref.core_of(A), tb, STEPS, CFG)
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(0)).to(torch.int32)
    _, *part = pref.run_core(pref.core_of(B), tb, STEPS, CFG, rows=perm,
                             budget=torch.full((64,), STEPS, dtype=torch.int32))
    assert check.max_abs_diff(A, B) == (0, [])
    for a, b in zip(whole, part):
        assert torch.equal(a[perm.long()], b)
    _, *none = pref.run_core(pref.core_of(C), tb, STEPS, CFG, rows=perm[:0])
    assert all(x.numel() == 0 for x in none)
    assert check.max_abs_diff(C, vms.clone(check.random_states(CFG, 64, 9, "cpu"))) == (0, [])


@pytest.mark.parametrize("seed", range(100, 109))
def test_host_build_random_fleets_match_plain_version(seed, host_kernel):
    """Random bytecode and machine state (vector words over headers of any
    length, clamped addresses, int32 extremes) on 67 nodes, no multiple of
    any block: the whole fleet, then a shuffled row list with budgets."""
    A = check.random_states(CFG, 67, seed, "cpu")
    _host_vs_plain(host_kernel, A, CFG, STEPS, None, None)
    rows, budget = _rows_cases(67, STEPS, seed)["rows_shuffled_ragged_budget"]
    _host_vs_plain(host_kernel, check.random_states(CFG, 67, seed + 50, "cpu"), CFG, STEPS,
                   rows, budget)


# ---------------------------------------------------------------------------
# The counting instance's op bodies (run_core<true>), built with g++
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [CFG, VMConfig()], ids=["small", "default"])
def test_host_build_of_counting_instance_matches_plain_version(cfg, host_kernel):
    """The sweep (every word, FIOS, INT_MIN operands) and 256 random nodes:
    states, n_exec/bailed/bail_op and each row's 103 bins equal the plain
    version's; each row's bins total its n_exec."""
    _, S = check.sweep_states(cfg, "cpu")
    for A in (S, check.random_states(cfg, 256, cfg.cs_size + 7, "cpu")):
        n, _, _, h = _host_vs_plain(host_kernel, A, cfg, cfg.steps_per_slice, None, None, obs=True)
        assert torch.equal(h.sum(dim=1), n)


@pytest.mark.parametrize("case", list(_rows_cases(8, 8, 0)))
def test_host_build_counting_rows_and_budget_match_plain_version(case, host_kernel):
    """The counting instance over row lists and per-row budgets: the
    histograms come back in row order (a row outside the fleet reads 0)."""
    for A in (check.sweep_states(CFG, "cpu")[1], check.random_states(CFG, 203, 6, "cpu")):
        N = A.pc.shape[0]
        rows, budget = _rows_cases(N, STEPS, N + 1)[case]
        _host_vs_plain(host_kernel, A, CFG, STEPS, rows, budget, obs=True)


def test_default_and_counting_instances_run_alike(host_kernel):
    """The two instances leave the same state and the same n_exec, bailed
    and bail_op on random fleets."""
    for seed in (21, 22):
        A = check.random_states(CFG, 67, seed, "cpu")
        B = vms.clone(A)
        a = host_kernel(A, CFG, STEPS)
        b = host_kernel(B, CFG, STEPS, obs=True)
        assert all(torch.equal(x, y) for x, y in zip(a, b[:3]))
        assert check.max_abs_diff(A, B) == (0, [])


def test_vmloop_call_checks_rows_and_budget():
    A = check.random_states(CFG, 8, 0, "cpu")
    core = pref.core_of(A)
    i32 = functools.partial(torch.tensor, dtype=torch.int32)
    with pytest.raises(ValueError, match="rows"):
        vmloop_call(core, STEPS, CFG, rows=i32([[0, 1]]))
    with pytest.raises(ValueError, match="rows"):
        vmloop_call(core, STEPS, CFG, rows=torch.tensor([0, 1]))
    with pytest.raises(ValueError, match="budget"):
        vmloop_call(core, STEPS, CFG, rows=i32([0, 1]), budget=i32([1, 2, 3]))
    with pytest.raises(ValueError, match="budget"):
        vmloop_call(core, STEPS, CFG, budget=i32([1, 2]))
    with pytest.raises(ValueError, match="budget"):
        vmloop_call(core, STEPS, CFG, budget=torch.ones(8, dtype=torch.int32)[::1].float())
    launches = vmloop_call.launches
    _, n, b, o = vmloop_call(core, STEPS, CFG, rows=i32([3, 1]), budget=i32([0, 2]))
    assert vmloop_call.launches == launches
    assert n.shape == b.shape == o.shape == (2,) and int(n[0]) == 0


def test_nodes_per_block_spreads_small_fleets():
    assert kmod.nodes_per_block(64, 132) == 1
    assert kmod.nodes_per_block(256, 132) == 1
    assert kmod.nodes_per_block(4096, 132) == 8
    assert kmod.nodes_per_block(10 ** 6, 132) == 32
    assert kmod.nodes_per_block(0, 132) == 1
