"""The PyTorch port's host side against the JAX package: ISA tables,
compiler bytecode, fixed-point LUT words, and the import boundary (the
port imports neither jax nor the JAX package).  All comparisons exact."""

import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import VMConfig as JCfg
from repro.core import fixedpoint as jfx
from repro.core.vm import spec as jspec
from repro.core.vm.compiler import CompileError as JCompileError
from repro.core.vm.compiler import Compiler as JCompiler
from repro.core.vm.compiler import tokenize as jtokenize
from repro.core.vm.frames import FrameManager as JFrames
from repro.core.vm.ios import FiosRegistry as JFios

from repro_torch.config import VMConfig
from repro_torch.core import fixedpoint as pfx
from repro_torch.core.vm import spec as pspec
from repro_torch.core.vm.compiler import CompileError, Compiler, tokenize
from repro_torch.core.vm.frames import FrameManager
from repro_torch.core.vm.ios import FiosRegistry

# The suite runs in several worker processes on shared cores: keep torch's
# CPU kernels to one thread each so these tests do not crowd out the rest.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


class TestISA:
    def test_words_equal_reference(self):
        ji, pi = jspec.get_isa(), pspec.get_isa()
        assert pi.num_ops == ji.num_ops
        for jw, pw in zip(ji.words, pi.words):
            assert (pw.name, pw.effect, pw.category, pw.stack) == (
                jw.name, jw.effect, jw.category, jw.stack)
            assert pi.opcode[pw.name] == ji.opcode[jw.name]

    def test_constants_equal_reference(self):
        for name in ("TAG_OP", "TAG_LIT", "TAG_CALL", "FIOS_BASE", "MAX_FIOS", "MEM_BASE",
                     "NUM_EXC", "EXC_NAMES", "STACK_EFFECTS", "LIT_MIN", "LIT_MAX"):
            assert getattr(pspec, name) == getattr(jspec, name), name
        for name in dir(jspec):
            if name.startswith(("ST_", "EXC_")):
                assert getattr(pspec, name) == getattr(jspec, name), name

    def test_lookup_tables_equal_reference(self):
        names = [w.name for w in jspec.WORDS]
        jp, pp = jspec.PerfectHashTable(names), pspec.PerfectHashTable(names)
        jl, pl = jspec.LinearSearchTable(names), pspec.LinearSearchTable(names)
        assert (pp.disp, pp.check) == (jp.disp, jp.check)
        assert (pl.header, pl.entries) == (jl.header, jl.entries)
        for w in names + ["foo", "", "dupp", "++"]:
            assert pp.lookup(w) == jp.lookup(w) and pl.lookup(w) == jl.lookup(w)


# ---------------------------------------------------------------------------
# Bytecode
# ---------------------------------------------------------------------------

COMPILER_PROGRAMS = [
    "5 -3 +", "1000000000l drop", ": sq dup * ; export sq", "import sq 3 sq drop",
    " ".join(["7"] * 100) + " " + "+ " * 99 + "drop", "array buf 100 5 0 buf put",
    "const X 42 X drop", "1 2 + drop", ": f 1 2 + ; f . cr",
    # the quickstart's programs
    ': fib dup 2 < if drop 1 else dup 1 - fib swap 2 - fib + endif ; 10 fib . cr',
    '." sigmoid(1.0)=" 1000 sigmoid . cr ." sin(pi/2)=" 1571 sin . cr',
    "array x { 500 -200 300 } array w { 10 -5 3 2 0 1 } array b { -4 5 } array s { -4 -4 } "
    "array h 2 x w h s vecfold h b h 0 vecadd h h 0 0 vecmap "
    '." activations: " h vecprint cr ." class: " h vecmax . cr',
    "var flag : w 1 flag ! end ; 0 0 $ w task drop 100 1 flag await . flag @ . halt",
    "seven adc 1+ drop : h 7 ; $ h exception user catch begin 1 while repeat begin 0 until",
] + sorted(p.read_text() for p in (ROOT / "examples" / "programs").glob("*.f4"))

BAD_PROGRAMS = ["frobnicate", "1 if 2", "( open", '." open', "{ 1 2", "import nothere",
                "; x", "else", "array a { 1 x }", "const c d", "5 exception nope"]


def _compile_both(progs, lookup="pht"):
    cfg = JCfg(cs_size=4096)
    jf, pf = JFios(), FiosRegistry()
    for name in ("seven", "adc"):
        with pytest.warns(DeprecationWarning):
            jop = jf.add(name, lambda: 0, args=0, ret=1)
        assert pf.add(name, lambda: 0, args=0, ret=1) == jop
    jc, pc = JCompiler(fios=jf, lookup=lookup), Compiler(fios=pf, lookup=lookup)
    jfr, pfr = JFrames(cfg.cs_size), FrameManager(cfg.cs_size)
    jfr.allocate(1)
    pfr.allocate(1)
    jcs, pcs = np.zeros(cfg.cs_size, np.int32), np.zeros(cfg.cs_size, np.int32)
    for prog in progs:
        a = jc.compile_frame(prog, jcs, jfr)
        b = pc.compile_frame(prog, pcs, pfr)
        assert (a.start, a.end, a.entry, a.locked, a.exports) == (
            b.start, b.end, b.entry, b.locked, b.exports)
        assert np.array_equal(jcs, pcs), prog
    return jc, pc


@pytest.mark.parametrize("lookup", ["pht", "lst"])
def test_bytecode_equals_reference(lookup):
    jc, pc = _compile_both(COMPILER_PROGRAMS, lookup)
    assert pc.words_compiled == jc.words_compiled
    assert {k: (v.addr, v.exported) for k, v in pc.dictionary.entries.items()} == {
        k: (v.addr, v.exported) for k, v in jc.dictionary.entries.items()}


@pytest.mark.parametrize("prog", BAD_PROGRAMS)
def test_compile_errors_equal_reference(prog):
    cfg = JCfg(cs_size=1024)
    with pytest.raises(JCompileError) as je:
        jfr = JFrames(cfg.cs_size)
        JCompiler().compile_frame(prog, np.zeros(cfg.cs_size, np.int32), jfr, name="t")
    with pytest.raises(CompileError) as pe:
        pfr = FrameManager(cfg.cs_size)
        Compiler().compile_frame(prog, np.zeros(cfg.cs_size, np.int32), pfr, name="t")
    assert (str(pe.value), pe.value.token, pe.value.pos, pe.value.frame) == (
        str(je.value), je.value.token, je.value.pos, je.value.frame)


def test_tokenize_equals_reference():
    text = '1 ( c ) ." hi there" { 1 -2 0x10 } 12l foo'
    a, b = jtokenize(text), tokenize(text)
    assert [(t.kind, t.text, t.value, t.pos, t.end_pos) for t in a] == [
        (t.kind, t.text, t.value, t.pos, t.end_pos) for t in b]


def test_fios_numbering_reuses_lowest_free_number():
    f = FiosRegistry()
    assert f.add("a", print) == pspec.FIOS_BASE
    assert f.add("b", print) == pspec.FIOS_BASE + 1
    assert f.add("a", len) == pspec.FIOS_BASE           # re-add keeps its number
    assert f.entry_for_opcode(pspec.FIOS_BASE).fn is len


# ---------------------------------------------------------------------------
# Fixed-point LUT words over an int32 sweep
# ---------------------------------------------------------------------------

def _int32_sweep() -> np.ndarray:
    rng = np.random.default_rng(0)
    edges = np.array([-2 ** 31, -2 ** 31 + 1, 2 ** 31 - 1, 2 ** 31 - 2, 0, 1, -1], np.int64)
    parts = [
        edges,
        np.arange(-12000, 12001),
        rng.integers(-2 ** 31, 2 ** 31, size=20000),
        rng.integers(-100000, 100000, size=20000),
        np.arange(0, 2 ** 31 - 1, 104729),
    ]
    return np.concatenate(parts).astype(np.int32)


@pytest.mark.parametrize("name", ["fplog10", "fpsigmoid", "fpsin", "fpsqrt"])
def test_lut_words_exact(name):
    # Each framework gets its own copy: a buffer shared between JAX and
    # torch in one process has been seen to come back corrupted.
    x = _int32_sweep()
    ref = np.array(jax.block_until_ready(getattr(jfx, name + "_jnp")(jnp.array(x))))
    got = getattr(pfx, name + "_t")(torch.tensor(x)).numpy()
    assert got.dtype == np.int32
    bad = np.flatnonzero(ref != got)
    assert bad.size == 0, (x[bad[:5]], ref[bad[:5]], got[bad[:5]])


def test_luts_and_scalar_forms_equal_reference():
    for name in ("LOG10_LUT", "SGLUT13", "SGLUT310"):
        assert np.array_equal(getattr(pfx, name), getattr(jfx, name))
    for v in [0, 5, 999, 1001, 2999, 3000, 9999, 10000, -1, -2500, 123456]:
        for f in ("fpsigmoid", "fpsin", "fpsqrt", "fprelu", "fpsigmoid_interp"):
            assert getattr(pfx, f)(v) == getattr(jfx, f)(v), (f, v)
        assert pfx.fplog10(abs(v) + 10) == jfx.fplog10(abs(v) + 10)


def test_apply_scale_exact():
    rng = np.random.default_rng(1)
    v = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, 4000), [-2 ** 31, 2 ** 31 - 1, 0]]).astype(np.int32)
    s = np.concatenate([rng.integers(-40, 40, 4000), [-2 ** 31, -2 ** 31, 3]]).astype(np.int32)
    ref = np.array(jax.block_until_ready(jfx.apply_scale_jnp(jnp.array(v), jnp.array(s))))
    got = pfx.apply_scale_t(torch.tensor(v), torch.tensor(s)).numpy()
    assert np.array_equal(ref, got)
    assert pfx.apply_scale(-7, -2) == jfx.apply_scale(-7, -2) == -3


# ---------------------------------------------------------------------------
# The import boundary
# ---------------------------------------------------------------------------

def _port_modules() -> list[str]:
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_without_jax():
    """Every module of the port imports with jax blocked (and so with no
    module of the JAX package, which imports jax): the VM, the kernels, and
    the serving path's config, models (dense and rwkv6), serve and launch
    modules."""
    mods = _port_modules()
    for m in ("repro_torch.kernels.fixmatmul.fixmatmul", "repro_torch.kernels.flashattn.ops",
              "repro_torch.models.model", "repro_torch.models.convert", "repro_torch.serve.vmhook",
              "repro_torch.launch.serve", "repro_torch.configs.h2o_danube_1_8b",
              "repro_torch.configs.rwkv6_7b", "repro_torch.models.rwkv6",
              "repro_torch.kernels.rwkv6_scan.rwkv6_scan", "repro_torch.kernels.rwkv6_scan.ops",
              "repro_torch.kernels.lutact.lutact", "repro_torch.kernels.lutact.ops"):
        assert m in mods, m
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'repro' or k.startswith(('repro.', 'jax')) for k in sys.modules"
        " if sys.modules[k] is not None)\n"
        "print('PORT_IMPORT_OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert "PORT_IMPORT_OK" in out.stdout, out.stderr[-3000:]


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
                         + ["chip_smoke.py"])
def test_no_reference_imports(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n != "repro" and not n.startswith("repro.") and n.split(".")[0] != "jax", (path, n)


def test_config_equals_reference():
    import dataclasses
    assert [(f.name, f.default) for f in dataclasses.fields(VMConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(JCfg)]
