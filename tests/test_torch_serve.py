"""The PyTorch port's serve engine and VM measuring job against the JAX
package, on the h2o-danube-1.8b SMOKE config with the JAX weights carried
across, and on qwen2-moe-a2.7b's SMOKE config with the int8 KV cache.  Greedy tokens must be equal (plain and int8-quantized weights);
the engine's quirks (prefill over the right-padded rectangle, ``on_step``
after decode steps only, decode tokens counted per live row) are the
reference's and are kept.  Sampling with a temperature draws from a
``torch.Generator``, which cannot give ``jax.random``'s bits: it is held
to determinism only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JServeConfig
from repro.config import VMConfig as JVMConfig
from repro.config import get_smoke as jget_smoke
from repro.kernels import set_kernels
from repro.models import build_model as jbuild_model
from repro.models.quantized import quantize_params as jquantize_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.vmhook import FleetServeMonitor as JMonitor

from repro_torch.config import ServeConfig, VMConfig, get_smoke
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.quantized import quantize_params
from repro_torch.serve import FleetServeMonitor, ServeEngine

torch.set_num_threads(1)

ARCH = "h2o-danube-1.8b"
MOE_ARCH = "qwen2-moe-a2.7b"
# The VMConfig of tests/test_serve.py and tests/test_vm_fleet.py.
VM_CFG = dict(cs_size=2048, steps_per_slice=64, mbox_size=4)
PROMPTS = [[3, 14, 15, 9, 26, 5, 35, 8, 97, 9, 32], [1, 2, 3, 4], [400, 12, 7, 511, 0, 44, 2]]


@pytest.fixture(autouse=True)
def _interpret_kernels():
    set_kernels("interpret")
    yield
    set_kernels("auto")


@pytest.fixture(scope="module")
def engines():
    jcfg, cfg = jget_smoke(ARCH), get_smoke(ARCH)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.key(0))
    m = build_model(cfg, "cpu")
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return {
        "plain": (JServeEngine(jm, jp, JServeConfig(), max_len=48),
                  ServeEngine(m, p, ServeConfig(), max_len=48)),
        "quantized": (JServeEngine(jm, jquantize_params(jp), JServeConfig(), max_len=48),
                      ServeEngine(m, quantize_params(p), ServeConfig(), max_len=48)),
    }


@pytest.mark.parametrize("weights", ["plain", "quantized"])
def test_greedy_tokens_equal_jax(engines, weights):
    """Unequal prompt lengths: the shorter ones see pad zeros, as in the
    reference; 20 new tokens wrap the window-8 cache several times."""
    jeng, eng = engines[weights]
    ref = jeng.generate(PROMPTS, max_new_tokens=20)
    out = eng.generate(PROMPTS, max_new_tokens=20)
    assert out == ref
    assert [len(o) - len(p) for o, p in zip(out, PROMPTS)] == [20] * 3


@pytest.mark.parametrize("weights", ["plain", "quantized"])
def test_stats_equal_jax(engines, weights):
    jeng, eng = engines[weights]
    jeng.stats.__init__()
    eng.stats.__init__()
    ref = jeng.generate(PROMPTS[:2], max_new_tokens=6, eos_id=7)
    out = eng.generate(PROMPTS[:2], max_new_tokens=6, eos_id=7)
    assert out == ref
    assert (eng.stats.prefill_tokens, eng.stats.decode_tokens, eng.stats.steps) == (
        jeng.stats.prefill_tokens, jeng.stats.decode_tokens, jeng.stats.steps)


def test_greedy_matches_forward_argmax(engines):
    """The first generated token is the argmax of the full forward's logits
    at the prompt's last position (the forward goes through flash
    attention's plain version on the CPU)."""
    _, eng = engines["plain"]
    prompt = PROMPTS[0]
    out = eng.generate([prompt], max_new_tokens=1)
    logits, _ = eng.model.forward(eng.params, {"tokens": torch.tensor([prompt])})
    assert out[0][-1] == int(torch.argmax(logits[0, -1]))


def test_batched_equals_single(engines):
    _, eng = engines["quantized"]
    p1, p2 = [1, 2, 3, 4], [9, 8, 7, 6]
    both = eng.generate([p1, p2], max_new_tokens=4)
    assert both[0] == eng.generate([p1], max_new_tokens=4)[0]
    assert both[1] == eng.generate([p2], max_new_tokens=4)[0]


def test_eos_stops(engines):
    _, eng = engines["plain"]
    prompt = [5, 6, 7, 8]
    ref = eng.generate([prompt], max_new_tokens=8)[0]
    eos = ref[len(prompt)]
    out = eng.generate([prompt], max_new_tokens=8, eos_id=eos)[0]
    assert out == prompt + [eos]


def test_temperature_is_deterministic(engines):
    _, eng = engines["plain"]
    hot = ServeEngine(eng.model, eng.params, ServeConfig(temperature=0.8), max_len=48)
    a = hot.generate(PROMPTS, max_new_tokens=8, generator=torch.Generator().manual_seed(3))
    b = hot.generate(PROMPTS, max_new_tokens=8, generator=torch.Generator().manual_seed(3))
    assert a == b and all(0 <= t < 512 for row in a for t in row)


def test_too_long_raises(engines):
    _, eng = engines["plain"]
    with pytest.raises(ValueError, match="max_len"):
        eng.generate([[1] * 40], max_new_tokens=9)


@pytest.mark.parametrize("executor", ["batched", "cuda"])
def test_monitor_reports_decode_deltas(engines, executor):
    """Two monitor nodes observe the engine through DIOS and report one
    new decode token per step; ``executor="cuda"`` runs the vmloop
    kernel's plain version on the CPU."""
    _, eng = engines["plain"]
    monitor = FleetServeMonitor(n=2, cfg=VMConfig(**VM_CFG), executor=executor, device="cpu")
    engine = ServeEngine(eng.model, eng.params, ServeConfig(), max_len=48, on_step=monitor)
    engine.generate([[1, 2, 3]], max_new_tokens=4)
    assert monitor.steps_seen == 4
    assert monitor.reports() == [[1, 1, 1, 1]] * 2
    stats = monitor.transfer_stats()
    assert stats["executor"] == executor and stats["io_services"] > 0


def test_monitor_matches_jax_monitor(engines):
    """Batch 2: both monitors report two tokens per step, and their
    transfer counters carry the same keys."""
    jeng, eng = engines["plain"]
    jmon = JMonitor(n=2, cfg=JVMConfig(**VM_CFG))
    mon = FleetServeMonitor(n=2, cfg=VMConfig(**VM_CFG), device="cpu")
    JServeEngine(jeng.model, jeng.params, max_len=48, on_step=jmon).generate(
        PROMPTS[:2], max_new_tokens=3)
    ServeEngine(eng.model, eng.params, max_len=48, on_step=mon).generate(
        PROMPTS[:2], max_new_tokens=3)
    assert mon.reports() == jmon.reports() == [[2, 2, 2]] * 2
    jstats, stats = jmon.transfer_stats(), mon.transfer_stats()
    assert sorted(stats) == sorted(jstats)
    assert stats["io_syscalls"] == stats["io_svc_batches"] == 0


def test_monitor_options_not_ported(engines):
    """The monitor's options: ``mesh`` shards its fleet over a node mesh
    and excludes ``device`` (tests/test_torch_sharding.py holds it against
    the meshless monitor).  ``trace_stats()`` is the monitor fleet's, and a
    ``"trace"`` monitor (one program group) reports as the ``"batched"``
    one; ``obs`` and ``metrics()`` are in tests/test_torch_obs.py."""
    from repro_torch.launch.mesh import make_node_mesh

    with pytest.raises(ValueError, match="mesh"):
        FleetServeMonitor(n=1, mesh=make_node_mesh(2, device="cpu"), device="cpu")
    assert FleetServeMonitor(n=2, mesh=make_node_mesh(2, device="cpu")).fleet.node_spec == ("node",)
    mon = FleetServeMonitor(n=1, cfg=VMConfig(**VM_CFG), device="cpu", obs=True)
    assert mon.trace_stats() == mon.fleet.trace_stats()
    assert mon.metrics().as_dict()["counters"]["rounds_observed"] == 0
    _, eng = engines["plain"]
    reports = {}
    for executor in ("trace", "batched"):
        m = FleetServeMonitor(n=2, cfg=VMConfig(**VM_CFG), executor=executor, device="cpu")
        ServeEngine(eng.model, eng.params, max_len=48, on_step=m).generate(
            PROMPTS[:2], max_new_tokens=3)
        reports[executor] = m.reports()
        if executor == "trace":
            stats = m.trace_stats()
            assert stats == m.fleet.trace_stats() and stats["executor"] == "trace"
            assert len(stats["groups"]) >= 1 and stats["spec_steps"] > 0
    assert reports["trace"] == reports["batched"] == [[2, 2, 2]] * 2


def test_cli_serves_smoke(capsys):
    assert serve_cli.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "5",
                           "--new-tokens", "3"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "[serve] 6 new tokens" in out and "on cpu" in out


@pytest.fixture(scope="module")
def moe_engines():
    """qwen2-moe SMOKE (8 experts in 10 slots, 2 shared) on the int8 KV
    cache, as the reference reaches it: through the config."""
    jcfg, cfg = (g(MOE_ARCH).replace(kv_cache_dtype="int8") for g in (jget_smoke, get_smoke))
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.key(4))
    m = build_model(cfg, "cpu")
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return {
        "plain": (JServeEngine(jm, jp, JServeConfig(), max_len=48),
                  ServeEngine(m, p, ServeConfig(), max_len=48)),
        "quantized": (JServeEngine(jm, jquantize_params(jp), JServeConfig(), max_len=48),
                      ServeEngine(m, quantize_params(p), ServeConfig(), max_len=48)),
    }


@pytest.mark.parametrize("weights", ["plain", "quantized"])
def test_moe_int8_kv_greedy_tokens_equal_jax(moe_engines, weights):
    jeng, eng = moe_engines[weights]
    ref = jeng.generate(PROMPTS, max_new_tokens=16)
    out = eng.generate(PROMPTS, max_new_tokens=16)
    assert out == ref
    assert [len(o) - len(p) for o, p in zip(out, PROMPTS)] == [16] * 3


def test_moe_engine_with_monitor(moe_engines):
    """The measuring job observes the moe engine as it does danube's."""
    _, eng = moe_engines["quantized"]
    monitor = FleetServeMonitor(n=2, cfg=VMConfig(**VM_CFG), executor="cuda", device="cpu")
    engine = ServeEngine(eng.model, eng.params, ServeConfig(), max_len=48, on_step=monitor)
    engine.generate(PROMPTS[:2], max_new_tokens=3)
    assert monitor.reports() == [[2, 2, 2]] * 2


def test_cli_serves_moe_smoke(capsys):
    assert serve_cli.main(["--arch", MOE_ARCH, "--smoke", "--batch", "2", "--prompt-len", "4",
                           "--new-tokens", "3"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "[serve] 6 new tokens" in out and "on cpu" in out
