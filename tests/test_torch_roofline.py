"""The port's roofline package against the JAX package's on the CPU: the
analytic FLOP / byte / collective model float for float over every arch x
shape x production mesh (and the "dp" preset with int8 gradients), the
roofline terms and MODEL_FLOPS under the reference's TPU ``HW``, the
report's tables string for string on the same records, and the dry-run's
counted FLOPs of one-layer models within the reference's own band of the
analytic count (``tests/test_roofline.py``).  Everything here is exact
except that band."""


import pytest
import torch

from repro.config import SHAPES as JSHAPES
from repro.config import MeshConfig as JMeshConfig
from repro.config import ModelConfig as JModelConfig
from repro.config import get_arch as jget_arch
from repro.roofline import analytic as janalytic
from repro.roofline import report as jreport
from repro.roofline.analysis import HW as JHW
from repro.roofline.analysis import model_flops as jmodel_flops
from repro.roofline.analysis import roofline_terms as jroofline_terms
from repro.roofline.analysis import roofline_terms_from as jroofline_terms_from

from repro_torch.config import SHAPES, MeshConfig, ModelConfig, RunConfig, ShapeConfig, get_arch
from repro_torch.config import list_archs
from repro_torch.launch.dryrun import counted_flops
from repro_torch.roofline import analytic, report
from repro_torch.roofline.analysis import HW, model_flops, roofline_terms, roofline_terms_from

torch.set_num_threads(1)

ARCHS = list_archs()
MESHES = [False, True]


def _pair(arch):
    return jget_arch(arch), get_arch(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_equals_reference(arch):
    """forward_flops, decode_flops, hbm_bytes (bf16 and int8 weights and
    caches) and collective_bytes (tp_sp, tp, dp, int8_ef), for every
    shape and both production meshes: equal float for float."""
    jcfg, cfg = _pair(arch)
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        B, S = shape.global_batch, shape.seq_len
        assert analytic.forward_flops(cfg, B, S) == janalytic.forward_flops(jcfg, B, S)
        assert analytic.decode_flops(cfg, B, S) == janalytic.decode_flops(jcfg, B, S)
        for wb, cb in ((2.0, 2.0), (1.0, 1.0 + 4.0 / cfg.head_dim)):
            assert analytic.hbm_bytes(cfg, shape, weight_bytes=wb, cache_bytes=cb) == \
                janalytic.hbm_bytes(jcfg, jshape, weight_bytes=wb, cache_bytes=cb)
        for mp in MESHES:
            for preset, comp in (("tp_sp", "none"), ("tp", "none"), ("dp", "none"),
                                 ("dp", "int8_ef"), ("tp_sp", "int8_ef")):
                assert analytic.collective_bytes(
                    cfg, shape, MeshConfig(multi_pod=mp), preset=preset, grad_compression=comp
                ) == janalytic.collective_bytes(
                    jcfg, jshape, JMeshConfig(multi_pod=mp), preset=preset, grad_compression=comp)


def test_hw_is_the_h100_datasheet():
    assert (HW().peak_flops, HW().hbm_bw, HW().ici_bw) == (989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_terms_equal_reference_under_tpu_hw(arch):
    """roofline_terms_from, roofline_terms and model_flops with the
    reference's HW() passed in: equal dicts."""
    jcfg, cfg = _pair(arch)
    jhw = JHW()
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        assert model_flops(cfg, shape) == jmodel_flops(jcfg, jshape)
        for mp in MESHES:
            fl = analytic.forward_flops(cfg, shape.global_batch, shape.seq_len)[0]
            hb = analytic.hbm_bytes(cfg, shape)
            co = analytic.collective_bytes(cfg, shape, MeshConfig(multi_pod=mp))
            assert roofline_terms_from(fl, hb, co, cfg, shape, MeshConfig(multi_pod=mp), jhw) == \
                jroofline_terms_from(fl, hb, co, jcfg, jshape, JMeshConfig(multi_pod=mp), jhw)
            cost = {"flops": fl / 256, "bytes": hb / 256}
            coll = {"all-reduce": co, "all-gather": 3.0}
            assert roofline_terms(cost, coll, cfg, shape, MeshConfig(multi_pod=mp), jhw) == \
                jroofline_terms(cost, coll, jcfg, jshape, JMeshConfig(multi_pod=mp), jhw)


def _records():
    """Reference-style records: ok cells of both meshes, a skipped cell and
    a failed one."""
    jhw = JHW()
    out = []
    for i, (arch, shape) in enumerate([("glm4-9b", "train_4k"), ("rwkv6-7b", "decode_32k"),
                                        ("whisper-tiny", "decode_32k"), ("zamba2-1.2b", "train_4k")]):
        jcfg, jshape = jget_arch(arch), JSHAPES[shape]
        for mp in MESHES:
            mc = JMeshConfig(multi_pod=mp)
            fl = janalytic.forward_flops(jcfg, jshape.global_batch, jshape.seq_len)[0]
            hb = janalytic.hbm_bytes(jcfg, jshape)
            co = janalytic.collective_bytes(jcfg, jshape, mc)
            out.append({
                "arch": arch, "shape": shape, "mesh": "2x16x16" if mp else "16x16",
                "kind": jshape.kind, "parallelism": "tp_sp", "status": "ok",
                "compile_s": 12.3 + i,
                "memory": {"argument_size_in_bytes": 3 * 2**30 + i, "temp_size_in_bytes": 2**20 * i},
                "cost": {"flops": fl / mc.num_devices, "bytes": hb / mc.num_devices},
                "collective_bytes": {"all-reduce": co, "all-gather": 1024.0 * i},
                "roofline": jroofline_terms_from(fl, hb, co, jcfg, jshape, mc, jhw),
            })
    out.append({"arch": "granite-34b", "shape": "long_500k", "mesh": "16x16",
                "kind": "decode", "parallelism": "tp_sp", "status": "skipped (full attention)"})
    out.append({"arch": "granite-34b", "shape": "train_4k", "mesh": "2x16x16",
                "status": "FAILED: ValueError: x"})
    return out


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_report_tables_equal_reference(mesh):
    recs = _records()
    assert report.dryrun_table(recs, mesh) == jreport.dryrun_table(recs, mesh)
    assert report.roofline_table(recs, mesh) == jreport.roofline_table(recs, mesh)
    assert [r["arch"] for r in report.pick_hillclimb(recs)] == \
        [r["arch"] for r in jreport.pick_hillclimb(recs)]
    for x in (0, 3e-5, 0.05, 2.5):
        assert report.fmt_s(x) == jreport.fmt_s(x)
    for x in (10, 5000, 3 * 2**20, 7 * 2**30):
        assert report.fmt_b(x) == jreport.fmt_b(x)


def test_report_prints_a_dash_where_a_port_record_has_no_value():
    rec = dict(_records()[0])
    for k in ("compile_s", "collective_bytes"):
        rec.pop(k)
    rec["memory"] = {"argument_size_in_bytes": 2**30, "output_size_in_bytes": 2**30}
    rec["cost"] = {"flops": 1e15, "counted_by": "FlopCounterMode"}
    row = report.dryrun_table([rec], "16x16").splitlines()[-1]
    assert row == "| glm4-9b | train_4k | ok | 1.00 GiB + — | 1.00e+15 (counted) | — | — |"


def _fcheck(family, extra):
    kw = dict(name="fcheck", family=family, num_layers=1, d_model=128, num_heads=4,
              num_kv_heads=2, d_ff=256, vocab_size=512, dtype="float32", remat=False, **extra)
    return ModelConfig(**kw), JModelConfig(**kw)


@pytest.mark.parametrize("family,extra", [
    ("dense", {}),
    ("moe", dict(num_experts=8, num_experts_per_tok=2, moe_d_ff=64, moe_capacity_factor=1.25)),
])
def test_counted_forward_flops_near_analytic(family, extra):
    """The reference's own band (tests/test_roofline.py): the counted FLOPs
    of a one-layer prefill within 0.75-1.35 of the analytic count, which
    here also equals the reference's."""
    cfg, jcfg = _fcheck(family, extra)
    shape = ShapeConfig("t", seq_len=256, global_batch=2, kind="prefill")
    counted, depths, _ = counted_flops(RunConfig(model=cfg, shape=shape))
    stack, head = analytic.forward_flops(cfg, 2, 256)
    assert (stack, head) == janalytic.forward_flops(jcfg, 2, 256)
    assert 0.75 < (stack + head) / counted < 1.35, (stack + head, counted)


def test_counted_decode_flops_near_analytic():
    cfg, jcfg = _fcheck("dense", {})
    shape = ShapeConfig("d", seq_len=512, global_batch=4, kind="decode")
    counted, _, _ = counted_flops(RunConfig(model=cfg, shape=shape))
    ours = analytic.decode_flops(cfg, 4, 512)
    assert ours == janalytic.decode_flops(jcfg, 4, 512)
    assert 0.6 < ours / counted < 1.6, (ours, counted)


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_counted_flops_carry_to_depth_exactly(family):
    """The dry-run counts two (hybrid: three) depths and carries the count
    to the full depth; at a small depth that equals counting it whole."""
    from repro_torch.config import get_smoke
    from repro_torch.launch.dryrun import _count_at

    arch = "h2o-danube-1.8b" if family == "dense" else "zamba2-1.2b"
    cfg = get_smoke(arch).replace(num_layers=5)
    for kind in ("prefill", "train", "decode"):
        run = RunConfig(model=cfg, shape=ShapeConfig("x", seq_len=16, global_batch=2, kind=kind))
        whole, _ = _count_at(run, cfg.num_layers)
        assert counted_flops(run)[0] == whole, kind
