"""Multi-pod dry-run (counterpart of ``repro.launch.dryrun``): every
(architecture x input-shape x mesh) cell counted without a device or a
process group, written to a JSON artifact that ``roofline.report`` reads.

The reference lowers and compiles each cell on 512 forced host devices
and reads XLA's memory and cost analyses.  The port has no compiler to
ask, so each cell is counted:

  * ``memory``: ``argument_size_in_bytes`` and ``output_size_in_bytes``
    per device, exact from the step's specs: parameters, optimizer
    moments, the batch and the cache each at their local shard's size
    (host values such as step counters are not device memory).
  * ``cost.flops``: one step's FLOPs counted by
    ``torch.utils.flop_counter.FlopCounterMode`` over the port's own step
    (the plain versions of the kernels, on fake CPU tensors that hold no
    data), divided over the chips.  Every layer of a stack runs the same
    code at the same shapes, so the step is counted at two depths (three
    for the hybrid family, whose shared block runs every ``attn_every``
    layers) and the count is carried to the full depth exactly
    (``tests/test_torch_roofline.py`` holds it to a count of the whole);
    the record names the depths (``cost.counted_depths``).
  * ``analytic``, ``roofline``: as in the reference, on the H100 ``HW``.

What it cannot count (XLA's temp buffers, the partitioned HLO's
collectives, compile times) it leaves out of the record.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                    # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
        --shape train_4k --multi-pod both --out artifacts/dryrun_torch
"""

from __future__ import annotations

import argparse
import functools
import json
import time
import traceback
from pathlib import Path

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.config import (
    SHAPES,
    MeshConfig,
    RunConfig,
    TrainConfig,
    get_arch,
    list_archs,
    shape_runs_for,
)
from repro_torch.launch.steps import build_for_shape, cell_run, zip_map
from repro_torch.models.model import build_model
from repro_torch.models.quantized import quantize_params
from repro_torch.roofline import analytic
from repro_torch.roofline.analysis import roofline_terms_from
from repro_torch.sharding.api import local_shape
from repro_torch.train.train_step import init_train_state, make_train_step


def local_bytes(shapes, specs, sizes: dict) -> int:
    """Per-device bytes of the tensors of a tree at their local shard's
    size; host values (spec None) and non-tensors count nothing."""
    total = []

    def one(x, spec):
        if spec is not None and isinstance(x, torch.Tensor):
            total.append(int(np.prod(local_shape(tuple(x.shape), spec, sizes), dtype=np.int64))
                         * x.element_size())
        return x

    zip_map(one, shapes, specs)
    return sum(total)


# -- counted FLOPs ---------------------------------------------------------------------

def _count_at(run: RunConfig, depth: int):
    """(FLOPs, output shapes) of one step of ``run`` with ``depth`` layers,
    on fake CPU tensors."""
    cfg = run.model.replace(num_layers=depth)
    if cfg.family == "encdec":
        if (run.model.num_encoder_layers or run.model.num_layers) != run.model.num_layers:
            raise ValueError("counting needs as many encoder layers as decoder layers")
        cfg = cfg.replace(num_encoder_layers=depth)
    shape = run.shape
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = build_model(cfg, "cpu")
        batch = {k: torch.zeros(x.shape, dtype=x.dtype) for k, x in model.input_specs(shape).items()}
        if shape.kind == "train":
            state = init_train_state(model, run.train, 0)
            # The step counters as constants: the schedule reads them on the host.
            zero = lambda: torch.tensor(0, dtype=torch.int32)
            state = state._replace(step=zero(), opt=state.opt._replace(step=zero()))
            step = make_train_step(model, run.train)
            with FlopCounterMode(display=False) as fc:
                _, metrics = step(state, batch)
            out = None
        elif shape.kind == "prefill":
            params = model.init(0)
            with FlopCounterMode(display=False) as fc:
                out, _ = model.forward(params, batch)
        else:
            params = model.init(0)
            if cfg.quantized_serve:
                params = quantize_params(params)
            cache = model.init_cache(shape.global_batch, shape.seq_len)
            with FlopCounterMode(display=False) as fc:
                out, _ = model.decode_step(params, cache, batch["tokens"])
        out = None if out is None else torch.empty(out.shape, dtype=out.dtype, device="meta")
    return float(fc.get_total_flops()), out


def _depths(cfg) -> tuple:
    every = cfg.attn_every or 6
    return (1, every, every + 1) if cfg.family == "hybrid" and every > 1 else (1, 2)


@functools.lru_cache(maxsize=None)
def counted_flops(run: RunConfig):
    """(global FLOPs of one step at the full depth, the depths counted, the
    step's output shape).  Each layer of a stack adds the same count: f(L)
    = base + L * layer, plus (L // every) * shared for the hybrid family,
    whose depths 1, every and every + 1 give the three terms."""
    cfg = run.model
    depths = _depths(cfg)
    counts = {}
    out = None
    for d in depths:
        counts[d], out = _count_at(run, d)
    L = cfg.num_layers
    if len(depths) == 2:
        layer = counts[2] - counts[1]
        return counts[1] + (L - 1) * layer, depths, out
    _, every, after = depths
    layer = counts[after] - counts[every]
    base = counts[1] - layer
    shared = counts[every] - base - every * layer
    return base + L * layer + (L // every) * shared, depths, out


# -- one cell --------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True,
             parallelism: str = "tp_sp", grad_compression: str = "none",
             microbatches: int = 1,
             model_overrides: dict | None = None) -> dict:
    """Count one cell; return the roofline artifact record."""
    model_cfg = get_arch(arch)
    if model_overrides:
        model_cfg = model_cfg.replace(**model_overrides)
    shape = SHAPES[shape_name]
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind,
        "parallelism": parallelism,
    }
    if not shape_runs_for(model_cfg, shape):
        record["status"] = "skipped (full attention)"
        return record

    mesh_cfg = MeshConfig(multi_pod=multi_pod)
    run = RunConfig(
        model=model_cfg, shape=shape, mesh=mesh_cfg,
        train=TrainConfig(grad_compression=grad_compression, microbatches=microbatches),
        parallelism=parallelism,
    )
    t0 = time.time()
    sharded = build_for_shape(run, None)
    sizes = dict(zip(mesh_cfg.axis_names, mesh_cfg.shape))
    args = local_bytes(sharded.arg_specs, sharded.in_specs, sizes)
    # The count does not depend on the mesh once the MoE groups are set.
    flops, depths, out = counted_flops(cell_run(run).replace(mesh=MeshConfig()))
    if shape.kind == "train":
        outputs = local_bytes(sharded.arg_specs[0], sharded.in_specs[0], sizes) + 4 * 5  # + f32 metrics
    elif shape.kind == "prefill":
        outputs = local_bytes(out, sharded.out_specs, sizes)
    else:
        outputs = local_bytes((out, sharded.arg_specs[1]), sharded.out_specs, sizes)
    chips = mesh_cfg.num_devices
    record.update(
        status="ok",
        count_s=round(time.time() - t0, 1),
        memory={"argument_size_in_bytes": args, "output_size_in_bytes": outputs},
        cost={"flops": flops / chips, "counted_by": "FlopCounterMode",
              "counted_depths": list(depths)},
    )
    # Analytic terms (the roofline's source; see roofline/analytic.py).
    if shape.kind == "decode":
        fl = analytic.decode_flops(model_cfg, shape.global_batch, shape.seq_len)
    else:
        stack, head = analytic.forward_flops(model_cfg, shape.global_batch, shape.seq_len)
        # train: fwd + bwd(2x) + remat re-fwd (layer stack only)
        stack_mult = 4 if model_cfg.remat else 3
        fl = stack_mult * stack + 3 * head if shape.kind == "train" else stack + head
    wb = 1.0 if model_cfg.quantized_serve else 2.0
    cb = (1.0 + 4.0 / model_cfg.head_dim) if model_cfg.kv_cache_dtype == "int8" else 2.0
    record["analytic"] = {
        "flops_global": fl,
        "hbm_bytes_global": analytic.hbm_bytes(model_cfg, shape, weight_bytes=wb, cache_bytes=cb),
        "collective_per_chip": analytic.collective_bytes(
            model_cfg, shape, mesh_cfg, preset=parallelism, grad_compression=grad_compression,
        ),
    }
    record["roofline"] = roofline_terms_from(
        fl,
        record["analytic"]["hbm_bytes_global"],
        record["analytic"]["collective_per_chip"],
        model_cfg, shape, mesh_cfg,
    )
    if verbose:
        m = record["memory"]
        print(f"    memory/device: args = {m['argument_size_in_bytes'] / 2**30:.2f} GiB, "
              f"outputs = {m['output_size_in_bytes'] / 2**30:.2f} GiB")
        print(f"    flops/chip (counted) = {record['cost']['flops']:.3e}")
        print(f"    roofline: {record['roofline']}")
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument(
        "--multi-pod", default="both", choices=["single", "multi", "both"],
        help="which production mesh(es) to exercise",
    )
    ap.add_argument("--out", default="artifacts/dryrun_torch", help="artifact dir")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.multi_pod]

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = []
    records = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                print(f"[dryrun] {tag}", flush=True)
                try:
                    rec = run_cell(arch, shape, mp)
                    records.append(rec)
                    print(f"    -> {rec['status']}", flush=True)
                except Exception as e:  # a failure here is a bug in the port
                    traceback.print_exc()
                    failures.append(tag)
                    records.append({
                        "arch": arch, "shape": shape,
                        "mesh": "2x16x16" if mp else "16x16",
                        "status": f"FAILED: {type(e).__name__}: {e}",
                    })
                (outdir / "dryrun.json").write_text(json.dumps(records, indent=1))

    print(f"\n[dryrun] {len(records)} cells, {len(failures)} failures")
    for f in failures:
        print(f"  FAILED: {f}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
