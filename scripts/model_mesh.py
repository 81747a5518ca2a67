"""The model-side sharding on the cards: the sharded steps of
``launch.steps`` against one card's unsharded run, with each card's
memory after placement beside the dry-run's count.

    torchrun --nproc_per_node 4 scripts/model_mesh.py [--out FILE]   # the (data 2, model 2) mesh
    python scripts/model_mesh.py                                     # one card: the (1, 1) mesh
    torchrun --nproc_per_node 2 scripts/model_mesh.py --mesh 1x2 --cells diagnosis

Cells (bf16, random weights from a seed, every rank drawing the same):

  * h2o-danube-1.8b whole: prefill at B 2 S 4096, decode of B 8 for 8
    steps against a 4096-token cache, and 2 AdamW train steps at B 4 S 4096;
  * rwkv6-7b at 12 of its 32 layers: prefill at B 2 S 4096 and decode of
    B 8 for 8 steps, its heads on "model";
  * qwen2-moe-a2.7b whole: prefill at B 2 S 4096, its experts on "model"
    and one MoE group a data shard (``steps._with_moe_groups``);
  * then rwkv6's two cells and the MoE prefill (6 of 24 layers) in f32,
    where only the order of the sums differs from one card: within 1e-3
    of the largest |logit| (rwkv6: or phase 7's rule).

Each rank also runs the unsharded port path on its own card and holds the
sharded result to it at the bf16 tolerances of chip_smoke.py's phases
7-10: the logits within 5e-2 of the largest |logit|, the loss within 1e-2
relative and the grad norm within 5e-2.

rwkv6's cells (either dtype) and the bf16 MoE prefill are held layer by
layer instead (``LayerTap``): random weights amplify any reordering of the
sums with depth (in f32 too, on a batch-only mesh too), and a last-bit
difference moves a token to another expert, so their logits after 12 or
24 layers say nothing about a fault.  One card's run keeps every layer's
input and output (and the MoE layers' expert ids); a second sharded run
takes, at each layer, one card's input to that layer (placed as the input
it replaces) and the same expert ids, and each layer's output is held to
one card's: in f32 within F32_TOL of its largest |value|.  In bf16 a
decode step's layers and the MoE prefill's hold every element within
bf16 rounding of the row-parallel sums (BF16_OWN, BF16_ROW): 2^-6 of its
own |value| (one bf16 step, up to 2^-7 of a value, at each of the layer's
two residual adds) plus 2^-6 of the largest |update| (output - input) in
its row (half a step for each partial sum of a row-parallel product, for
their all-reduce, and for the inputs the first add's rounding moves).
rwkv6's prefill layers are held within LOGIT_TOL of their largest
|value|: each scans 4096 positions, and a last-bit difference in a
column-parallel product (the mesh's are half as wide, and may take other
GEMM kernels) moves a decay that the scan compounds along the sequence,
so no per-element rounding bound holds there (on four H100s the worst
element read 1.14 times the bound above, the layer 1.4e-2 of its largest
|value|); the bound's ratio is still reported.  The logits of the plain
sharded run are still reported beside one card's.
A cell's memory is
``torch.cuda.memory_allocated()``'s growth over placing its arguments
(``ShardedFn.place``), beside the dry-run's ``argument_size_in_bytes``
for the same mesh and shapes.

``--cells diagnosis`` runs, on any mesh (``--mesh DxM``, data x model),
what separates a fault in rwkv6's sharded path from the growth of the
sums' reordering through its layers: its f32 prefill (B 2 S 1024) and
decode (B 8, 8 steps) at 1, 2, 4 and 12 layers and its bf16 decode at 12,
each also against one card's run with the rwkv6_scan kernel at the shapes
a rank gets (``split_wkv``: the batch and heads cut as the mesh cuts
them); then, where the mesh shards both axes, decode over caches that
shard their sequence: danube at B 1 (the sequence over "data") and
granite-34b at 4 of its 88 layers at B 8 (one KV head: the sequence
over "model").

Rank 0 prints one JSON line a cell with
the card's name and power limit, and appends them all to ``--out``
(default artifacts/model_mesh.json).  Each rank destroys its group
however the run ends.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.config import MeshConfig, RunConfig, ShapeConfig, TrainConfig, get_arch  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.dryrun import local_bytes  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

SEED = 0
LOGIT_TOL, LOSS_TOL, GNORM_TOL = 5e-2, 1e-2, 5e-2     # chip_smoke.py phases 7 and 9
RWKV_LAYERS = 12
F32_TOL, MOE_F32_LAYERS = 1e-3, 6                       # the f32 twins of the bf16 cells
BF16_OWN, BF16_ROW = 2.0 ** -6, 2.0 ** -6               # the per-layer bf16 rule (LayerTap)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]


def _sync_ms(fn, *args):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t), torch.cuda.max_memory_allocated() / 1e9


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _mean(a, b) -> float:
    return float((a.float() - b.float()).abs().mean())


def _agree(a, b) -> float:
    return float((a.argmax(-1) == b.argmax(-1)).float().mean())


def _reordered(got, ref, alt, split) -> dict:
    """The sharded logits against one card's, beside one card's own
    logits through the plain scan (another order of the same sums) and
    through the kernel at a rank's shapes (``split_wkv``)."""
    return {"mean_abs_logit_diff": _mean(got, ref), "argmax_agreement": _agree(got, ref),
            "reordered_max_rel_logit_diff": _rel(alt, ref),
            "reordered_mean_abs_logit_diff": _mean(alt, ref),
            "reordered_argmax_agreement": _agree(alt, ref),
            "split_kernel_max_rel_logit_diff": _rel(split, ref),
            "split_kernel_mean_abs_logit_diff": _mean(split, ref)}


def split_wkv(data: int, model: int):
    """The rwkv6_scan op on one card at the shapes a (data, model) mesh
    gives a rank: the batch cut in ``data`` pieces (where they divide it
    and it is over 1) and the heads in ``model``, each piece contiguous,
    as a rank's local shard is."""
    from repro_torch.kernels.rwkv6_scan.ops import wkv

    def fn(r, k, v, logw, u, state0, head_size):
        B, _, D = r.shape
        nb = data if B % data == 0 and B > 1 else 1
        b, d = B // nb, D // model
        h = d // head_size
        rows = []
        for i in range(nb):
            cols = []
            for j in range(model):
                def piece(x):
                    return x[i * b:(i + 1) * b, :, j * d:(j + 1) * d].contiguous()

                cols.append(wkv(piece(r), piece(k), piece(v), piece(logw),
                                u[j * d:(j + 1) * d].contiguous(),
                                state0[i * b:(i + 1) * b, j * h:(j + 1) * h].contiguous(),
                                head_size))
            rows.append((torch.cat([o for o, _ in cols], 2), torch.cat([s for _, s in cols], 1)))
        return torch.cat([o for o, _ in rows], 0), torch.cat([s for _, s in rows], 0)

    return fn


class LayerTap:
    """Teacher forcing through the layer function ``owner.<name>`` (its
    third argument the layer's input x, its result's first the output),
    patched for a ``with`` block.  ``record()``: one card's run keeps each
    call's input and output, and, through ``repro_torch.models.moe``'s
    ``router_topk``, each router call's expert ids.  ``force(group)``: a
    sharded run's i-th layer call takes the i-th kept input, placed as the
    input it replaces, and its i-th router call the kept ids of its group
    shards (``group``: the rank's coordinate on "data"); each output is
    kept, gathered, and ``routed_apart`` counts the assignments the run's
    own top-k would have sent elsewhere."""

    def __init__(self, owner, name: str):
        from repro_torch.models import moe

        self.owner, self.name, self.moe = owner, name, moe
        self.layer, self.router_topk = getattr(owner, name), moe.router_topk
        self.inputs, self.ref_outputs, self.ids = [], [], []
        self.outputs, self.routed_apart = [], 0

    @contextlib.contextmanager
    def _patched(self, layer, router_topk):
        setattr(self.owner, self.name, layer)
        self.moe.router_topk = router_topk
        try:
            yield self
        finally:
            setattr(self.owner, self.name, self.layer)
            self.moe.router_topk = self.router_topk

    def record(self):
        def layer(*args, **kw):
            out = self.layer(*args, **kw)
            self.inputs.append(args[2].detach().clone())
            self.ref_outputs.append(out[0].detach().clone())
            return out

        def router_topk(x, w, k):
            out = self.router_topk(x, w, k)
            self.ids.append(out[1])
            return out
        return self._patched(layer, router_topk)

    def force(self, group: int):
        from torch.distributed.tensor import DTensor, distribute_tensor

        inputs, ids, self.outputs, self.routed_apart = iter(self.inputs), iter(self.ids), [], 0

        def layer(*args, **kw):
            x, ref = args[2], next(inputs)
            if isinstance(x, DTensor):
                ref = distribute_tensor(ref, x.device_mesh, x.placements)
            out = self.layer(*args[:2], ref, *args[3:], **kw)
            self.outputs.append(_full(out[0]).detach().clone())
            return out

        def router_topk(x, w, k):
            _, own, probs = self.router_topk(x, w, k)
            n = x.shape[0]
            kept = next(ids)[group * n:(group + 1) * n]
            self.routed_apart += int(k * own.shape[:-1].numel()
                                     - (own[..., :, None] == kept[..., None, :]).any(-1).sum())
            weights = torch.gather(probs, -1, kept)
            return weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9), kept, probs
        return self._patched(layer, router_topk)

    def held(self, rule: str) -> dict:
        """Each layer's forced output against one card's by ``rule`` (see
        the module docstring): "f32" (F32_TOL of its largest |value|),
        "relative" (LOGIT_TOL of it) or "rounding" (each element within
        the bf16 bound); the worst layer's numbers, the bf16 bound's ratio
        reported under every bf16 rule."""
        worst_rel, worst_share, ok = 0.0, 0.0, True
        tol = {"f32": F32_TOL, "relative": LOGIT_TOL}.get(rule)
        for x, ref, got in zip(self.inputs, self.ref_outputs, self.outputs):
            ref, got, x = ref.float(), got.float(), x.float()
            diff = (got - ref).abs()
            worst_rel = max(worst_rel, float(diff.max() / ref.abs().max()))
            if rule != "f32":
                bound = BF16_OWN * ref.abs() + BF16_ROW * (ref - x).abs().amax(-1, keepdim=True)
                worst_share = max(worst_share, float((diff / bound).max()))
                if rule == "rounding":
                    ok &= bool((diff <= bound).all())
            if tol is not None:
                ok &= bool(diff.max() <= tol * ref.abs().max())
        return {"ok": ok and len(self.outputs) == len(self.ref_outputs) > 0, "rule": rule,
                "layer_calls": len(self.outputs), "per_layer_max_rel_diff": worst_rel,
                **({} if rule == "f32" else {"per_layer_max_diff_over_bound": worst_share}),
                "routed_apart": self.routed_apart}


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


class Cell:
    def __init__(self, mesh, mesh_cfg, rank):
        self.mesh, self.mesh_cfg, self.rank = mesh, mesh_cfg, rank
        self.dev = torch.device("cuda", torch.cuda.current_device())
        self.lines = []
        self.failed = []
        names = mesh.mesh_dim_names
        self.group = mesh.get_coordinate()[names.index("data")] if "data" in names else 0

    @staticmethod
    def tap(cfg):
        """The cell's ``LayerTap``, or None where the logits are held."""
        if cfg.family == "rwkv6":
            from repro_torch.models.model import RWKV6Model

            return LayerTap(RWKV6Model, "_layer")
        if cfg.family == "moe" and cfg.dtype == "bfloat16":
            from repro_torch.models import transformer

            return LayerTap(transformer, "decoder_layer_full")
        return None

    def hold_layers(self, tap, cfg, rule: str) -> dict:
        held = tap.held("f32" if cfg.dtype == "float32" else rule)
        self.fail_unless(held.pop("ok"), f"{cfg.name} {cfg.dtype}: a layer's output strays from "
                                         f"one card's: {held}")
        return held

    def placed(self, sf, *args):
        """The arguments placed, and the bytes the placing allocated beside
        the dry-run's count for the same cell."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        out = sf.place(*args)
        torch.cuda.synchronize()
        sizes = dict(zip(self.mesh_cfg.axis_names, self.mesh_cfg.shape))
        counted = local_bytes(sf.arg_specs[:len(args)], sf.in_specs[:len(args)], sizes)
        return out, {"allocated_bytes": torch.cuda.memory_allocated() - before,
                     "dryrun_argument_bytes": counted}

    def tokens(self, cfg, B, S, salt):
        g = torch.Generator(device=self.dev).manual_seed(SEED + salt)
        return torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=self.dev,
                             dtype=torch.int32)

    def report(self, line):
        line = {"mesh": list(self.mesh_cfg.shape), "world": dist.get_world_size(), **line,
                "card": card_line()}
        if self.rank == 0:
            print(json.dumps(line), flush=True)
        self.lines.append(line)

    def fail_unless(self, ok, what):
        """Record a check; a failed one is reported and the run goes on
        to the next cell (every rank computes the same values)."""
        if not ok:
            self.failed.append(what)
            if self.rank == 0:
                print(f"model_mesh: FAILED {what}", flush=True)

    # -- cells ---------------------------------------------------------------------------

    def prefill(self, cfg, B, S, salt, tol=LOGIT_TOL):
        run = RunConfig(model=cfg, mesh=self.mesh_cfg, shape=ShapeConfig("prefill", S, B, "prefill"))
        sf = steps.build_prefill(run, self.mesh)
        (params,) = sf.init(SEED)
        batch = {"tokens": self.tokens(cfg, B, S, salt)}
        (placed, _), mem = self.placed(sf, params, batch)
        _, first_ms, _ = _sync_ms(sf.fn, placed, batch)       # DTensor's first call propagates
        logits, ms, peak = _sync_ms(sf.fn, placed, batch)
        logits = _full(logits)
        del placed
        model = build_model(steps.cell_run(run).model, self.dev)
        tap = self.tap(cfg)
        with tap.record() if tap else contextlib.nullcontext():
            (ref, _), ref_ms, _ = _sync_ms(model.forward, params, batch)
        rel, extra = _rel(logits, ref), {}
        if cfg.family == "rwkv6":
            # beside it, one card's logits through the plain scan (another
            # order of the same sums) and the kernel at a rank's shapes
            from repro_torch.models.rwkv6 import chunked_wkv

            alt, _ = model.forward(params, batch, wkv=chunked_wkv)
            split, _ = model.forward(params, batch, wkv=split_wkv(*self.mesh_cfg.shape))
            extra = _reordered(logits, ref, alt, split)
        if tap:
            placed, _ = sf.place(params, batch)
            with tap.force(self.group):
                sf.fn(placed, batch)
            del placed
            # rwkv6's layers scan the whole sequence: see the module docstring
            extra |= self.hold_layers(tap, cfg, "relative" if cfg.family == "rwkv6" else "rounding")
        else:
            self.fail_unless(rel <= tol, f"{cfg.name} {cfg.dtype} prefill: logits {rel} from one card's")
        self.report({"cell": "prefill", "arch": cfg.name, "dtype": cfg.dtype,
                     "layers": cfg.num_layers, "batch": B,
                     "seq": S, "first_ms": first_ms, "ms": ms, "unsharded_ms": ref_ms,
                     "tokens_per_s": B * S / ms * 1e3,
                     "peak_gb": peak, "max_rel_logit_diff": rel, **extra, **mem})

    def decode(self, cfg, B, cache_len, n_steps, salt, tol=LOGIT_TOL):
        run = RunConfig(model=cfg, mesh=self.mesh_cfg, shape=ShapeConfig("decode", cache_len, B,
                                                                         "decode"))
        sf = steps.build_decode(run, self.mesh)
        params, cache = sf.init(SEED)
        tokens = self.tokens(cfg, B, n_steps, salt)
        (placed, shard_cache, _), mem = self.placed(sf, params, cache, tokens[:, :1])
        model = build_model(steps.cell_run(run).model, self.dev)
        rwkv, tap = cfg.family == "rwkv6", self.tap(cfg)
        if rwkv:          # one card's steps again through the plain scan: the reordering
            from repro_torch.models.rwkv6 import chunked_wkv

            alt_cache = build_model(cfg, self.dev).init_cache(B, cache_len)
            split_cache = build_model(cfg, self.dev).init_cache(B, cache_len)
            split = split_wkv(*self.mesh_cfg.shape)
        ms, ref_ms, rels, peak, got, refs, alts, splits = [], [], [], 0.0, [], [], [], []
        for i in range(n_steps):
            tok = tokens[:, i:i + 1]
            (logits, shard_cache), t, p = _sync_ms(sf.fn, placed, shard_cache, tok)
            with tap.record() if tap else contextlib.nullcontext():
                (ref, cache), t_ref, _ = _sync_ms(model.decode_step, params, cache, tok)
            got.append(_full(logits))
            refs.append(ref)
            rels.append(_rel(got[-1], ref))
            if rwkv:
                alts.append(model.decode_step(params, alt_cache, tok, wkv=chunked_wkv)[0])
                splits.append(model.decode_step(params, split_cache, tok, wkv=split)[0])
            ms.append(t)
            ref_ms.append(t_ref)
            peak = max(peak, p)
        extra = {}
        if rwkv:
            extra = _reordered(*(torch.stack(x) for x in (got, refs, alts, splits)))
        elif hasattr(shard_cache, "k"):
            extra = {"cache_placements": str(tuple(shard_cache.k.placements))}
        if tap:       # the same steps again from a zero cache, each layer forced
            del shard_cache
            fresh = build_model(cfg, self.dev).init_cache(B, cache_len)
            placed, forced_cache, _ = sf.place(placed, fresh, tokens[:, :1])
            with tap.force(self.group):
                for i in range(n_steps):
                    _, forced_cache = sf.fn(placed, forced_cache, tokens[:, i:i + 1])
            extra |= self.hold_layers(tap, cfg, "rounding")
        else:
            self.fail_unless(max(rels) <= tol,
                             f"{cfg.name} {cfg.dtype} decode: logits {max(rels)} from one card's, "
                             f"{extra}")
        self.report({"cell": "decode", "arch": cfg.name, "dtype": cfg.dtype,
                     "layers": cfg.num_layers, "batch": B,
                     "cache": cache_len, "steps": n_steps, "step_ms": ms, "unsharded_step_ms": ref_ms,
                     "tokens_per_s_after_first": B * (n_steps - 1) / sum(ms[1:]) * 1e3,
                     "peak_gb": peak, "max_rel_logit_diff": max(rels), **extra, **mem})

    def train(self, cfg, B, S, n_steps, salt):
        tcfg = TrainConfig(total_steps=n_steps, warmup_steps=1)
        run = RunConfig(model=cfg, mesh=self.mesh_cfg, train=tcfg,
                        shape=ShapeConfig("train", S, B, "train"))
        sf = steps.build_train_step(run, self.mesh)
        (state,) = sf.init(SEED)
        toks = self.tokens(cfg, B, S + 1, salt)
        batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
        (shard_state, _), mem = self.placed(sf, state, batch)
        ms, peak, metrics = [], 0.0, []
        for _ in range(n_steps):
            (shard_state, m), t, p = _sync_ms(sf.fn, shard_state, batch)
            ms.append(t)
            peak = max(peak, p)
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        del shard_state
        torch.cuda.empty_cache()
        step = make_train_step(build_model(steps.cell_run(run).model, self.dev), tcfg)
        ref = []
        ref_ms = []
        for _ in range(n_steps):
            (state, m), t, _ = _sync_ms(step, state, batch)
            ref.append({k: float(m[k]) for k in ("loss", "grad_norm")})
            ref_ms.append(t)
        for a, b in zip(metrics, ref):
            self.fail_unless(abs(a["loss"] - b["loss"]) <= LOSS_TOL * abs(b["loss"]),
                             f"{cfg.name} train: loss {a['loss']} vs {b['loss']}")
            self.fail_unless(abs(a["grad_norm"] - b["grad_norm"]) <= GNORM_TOL * b["grad_norm"],
                             f"{cfg.name} train: grad_norm {a['grad_norm']} vs {b['grad_norm']}")
        self.report({"cell": "train", "arch": cfg.name, "layers": cfg.num_layers, "batch": B,
                     "seq": S, "steps": n_steps, "step_ms": ms, "unsharded_step_ms": ref_ms,
                     "tokens_per_s_after_first": B * S * (n_steps - 1) / sum(ms[1:]) * 1e3,
                     "peak_gb": peak, "metrics": metrics, "unsharded_metrics": ref, **mem})


def _init_group():
    """torchrun's environment, or a world of one on this process."""
    if "RANK" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        dist.init_process_group("nccl", rank=rank, world_size=world,
                                timeout=datetime.timedelta(minutes=5))
        return rank, world
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
                            timeout=datetime.timedelta(minutes=5))
    return 0, 1


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("artifacts", "model_mesh.json"),
                    help="JSON lines of every cell (appended)")
    ap.add_argument("--mesh", default=None,
                    help="data x model, e.g. 1x2 (default: 1x1 on one rank, 2x2 on four)")
    ap.add_argument("--cells", choices=("main", "diagnosis"), default="main")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("model_mesh: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False       # f32 products in f32
    rank, world = _init_group()
    cell = None
    try:
        if args.mesh:
            shape = tuple(int(n) for n in args.mesh.split("x"))
        else:
            shape = {1: (1, 1), 4: (2, 2)}.get(world)
        if shape is None or shape[0] * shape[1] != world:
            raise SystemExit(f"model_mesh: mesh {args.mesh} on a world of {world} ranks")
        mesh_cfg = MeshConfig(data=shape[0], model=shape[1])
        cell = Cell(make_mesh(mesh_cfg), mesh_cfg, rank)
        danube, rwkv = get_arch("h2o-danube-1.8b"), get_arch("rwkv6-7b")
        rwkv = rwkv.replace(num_layers=RWKV_LAYERS)
        t = time.perf_counter()
        if args.cells == "diagnosis":
            diagnosis(cell, danube, rwkv)
        else:
            main_cells(cell, danube, rwkv)
        if rank == 0:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                for line in cell.lines:
                    f.write(json.dumps(line) + "\n")
            print(json.dumps({"model_mesh": "failed" if cell.failed else "ok", "world": world,
                              "cells": args.cells, "failed": cell.failed,
                              "seconds": time.perf_counter() - t}), flush=True)
    finally:
        dist.destroy_process_group()
    return 1 if cell is None or cell.failed else 0


def main_cells(cell, danube, rwkv):
    """The cells of the module docstring's list."""
    cell.prefill(danube, 2, 4096, 1)
    cell.decode(danube, 8, 4096, 8, 2)
    cell.train(danube, 4, 4096, 2, 3)
    torch.cuda.empty_cache()
    cell.prefill(rwkv, 2, 4096, 4)
    cell.decode(rwkv, 8, 4096, 8, 5)
    torch.cuda.empty_cache()
    moe = get_arch("qwen2-moe-a2.7b")
    cell.prefill(moe, 2, 4096, 6)
    torch.cuda.empty_cache()
    # The same cells in f32 (the MoE at 6 of its 24 layers): the sums'
    # order is all that differs from one card, so they agree to F32_TOL.
    f32 = dict(dtype="float32")
    cell.prefill(rwkv.replace(**f32), 2, 4096, 4, tol=F32_TOL)
    cell.decode(rwkv.replace(**f32), 8, 4096, 8, 5, tol=F32_TOL)
    torch.cuda.empty_cache()
    cell.prefill(moe.replace(num_layers=MOE_F32_LAYERS, **f32), 2, 4096, 6, tol=F32_TOL)


def diagnosis(cell, danube, rwkv):
    """rwkv6 in f32 by depth and in bf16, each beside the kernel at a
    rank's shapes; then decode over sequence-sharded caches.  The cells
    that tell most come first (rank 0 prints each as it ends)."""
    def f32(layers):
        cfg = rwkv.replace(num_layers=layers, dtype="float32")
        cell.prefill(cfg, 2, 1024, 4, tol=F32_TOL)
        cell.decode(cfg, 8, 4096, 8, 5, tol=F32_TOL)
        torch.cuda.empty_cache()

    f32(1)
    f32(RWKV_LAYERS)
    cell.decode(rwkv, 8, 4096, 8, 5)
    torch.cuda.empty_cache()
    if min(cell.mesh_cfg.shape) > 1:
        cell.decode(danube, 1, 4096, 8, 7)
        torch.cuda.empty_cache()
        cell.decode(get_arch("granite-34b").replace(num_layers=4), 8, 4096, 8, 8)
        torch.cuda.empty_cache()
    f32(2)
    f32(4)


if __name__ == "__main__":
    raise SystemExit(main())
