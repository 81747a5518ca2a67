"""Run the sharded fleet (``FleetVM(mesh=)``) on every node mesh the
visible cards allow, each run held byte for byte against the meshless
fleet on the first card, and time them in turns.

The meshes: one shard a card (``make_node_mesh()``), two shards a card
(when there are two cards or more), and four shards on the first card
(``make_node_mesh(4, device="cuda")``).  The workloads, at ``--nodes``
nodes of ``VMConfig()``: ``chip_smoke.py``'s ANN ring under
``executor="cuda"``, its trace firmware under ``"trace"`` for two rounds,
and partial IO under ``"cuda"`` (every 64th node calls a FIOS word); then
``chip_smoke.py`` phase 4f's Executive fleet under ``"cuda"`` and the
serve monitor (64 nodes, five ServeStats steps), each once on the mesh
against once meshless.  Each
mesh's runs are timed in turns with the meshless ones (meshless, mesh,
mesh, meshless; host clock, every card synchronized), and each prints the
router's descriptor copies a round, those that crossed cards among them.

    python3 scripts/fleet_mesh.py [--nodes 4096]

Run from the root of a checkout on a machine with CUDA and nvcc.  Prints
each card's name and power limit, one JSON line a (mesh, workload) and a
last summary line.  Any run that differs from the meshless one exits
non-zero.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.config import VMConfig
    from repro_torch.core.vm import REXAVM, FleetVM, vmstate as vms
    from repro_torch.kernels.vmloop import check, vmloop as kmod
    from repro_torch.launch.mesh import NodeMesh, make_node_mesh
    from repro_torch.serve import FleetServeMonitor, ServeStats

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=4096)
    n = ap.parse_args().nodes
    if not torch.cuda.is_available():
        fail("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    kmod.LIBRARY.build()
    kmod.LIBRARY.load()
    cards = torch.cuda.device_count()
    meshes = {f"{cards}x1": make_node_mesh()}
    if cards > 1:
        meshes[f"{cards}x2"] = NodeMesh(tuple(torch.device("cuda", i // 2)
                                              for i in range(2 * cards)))
    meshes["1x4"] = make_node_mesh(4, device="cuda")

    def sync_all():
        for i in range(cards):
            torch.cuda.synchronize(i)

    def drive(ring, mesh, executor, max_rounds=200):
        nodes, init = ring
        for vm, st in zip(nodes, init):
            vm.state = vms.clone(st)
            vm.out_stream.clear()
        where = {"mesh": mesh} if mesh is not None else {"device": torch.device("cuda", 0)}
        fleet = FleetVM(nodes=nodes, executor=executor, **where)
        l0 = kmod.vmloop_call.launches
        sync_all()
        t = time.perf_counter()
        res = fleet.run(max_rounds=max_rounds)
        sync_all()
        dt = time.perf_counter() - t
        return {"fleet": fleet, "res": res, "dt": dt, "launches": kmod.vmloop_call.launches - l0,
                "final": vms.stack_states([vm.state for vm in nodes])}

    cfg = VMConfig()
    dev = torch.device("cuda", 0)

    def fleet_of(program):
        nodes = [REXAVM(cfg, seed=1 + i, device=dev) for i in range(n)]
        for i, vm in enumerate(nodes):
            vm.launch(vm.load(program(i, vm)))
        return nodes, [vms.clone(vm.state) for vm in nodes]

    def io_program(i, vm):
        if i % 64:
            return "0 50 0 do 1+ loop . halt"
        vm.dios_add("ready", 1)
        vm.svc_add("ping", functools.partial(vm.dios_write, "ready", [1]))
        return "ping 1000 1 ready await drop 5 . halt"

    rings = {"ann_ring": fleet_of(lambda i, vm: cs.ann_program(i, n)),
             "firmware": fleet_of(lambda i, vm: cs.TRACE_PROGRAM),
             "partial_io": fleet_of(io_program)}
    work = [("ann_ring", "cuda", 200), ("firmware", "trace", 2), ("partial_io", "cuda", 200)]
    exec_ring = cs.executive_setup(cfg, dev, n)
    summary = {}
    for name, mesh in meshes.items():
        for ring, executor, rounds in work:
            turns = {"meshless": [], "mesh": []}
            for kind in ("meshless", "mesh", "mesh", "meshless"):
                r = drive(rings[ring], mesh if kind == "mesh" else None, executor, rounds)
                turns[kind].append(r)
            base = turns["meshless"][0]
            for r in turns["mesh"] + turns["meshless"][1:]:
                err, bad = check.max_abs_diff(r["final"], base["final"])
                if r["res"].outputs != base["res"].outputs or r["res"].rounds != base["res"].rounds:
                    bad.append("outputs/rounds")
                if r["fleet"].kernel_stats() != base["fleet"].kernel_stats():
                    bad.append("kernel_stats")
                if r["fleet"].transfer_stats() != base["fleet"].transfer_stats():
                    bad.append("transfer_stats")
                if bad:
                    fail(f"{name} {ring} {executor}: differs from meshless on {bad}")
            fm = turns["mesh"][0]["fleet"]
            stats = fm.kernels.route.stats
            steps = int(base["res"].steps.sum())
            line = {
                "mesh": name, "shards": mesh.size, "cards": len(mesh.distinct_devices()),
                "node_spec": list(fm.node_spec), "workload": ring, "executor": executor,
                "nodes": n, "rounds": base["res"].rounds, "steps": steps,
                **{f"{k}_s": [r["dt"] for r in v] for k, v in turns.items()},
                **{f"{k}_steps_per_s": sum(steps / r["dt"] for r in v) / len(v)
                   for k, v in turns.items()},
                "launches": turns["mesh"][0]["launches"],
                "meshless_launches": base["launches"],
                "route_per_round": {k: v / max(stats["rounds"], 1) for k, v in stats.items()
                                    if k != "rounds"},
                "io_d2h_bytes": fm.io_d2h_bytes, "identical_to_meshless": True,
            }
            print(json.dumps(line), flush=True)
            summary[f"{name}/{ring}/{executor}"] = (line["mesh_steps_per_s"]
                                                    / line["meshless_steps_per_s"])
        with tempfile.TemporaryDirectory() as tmp:
            em = cs.executive_run(torch, cfg, dev, exec_ring, "cuda", "vector", tmp, mesh=mesh)
            eb = cs.executive_run(torch, cfg, dev, exec_ring, "cuda", "vector", tmp)
        bad = cs.same_run(check, em, eb)
        if bad or cs.exec_stats(em) != cs.exec_stats(eb) or em["ckpt"] != eb["ckpt"]:
            fail(f"{name} executive: differs from meshless on {bad}")
        mons = [FleetServeMonitor(n=cs.MONITOR_NODES, executor="cuda", mesh=mesh),
                FleetServeMonitor(n=cs.MONITOR_NODES, executor="cuda", device=dev)]
        step_ms = [[], []]
        for step in range(1, cs.MONITOR_STEPS + 1):
            stats = ServeStats(steps=step, prefill_tokens=cs.SERVE_BATCH * cs.PROMPT_LEN,
                               decode_tokens=cs.SERVE_BATCH * step)
            for mon, ms in zip(mons, step_ms):
                sync_all()
                t = time.perf_counter()
                mon(stats)
                sync_all()
                ms.append(1e3 * (time.perf_counter() - t))
        if mons[0].reports() != mons[1].reports():
            fail(f"{name} monitor: reports differ from meshless")
        print(json.dumps({"mesh": name, "shards": mesh.size, "workload": "executive",
                          "rounds": em["res"].rounds, "mesh_s": em["dt"], "meshless_s": eb["dt"],
                          "monitor_step_ms": step_ms[0], "meshless_monitor_step_ms": step_ms[1],
                          "identical_to_meshless": True}), flush=True)
    print(json.dumps({"cards": cards, "torch.cuda.get_device_name": torch.cuda.get_device_name(0),
                      "mesh_over_meshless_steps_per_s": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
