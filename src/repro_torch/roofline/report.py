"""Render the dry-run and roofline markdown tables from the dry-run
artifact (counterpart of ``repro.roofline.report``; on the reference's
records it prints the reference's tables).

    PYTHONPATH=src python -m repro_torch.roofline.report artifacts/dryrun_torch/dryrun.json

A port record has no XLA temp size, HLO collectives or compile time: those
cells print ``—``; its FLOPs are counted by ``FlopCounterMode`` and marked
``(counted)``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

NONE = "—"


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-4:
        return f"{x*1e6:.1f}us"
    if x < 0.1:
        return f"{x*1e3:.2f}ms"
    return f"{x:.3f}s"


def fmt_b(x: float) -> str:
    for unit, div in [("GiB", 2**30), ("MiB", 2**20), ("KiB", 2**10)]:
        if x >= div:
            return f"{x/div:.2f} {unit}"
    return f"{x:.0f} B"


def _mem_cell(m: dict) -> str:
    args = m.get("argument_size_in_bytes", 0)
    if "temp_size_in_bytes" not in m:
        return f"{fmt_b(args)} + {NONE}"
    return fmt_b(args + m["temp_size_in_bytes"])


def _flops_cell(cost: dict) -> str:
    cell = f"{cost.get('flops', 0):.2e}"
    return f"{cell} (counted)" if cost.get("counted_by") else cell


def dryrun_table(records: list[dict], mesh: str) -> str:
    lines = [
        "| arch | shape | status | mem/chip (args+temp) | HLO flops/chip | coll bytes/chip | compile |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in records:
        if r["mesh"] != mesh:
            continue
        if r["status"] != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['status']} | {NONE} | {NONE} | {NONE} | {NONE} |"
            )
            continue
        coll = r.get("collective_bytes")
        coll = fmt_b(sum(coll.values())) if coll is not None else NONE
        comp = f"{r['compile_s']:.0f}s" if "compile_s" in r else NONE
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | {_mem_cell(r['memory'])} | "
            f"{_flops_cell(r['cost'])} | {coll} | {comp} |"
        )
    return "\n".join(lines)


def roofline_table(records: list[dict], mesh: str) -> str:
    lines = [
        "| arch | shape | compute | memory | collective | bottleneck | "
        "MODEL_FLOPS | useful ratio | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in records:
        if r["mesh"] != mesh:
            continue
        if r["status"] != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {NONE} | {NONE} | {NONE} | {r['status']} "
                f"| {NONE} | {NONE} | {NONE} |"
            )
            continue
        rf = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rf['compute_s'])} | "
            f"{fmt_s(rf['memory_s'])} | {fmt_s(rf['collective_s'])} | "
            f"**{rf['bottleneck'].replace('_s','')}** | "
            f"{rf['model_flops']:.2e} | {rf['useful_flops_ratio']:.3f} | "
            f"{rf['roofline_fraction']:.4f} |"
        )
    return "\n".join(lines)


def pick_hillclimb(records: list[dict]) -> list[dict]:
    """worst roofline fraction / most collective-bound."""
    ok = [r for r in records if r["status"] == "ok" and r["mesh"] == "16x16"]
    worst = min(ok, key=lambda r: r["roofline"]["roofline_fraction"])
    coll = max(ok, key=lambda r: r["roofline"]["collective_s"]
               / max(sum(r["roofline"][k] for k in ("compute_s", "memory_s", "collective_s")), 1e-30))
    return [worst, coll]


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    path = Path(args[0]) if args else Path("artifacts/dryrun_torch/dryrun.json")
    records = json.loads(path.read_text())
    for mesh in ("16x16", "2x16x16"):
        print(f"\n### Dry-run — {mesh}\n")
        print(dryrun_table(records, mesh))
    print("\n### Roofline — 16x16 (single pod)\n")
    print(roofline_table(records, "16x16"))
    w, c = pick_hillclimb(records)
    print(f"\nworst roofline fraction: {w['arch']} x {w['shape']} "
          f"({w['roofline']['roofline_fraction']})")
    print(f"most collective-bound:   {c['arch']} x {c['shape']} "
          f"(coll {fmt_s(c['roofline']['collective_s'])})")


if __name__ == "__main__":
    main()
