"""Auditor CLI: verify/lint REXAVM programs from the command line
(counterpart of ``repro.analysis.cli``, with the same report).

Usage::

    python -m repro_torch.analysis verify examples/programs/*.f4
    python -m repro_torch.analysis verify --json report.json src.f4
    python -m repro_torch.analysis lint  examples/programs   # recurse dirs

Each source file is compiled on a scratch node (on the host: no GPU is
needed) and verified from its launch entry.  Exit status is non-zero iff any file has *errors*
(``FLAGGED`` programs lint-warn but pass — they run with checks on).
``--strict`` also fails flagged programs.  ``--json`` writes the full
machine-readable report (the CI artifact).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.feasibility import bail_words
from repro_torch.analysis.verifier import ERROR, FLAGGED, analyze_source


def _iter_sources(paths):
    for p in paths:
        p = Path(p)
        if p.is_dir():
            yield from sorted(p.rglob("*.f4"))
        else:
            yield p


def _report_one(path: Path) -> dict:
    text = path.read_text()
    try:
        rep = analyze_source(text)
    except Exception as e:  # CompileError etc. — a verify failure, not a crash
        return {
            "file": str(path),
            "verdict": ERROR,
            "diagnostics": [f"error: {type(e).__name__}: {e}"],
            "wcet": None,
            "bail_words": [],
            "entries": [],
        }
    return {
        "file": str(path),
        "verdict": rep.verdict,
        "diagnostics": [str(d) for d in rep.diagnostics],
        "wcet": rep.wcet,
        "bail_words": sorted(bail_words(rep)),
        "entries": [
            {
                "pc": e.pc,
                "function": e.function,
                "verdict": e.verdict,
                "wcet": e.wcet,
                "max_ds": e.max_ds,
                "max_fs": e.max_fs,
                "rs_need": e.rs_need,
            }
            for e in rep.entries
        ],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.analysis", description=__doc__)
    ap.add_argument("command", choices=["verify", "lint"],
                    help="verify = gate on errors; lint = report only")
    ap.add_argument("paths", nargs="+", help=".f4 files or directories")
    ap.add_argument("--strict", action="store_true",
                    help="fail FLAGGED programs too, not just ERROR")
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="write the machine-readable report here")
    args = ap.parse_args(argv)

    reports = [_report_one(p) for p in _iter_sources(args.paths)]
    failed = 0
    for r in reports:
        marker = {"verified": "ok  ", "flagged": "warn", "error": "FAIL"}[
            r["verdict"]
        ]
        wcet = "unbounded" if r["wcet"] is None else str(r["wcet"])
        print(f"[{marker}] {r['file']}: {r['verdict']} "
              f"(wcet {wcet} instrs, bails {r['bail_words'] or '[]'})")
        for d in r["diagnostics"]:
            print(f"       {d}")
        if r["verdict"] == ERROR or (args.strict and r["verdict"] == FLAGGED):
            failed += 1
    if args.json:
        Path(args.json).write_text(json.dumps(
            {"reports": reports, "failed": failed}, indent=2))
    print(f"{len(reports)} program(s), {failed} failed")
    if args.command == "lint":
        return 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
