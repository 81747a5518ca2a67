"""The hillclimb cells (counterpart of ``repro.launch.hillclimb``): counts
each iteration of the three chosen cells with the dry-run's ``run_cell``
and writes ``artifacts/hillclimb_torch.json``.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb [--cell A|B|C|all]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.dryrun import run_cell

# (tag, arch, shape, kwargs for run_cell)
ITERATIONS = {
    "A": [  # zamba2 train_4k — most collective-bound baseline
        ("A0_baseline_tp_sp", "zamba2-1.2b", "train_4k", {}),
        ("A1_pure_dp", "zamba2-1.2b", "train_4k",
         {"parallelism": "dp"}),
        ("A2_dp_int8_grads", "zamba2-1.2b", "train_4k",
         {"parallelism": "dp", "grad_compression": "int8_ef"}),
        ("A3_dp_int8_noremat", "zamba2-1.2b", "train_4k",
         {"parallelism": "dp", "grad_compression": "int8_ef",
          "model_overrides": {"remat": False}}),
        ("A4_dp_int8_micro4", "zamba2-1.2b", "train_4k",
         {"parallelism": "dp", "grad_compression": "int8_ef",
          "microbatches": 4}),
    ],
    "B": [  # glm4 decode_32k — most representative of the paper's technique
        ("B0_baseline_bf16", "glm4-9b", "decode_32k", {}),
        ("B1_int8_kv_cache", "glm4-9b", "decode_32k",
         {"model_overrides": {"kv_cache_dtype": "int8"}}),
        ("B2_int8_cache_and_weights", "glm4-9b", "decode_32k",
         {"model_overrides": {"kv_cache_dtype": "int8",
                              "quantized_serve": True}}),
    ],
    "C": [  # whisper-tiny decode_32k — worst roofline fraction
        ("C0_baseline_bf16", "whisper-tiny", "decode_32k", {}),
        ("C1_int8_kv_cache", "whisper-tiny", "decode_32k",
         {"model_overrides": {"kv_cache_dtype": "int8"}}),
        ("C2_int8_cache_and_weights", "whisper-tiny", "decode_32k",
         {"model_overrides": {"kv_cache_dtype": "int8",
                              "quantized_serve": True}}),
    ],
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="all", choices=["A", "B", "C", "all"])
    ap.add_argument("--out", default="artifacts/hillclimb_torch.json")
    args = ap.parse_args(argv)
    cells = list(ITERATIONS) if args.cell == "all" else [args.cell]

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    records = json.loads(out.read_text()) if out.exists() else []
    done = {r["tag"] for r in records}
    for cell in cells:
        for tag, arch, shape, kw in ITERATIONS[cell]:
            if tag in done:
                print(f"[hillclimb] {tag} cached")
                continue
            print(f"[hillclimb] {tag}: {arch} x {shape} {kw}", flush=True)
            rec = run_cell(arch, shape, multi_pod=False, **kw)
            rec["tag"] = tag
            records.append(rec)
            out.write_text(json.dumps(records, indent=1))
            print(f"    -> {rec['status']}; roofline {rec.get('roofline', {})}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
