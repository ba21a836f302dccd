"""The readings that the limits of ``limits/<cell>.json`` are set from: a
cell's checks on many seeds of the program as it is, of its control, and of
the planted faults (``faults.py``) that move the numbers the control does
not.  Each seed runs the cell's driver in this one process with a short
window at the cell's own load; the benchmark's runs never do this.

    python3 portbench/controls.py --workload <cell> [--seeds 1,2,3] \\
        [--control-seeds 4,5,6] [--kinds float8] [--seconds 3] [--out controls.json]

The program runs on ``--seeds``; the control (a go19 cell's: the ko rule
dropped; an agz20 cell's: the float8 reference in the program's network's
place) and each fault on ``--control-seeds``, each through the harness's own
comparison.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# per driver: the control and the faults whose readings the limits need, beside the program's own
PLANTED = {
    "env_window": ("ko_off", "first_legal"),
    "batched_search": ("float8", "altered"),
    "gtp_genmove": ("float8", "altered"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--kinds", default="", help="the planted kinds to read (default: all of the cell's)")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import faults, harness

    bench = harness.manifest()
    cell = harness.cell(bench, args.workload)
    driver = cell.traffic["driver"]
    cell.traffic["settle_s"] = 0  # nothing here is timed
    rows = []

    def one(seed, kind):
        t0 = time.perf_counter()
        if kind == "program":
            result, _, readings = harness.run_cell(bench, cell, seed, args.seconds, False, "cuda", t0)
        else:
            with faults.plant(kind, driver):
                result, _, readings = harness.run_cell(bench, cell, seed, args.seconds, False, "cuda", t0)
        row = {"kind": kind, "seed": seed, "correct": result["correct"], "readings": readings,
               "attempted": result["attempted"], "seconds": time.perf_counter() - t0}
        print(json.dumps(row), file=sys.stderr, flush=True)
        rows.append(row)
        from gymgo_tpu_torch.rl import gumbel_mcts

        gumbel_mcts.run_gumbel_mcts.graphs.clear()  # each seed's net captured its own search graph
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    for seed in (int(s) for s in args.seeds.split(",") if s):
        one(seed, "program")
    for kind in (args.kinds.split(",") if args.kinds else PLANTED[driver]):
        for seed in (int(s) for s in args.control_seeds.split(",") if s):
            one(seed, kind)
    summary = {}
    for row in rows:
        for name, value in row["readings"].items():
            key = f"{row['kind']}:{name}"
            lo, hi = summary.get(key, (value, value))
            summary[key] = (min(lo, value), max(hi, value))
    out = {"workload": args.workload, "rows": rows, "min_max": summary,
           "device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"}
    print(json.dumps(out["min_max"], indent=1))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
