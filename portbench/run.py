"""The benchmark of gymgo_tpu_torch on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json``: set-up (building the port's kernels into
its ``_build`` directory on first use, weights and inputs made on the card
from the seed, every shape of the cell warmed), then the window of
``--seconds``, then, with ``--trace 1``, a short section under the profiler,
then the check of what the timed path produced against the plain reference.
Diagnostics and, last, each number compared beside its limit go to standard
error; the last line of standard output is the result, with the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics (``--trace 1``).

Exits with no result when there is no CUDA card, or fewer than the cell asks
for, or when the process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    bench = harness.manifest()
    cell = harness.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result, checks, _ = harness.run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    foreign = harness.foreign_modules()
    if foreign:
        log(f"the run loaded modules no run may load: {', '.join(foreign)}")
        return 3
    log(f"card as the window closed (name, power limit, SM clock, its max, power, temperature): "
        f"{result['device'].get('state')}; peaks: 989 TFLOP/s bf16, 3.35 TB/s HBM at 700 W")
    log(f"correct {result['correct']}")
    for name, value, limit in checks:
        log(f"check {name} {value!r} limit {limit!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
