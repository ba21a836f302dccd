"""Hold flood kernel sources of gymgo_tpu_torch against each other on one
card, and count the rounds a flood by rounds needs on the same boards.

    python3 scripts/torch_flood_sources.py --rounds \\
        --bundle gymgo_tpu_torch/csrc/bundle_flood.cu --bundle OTHER/bundle_flood.cu \\
        --minmax gymgo_tpu_torch/csrc/minmax_flood.cu --minmax OTHER/minmax_flood.cu
    python3 scripts/torch_flood_sources.py --size 64 --batch 1024 \\
        --claim gymgo_tpu_torch/csrc/claim_flood.cu --claim OTHER/claim_flood.cu

Each ``--bundle`` / ``--minmax`` / ``--claim`` names a CUDA source with the
package's launcher interface (``bundle_flood_launch`` / ``minmax_flood_launch``
/ ``claim_flood_launch``): the package's own, an older commit's, or a copy of
``csrc/`` with a setting changed.  Every source is built, compared bit for bit
with the plain PyTorch version and timed in the order given and then in
reverse (A B B A), with ``chip_smoke.py``'s timer (200 launches after 50 to
warm up) on the boards ``chip_smoke.py`` times its kernels on: the steady
state of its main path's rollout (768 warm-up steps and 5 windows of 64),
19x19 B = 12288 unless ``--size`` / ``--batch`` say otherwise (boards over
22x22, which the bundle word cannot hold, roll out on the minmax route).
``--rounds`` prints how many synchronous rounds (every cell reads its
neighbours' words of the round before) each board needs to reach the
fixpoint, the last round that changes nothing included: what one board
costs a kernel that iterates to a fixpoint.  Needs a CUDA card; prints its
name and power limit first and last.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from gymgo_tpu_torch.config import HEURISTIC, EnvConfig  # noqa: E402
from gymgo_tpu_torch.core import flood as tflood  # noqa: E402
from gymgo_tpu_torch.core.state import batch_init_state  # noqa: E402
from gymgo_tpu_torch.env.batch_env import rollout  # noqa: E402
from gymgo_tpu_torch.ops.bundle_flood import BUNDLE_FLOOD  # noqa: E402
from gymgo_tpu_torch.ops.claim_flood import CLAIM_FLOOD  # noqa: E402
from gymgo_tpu_torch.ops.cuda_lib import CudaKernelLib  # noqa: E402
from gymgo_tpu_torch.ops.minmax_flood import MINMAX_FLOOD  # noqa: E402

_DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))


def steady_boards(dev, n=19, batch=12288):
    """(mover, opp) planes where ``chip_smoke.py``'s main path ends: 768
    warm-up steps and 5 windows of 64 from empty boards (boards over 22x22
    take the minmax route, ``core.flood.bundle_fits``)."""
    cfg = EnvConfig(board_size=n, batch_size=batch, reward_method=HEURISTIC, auto_reset=True)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    states = rollout(gen, batch_init_state(batch, n, device=dev), 768, cfg).final_states
    _, runs, _ = chip_smoke.timed_windows(rollout, gen, states, cfg, 64, 5)
    return chip_smoke.boards_of(runs[-1].final_states)


def synchronous_rounds(a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.Tensor:
    """Rounds per board, int64 ``(B,)``, of the ``kind`` ("bundle" or
    "minmax") flood iterated synchronously to its fixpoint, counting the
    last round, which changes nothing."""
    shift = tflood.shift
    if kind == "bundle":
        x, gates = tflood.bundle_seed_and_gates(a, b)
        words, fills, join = [x], [0], [torch.bitwise_or]
    else:
        n = a.shape[-1]
        words, fills, join = list(tflood.minmax_seeds(a, b, n)), [n * n, -1], [torch.minimum, torch.maximum]
        gates = [(a & shift(a, dr, dc, False)) | (b & shift(b, dr, dc, False)) for dr, dc in _DIRS]
    rounds = torch.ones(a.shape[0], dtype=torch.int64, device=a.device)
    while True:
        new = []
        for w, fill, op in zip(words, fills, join):
            nw = w
            for (dr, dc), gate in zip(_DIRS, gates):
                nw = op(nw, torch.where(gate, shift(w, dr, dc, fill), fill))
            new.append(nw)
        changed = torch.zeros_like(rounds, dtype=torch.bool)
        for w, nw in zip(words, new):
            changed |= (w != nw).flatten(1).any(1)
        if not bool(changed.any()):
            return rounds
        rounds += changed
        words = new


def quantiles(x: torch.Tensor) -> str:
    s = x.sort().values
    at = lambda q: int(s[min(len(s) - 1, int(q * len(s)))])
    return (f"min {int(s[0])} median {at(0.5)} mean {x.float().mean().item():.2f} "
            f"p90 {at(0.9)} p99 {at(0.99)} max {int(s[-1])}")


class Candidate:
    """One source of a kernel, with its outputs allocated once and its
    launcher's arguments fixed, so that a run costs the host one C call."""

    def __init__(self, package_lib: CudaKernelLib, path: str, a: torch.Tensor, b: torch.Tensor):
        self.path = path
        self.lib = CudaKernelLib(Path(path).resolve(), package_lib.symbol, package_lib.argtypes)
        dtype, count = {BUNDLE_FLOOD: (torch.int32, 1), MINMAX_FLOOD: (torch.int16, 2),
                        CLAIM_FLOOD: (torch.uint8, 1)}[package_lib]
        self.out = tuple(torch.empty(a.shape, dtype=dtype, device=a.device) for _ in range(count))
        self.fn = self.lib.function()
        self.args = (a.data_ptr(), b.data_ptr(), *(o.data_ptr() for o in self.out), a.shape[0],
                     a.shape[-1], torch.cuda.current_stream().cuda_stream)
        self.ms = []

    def run(self):
        err = self.fn(*self.args)
        if err != 0:
            raise RuntimeError(f"{self.path}: CUDA error {err}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bundle", action="append", default=[], metavar="SOURCE")
    ap.add_argument("--minmax", action="append", default=[], metavar="SOURCE")
    ap.add_argument("--claim", action="append", default=[], metavar="SOURCE")
    ap.add_argument("--size", type=int, default=19)
    ap.add_argument("--batch", type=int, default=12288)
    ap.add_argument("--rounds", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    a, b = steady_boards(dev, args.size, args.batch)
    print(f"boards: {args.size}x{args.size} B={a.shape[0]}, steady state, "
          f"mean stones/board {(a | b).sum().item() / a.shape[0]:.1f}", flush=True)

    if args.rounds:
        for kind in ("bundle", "minmax"):
            print(f"synchronous rounds per board, {kind} flood: "
                  f"{quantiles(synchronous_rounds(a, b, kind))}", flush=True)

    for kind, package_lib, paths, plain in (
            ("bundle", BUNDLE_FLOOD, args.bundle, lambda: (tflood.bundle_flood_plain(a, b),)),
            ("minmax", MINMAX_FLOOD, args.minmax, lambda: tflood.minmax_flood_plain(a, b)),
            ("claim", CLAIM_FLOOD, args.claim, lambda: (tflood.claim_flood_plain(a, b),))):
        if not paths:
            continue
        want = plain()
        cands = [Candidate(package_lib, p, a, b) for p in paths]
        for c in cands:
            c.run()
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(c.out, want)):
                raise RuntimeError(f"{c.path} disagrees with the plain {kind} flood")
            ptxas = " | ".join(l.split(":", 1)[-1].strip() for l in c.lib.build_log.splitlines()
                               if "registers" in l or "spill" in l)
            print(f"{kind} {c.path}: equals plain; {ptxas or 'built before this comparison'}", flush=True)
        for c in cands + cands[::-1]:
            c.ms.append(chip_smoke.time_ms(c.run, 200))
        for c in cands:
            print(f"{kind} {c.path}: {c.ms[0]:.4f} ms, again {c.ms[1]:.4f} ms", flush=True)
    print(f"nvidia-smi: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
