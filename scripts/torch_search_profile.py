"""Where one simulation of gymgo_tpu_torch's Gumbel search goes on one card.

    python3 scripts/torch_search_profile.py [--batch 256] [--sims 32]

Loads the committed 19x19 128x6 net, takes B mid-game states from a 19x19
auto-reset rollout on the card, and measures the eager
``run_gumbel_mcts.fn`` (32 simulations, 16 considered, bfloat16 net; the
compiled search is timed by ``chip_smoke.py`` phase 26) in two variants, in
turns (A B B A) inside one process:

  built       the search as the package runs it eagerly;
  old-flood   the search with the host-synced capture flood put back into every
              expansion: the ``flood_or`` call that ``step_planes`` made before
              it classified the board before the move with the kernel on CUDA
              tensors, run beside the step (so this variant pays that launch
              as well, ~0.01 ms).

For each: wall ms per simulation, host syncs per simulation (PyTorch's sync
debug mode), kernel launches and device-busy time per simulation
(torch.profiler).  Then the parts alone at the same B: the net's forward in
bfloat16 and float32, ``step_states``, the
tree bookkeeping of one simulation (a search with a net and a step that cost
nothing is not possible, so: the search's wall time minus the two), and
``areas`` by the bundle kernel against the host-synced ``flood_or`` it
replaced.  Needs a CUDA card; prints its
name and power limit first and last.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from gymgo_tpu_torch.config import HEURISTIC, EnvConfig  # noqa: E402
from gymgo_tpu_torch.convert import load_aznet_npz  # noqa: E402
from gymgo_tpu_torch.core import flood as tflood  # noqa: E402
from gymgo_tpu_torch.core import score as tscore  # noqa: E402
from gymgo_tpu_torch.core import step as tstep  # noqa: E402
from gymgo_tpu_torch.core.actions import uniform_random_actions  # noqa: E402
from gymgo_tpu_torch.core.state import batch_init_state  # noqa: E402
from gymgo_tpu_torch.env.batch_env import rollout  # noqa: E402
from gymgo_tpu_torch.rl import gumbel_mcts  # noqa: E402

CONSIDERED = 16
# the package's own, kept while a variant stands in its place
STEP_STATES = tstep.step_states


def old_capture_flood_step(states, actions):
    """``step_states`` plus the capture flood it ran before: ``flood_or`` of
    "touches an empty cell" through the opponent's stones after the placement."""
    ps = tstep.planes_from_states(states)
    b, n, _ = ps.black.shape
    idx = actions.to(torch.int64).clamp(0, n * n - 1)
    place = torch.zeros((b, n * n), dtype=torch.bool, device=states.device)
    place.scatter_(1, idx[:, None], (actions != n * n)[:, None])
    wtm = ps.white_to_move[:, None, None]
    mover = torch.where(wtm, ps.white, ps.black) | place.view(b, n, n)
    opp = torch.where(wtm, ps.black, ps.white)
    tflood.flood_or(opp & tflood.neighbor_or(~(mover | opp)), opp)
    return STEP_STATES(states, actions)


def areas_by_flood(states):
    """``score.areas`` by the two-bit ``flood_or`` that CUDA tensors took before
    they read the claims from the bundle word (CPU tensors still take it)."""
    black, white = states[:, 0].bool(), states[:, 1].bool()
    empty = ~(black | white)
    touch = (empty & tflood.neighbor_or(black)).to(torch.uint8)
    touch |= (empty & tflood.neighbor_or(white)).to(torch.uint8) << 1
    touch = tflood.flood_or(touch, empty)
    count = lambda plane: plane.reshape(len(plane), -1).sum(1, dtype=torch.int32)  # noqa: E731
    return count(black | (empty & (touch == 1))), count(white | (empty & (touch == 2)))


class Variant:
    def __init__(self, name, step=STEP_STATES):
        self.name, self.step = name, step
        self.ms = []

    def search(self, roots, net, sims, seed=0):
        """One eager search with this variant's step in place of the
        package's, put back afterwards."""
        gen = torch.Generator(device=roots.device).manual_seed(seed)
        saved = tstep.step_states
        tstep.step_states = self.step
        try:
            return gumbel_mcts.run_gumbel_mcts.fn(gen, roots, net, num_simulations=sims,
                                                  max_considered=CONSIDERED)
        finally:
            tstep.step_states = saved


def wall_ms(fn, reps=1):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--sims", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_search_profile: no CUDA card; nothing run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)

    B, SIMS = args.batch, args.sims
    cfg = EnvConfig(board_size=19, batch_size=B, reward_method=HEURISTIC, auto_reset=True)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    roots = rollout(gen, batch_init_state(B, 19, device=dev), 300, cfg).final_states
    print(f"roots: 19x19 B={B}, mean stones/board {roots[:, :2].to(torch.int32).sum().item() / B:.1f}",
          flush=True)
    net16 = load_aznet_npz(chip_smoke.NET_19, device=dev, dtype=torch.bfloat16)
    net32 = load_aznet_npz(chip_smoke.NET_19, device=dev, dtype=torch.float32)

    variants = [Variant("built"), Variant("old-flood", step=old_capture_flood_step)]
    reference = None
    for v in variants:
        res = v.search(roots, net16, SIMS)  # warm up, and hold the variants to one result
        if reference is None:
            reference = res
        elif not all(torch.equal(p, q) for p, q in zip(res, reference)):
            raise RuntimeError(f"variant {v.name} searched another tree than 'built'")
    for v in variants + variants[::-1]:
        v.ms.append(wall_ms(lambda: v.search(roots, net16, SIMS)) / SIMS)
    for v in variants:
        with chip_smoke.host_syncs() as caught:
            v.search(roots, net16, SIMS)
        syncs = len(caught)
        prof_wall_us, rows = chip_smoke.device_profile(lambda: v.search(roots, net16, SIMS))
        busy = sum(r[0] for r in rows)
        top = "; ".join(f"{k[:44]} {us / SIMS:.1f} us x{c / SIMS:.1f}" for us, c, k in rows[:5])
        print(f"[{v.name}] wall ms/simulation {', '.join(f'{x:.3f}' for x in v.ms)}; "
              f"{syncs / SIMS:.2f} host syncs, {sum(r[1] for r in rows) / SIMS:.1f} kernel launches, "
              f"device busy {busy / SIMS:.1f} us per simulation (profiled wall {prof_wall_us / SIMS:.1f} us); "
              f"top: {top}", flush=True)

    # the parts alone
    x = roots
    with torch.no_grad():
        fwd16 = chip_smoke.time_ms(lambda: net16(x), 20)
        fwd32 = chip_smoke.time_ms(lambda: net32(x), 20)
        fwd16_wall = wall_ms(lambda: net16(x), 20)
    acts = uniform_random_actions(gen, x)
    step_wall = wall_ms(lambda: tstep.step_states(x, acts), 20)
    step_dev = chip_smoke.time_ms(lambda: tstep.step_states(x, acts), 20)
    old_wall = wall_ms(lambda: old_capture_flood_step(x, acts), 20)
    with chip_smoke.host_syncs() as caught:
        old_capture_flood_step(x, acts)
    old_syncs = len(caught)
    with chip_smoke.host_syncs() as caught:
        tstep.step_states(x, acts)
    new_syncs = len(caught)
    built = min(variants[0].ms)
    print(f"[parts] B={B}: net forward bfloat16 {fwd16:.3f} ms device ({fwd16_wall:.3f} ms wall), "
          f"float32 {fwd32:.3f} ms; "
          f"step_states {step_dev:.3f} ms device, {step_wall:.3f} ms wall, {new_syncs} host syncs; with the old "
          f"capture flood {old_wall:.3f} ms wall, {old_syncs} host syncs; tree bookkeeping (search minus net "
          f"minus step, wall) {built - fwd16_wall - step_wall:.3f} ms of {built:.3f} ms/simulation", flush=True)

    areas_ms = wall_ms(lambda: tscore.areas(x), 20)
    with chip_smoke.host_syncs() as caught:
        by_kernel = tscore.areas(x)
    areas_syncs = len(caught)
    plain_ms = wall_ms(lambda: areas_by_flood(x), 20)
    with chip_smoke.host_syncs() as caught:
        by_flood = areas_by_flood(x)
    plain_syncs = len(caught)
    if not all(torch.equal(p, q) for p, q in zip(by_kernel, by_flood)):
        raise RuntimeError("areas by the bundle kernel and by flood_or disagree")
    print(f"[areas] B={B}: from the bundle word {areas_ms:.3f} ms wall, {areas_syncs} host syncs; by the "
          f"host-synced flood_or {plain_ms:.3f} ms wall, {plain_syncs} host syncs; equal", flush=True)
    print(f"nvidia-smi: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
