"""Randomized parity soak: the port's batched step against its native engine
(counterpart of the JAX package's ``scripts/fuzz_parity.py``, whose third
engine, the reference numpy oracle, this repository does not carry).

For each board size, ``--games`` random games are stepped in lockstep through
``core.step.step_states`` on ``--device`` and one by one through
``gymgo_tpu_torch.native``.  Each game's action is drawn with numpy from the
native state's valid moves (pass included); a finished game is frozen (it is
handed a pass, which both engines must leave unchanged).  Every game's state
is compared after every step, and the first mismatch raises with the size,
game, step and action.

    python -m gymgo_tpu_torch.scripts.fuzz_parity --games 200 --sizes 5 7 9 [--device cpu]

Prints one JSON line: the states compared, the steps played, the device and
the bundle kernel's launches.  Without ``--device cpu`` it runs on the card
and raises when there is none.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

__all__ = ["fuzz", "main"]


def fuzz(size: int, games: int, max_steps: int, device, seed: int = 0) -> int:
    """Play ``games`` random games of ``size`` for up to ``max_steps`` steps on
    both engines; returns the number of states compared.  Raises
    ``AssertionError`` at the first state that differs, and ``RuntimeError``
    when the native engine refuses a move drawn from its own valid moves."""
    import torch

    from gymgo_tpu_torch import govars
    from gymgo_tpu_torch.core import step as _step
    from gymgo_tpu_torch.core.state import batch_init_state
    from gymgo_tpu_torch.native import NativeGoEngine

    rng = np.random.default_rng([seed, size])
    engine = NativeGoEngine(size)
    native = np.zeros((games, govars.NUM_CHNLS, size, size), np.int8)
    batched = batch_init_state(games, size, device=device)
    pass_action = size * size
    checked = 0
    for t in range(max_steps):
        live = native[:, govars.DONE_CHNL, 0, 0] == 0
        if not live.any():
            break
        actions = np.full(games, pass_action, np.int64)
        for g in np.flatnonzero(live):
            valid = np.flatnonzero(np.append(native[g, govars.INVD_CHNL].ravel() == 0, True))
            actions[g] = rng.choice(valid)
            native[g], status = engine.next_state(native[g], int(actions[g]))
            if status != 0:
                raise RuntimeError(f"native engine refused its own valid move: size={size} game={g} "
                                   f"step={t} action={actions[g]} status={status}")
        batched, _ = _step.step_states(batched, torch.as_tensor(actions, dtype=torch.int32, device=batched.device))
        got = batched.cpu().numpy()
        differ = np.flatnonzero((got != native).reshape(games, -1).any(axis=1))
        if differ.size:
            g = int(differ[0])
            raise AssertionError(f"torch != native: size={size} game={g} step={t} action={actions[g]}")
        checked += games
    return checked


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gymgo_tpu_torch.scripts.fuzz_parity")
    ap.add_argument("--games", type=int, default=100)
    ap.add_argument("--sizes", type=int, nargs="+", default=[5, 7, 9])
    ap.add_argument("--max-steps", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    args = ap.parse_args(argv)

    import torch

    from gymgo_tpu_torch.core.state import resolve_device
    from gymgo_tpu_torch.ops.bundle_flood import BUNDLE_FLOOD

    dev = resolve_device(args.device)
    total = 0
    for size in args.sizes:
        checked = fuzz(size, args.games, args.max_steps, dev, args.seed)
        total += checked
        print(f"size {size}: {args.games} games, {checked:,} states equal", file=sys.stderr, flush=True)
    print(json.dumps({
        "states_checked": total,
        "sizes": args.sizes,
        "games": args.games,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "bundle_launches": BUNDLE_FLOOD.launches,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
