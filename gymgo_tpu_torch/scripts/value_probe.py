"""Value-head collapse probe: is a checkpoint's value head non-constant and
does it track real outcomes?  (Counterpart of the JAX package's
``scripts/value_probe.py``.)

Under truncation bootstrap, the total value loss stops being a collapse
signal: most rows' targets are the frozen target net's own predictions, which
the online net matches almost for free.  This probe measures what matters
directly: play random games to their ends (``env.batch_env.rollout`` without
auto-reset), evaluate the value head on the final boards, and report (a) the
std of the predictions (collapse => ~0) and (b) the sign agreement between
prediction and the true Trump-Taylor winner.

Usage: python -m gymgo_tpu_torch.scripts.value_probe --ckpt artifacts/az9_r5_iter100_params.npz \\
          --board 9 --channels 64 --blocks 3 [--cpu]

In-distribution mode (``--replay-from TREE.npz``): instead of random-game
terminal boards (out of distribution for a trained net), probe the value head
on the GROUNDED rows of a trainer checkpoint's replay (this port's or a JAX
``train.py`` one): real self-play positions whose stored value target is an
actual +-1 game outcome, in exactly the learner's frame (canonical obs,
mover-perspective value).  ``--ckpt`` may be the same tree or any checkpoint
of the same architecture.  Runs on the CUDA card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gymgo_tpu_torch.scripts.value_probe")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--board", type=int, default=13)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--games", type=int, default=256)
    ap.add_argument("--komi", type=float, default=0.0)
    ap.add_argument("--replay-from", default="",
                    help="trainer checkpoint: probe on its replay's grounded rows (in-distribution) "
                         "instead of random-game terminal boards")
    ap.add_argument("--max-rows", type=int, default=8192,
                    help="--replay-from: cap on probed grounded rows")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)

    from gymgo_tpu_torch.config import EnvConfig
    from gymgo_tpu_torch.convert import load_aznet_checkpoint
    from gymgo_tpu_torch.core import score as _score
    from gymgo_tpu_torch.core import state as _state
    from gymgo_tpu_torch.core.state import batch_init_state, resolve_device
    from gymgo_tpu_torch.env.batch_env import rollout
    from gymgo_tpu_torch.rl.selfplay import net_value_black

    device = resolve_device("cpu" if args.cpu else None)
    n = args.board
    net = load_aznet_checkpoint(args.ckpt, device=device, expect=(n, args.channels, args.blocks))

    if args.replay_from:
        _replay_probe(args, net, device)
        return

    # Random games frozen at their ends (no auto-reset): final boards carry
    # ground-truth outcomes.
    cfg = EnvConfig(board_size=n, batch_size=args.games, komi=args.komi, auto_reset=False)
    steps_full = 3 * n * n
    gen = torch.Generator(device=device).manual_seed(7)
    with torch.no_grad():
        sts = rollout(gen, batch_init_state(args.games, n, device=device), steps_full, cfg).final_states
        done = _state.game_ended(sts)
        truth = _score.winning(sts, args.komi)
        v = net_value_black(sts, net)
    done, truth, v = (x.cpu().numpy() for x in (done, truth, v))
    sel = done & (truth != 0)
    agree = np.mean(np.sign(v[sel]) == truth[sel]) if sel.any() else float("nan")
    print(f"terminal boards: n={int(sel.sum())}  value std={v.std():.4f}  "
          f"mean|v|={np.abs(v).mean():.4f}  sign-agreement with true "
          f"winner={agree:.3f}")
    if v.std() < 1e-3:
        print("VERDICT: COLLAPSED (constant value head)")
    elif agree > 0.75:
        print("VERDICT: healthy (non-constant, tracks outcomes)")
    else:
        print("VERDICT: non-constant but weakly grounded — inspect further")


def _replay_probe(args, net, device):
    """Probe on grounded replay rows, in the learner's exact frame."""
    from gymgo_tpu_torch.train import load_trainer_tree

    buf = load_trainer_tree(args.replay_from)["buf"]
    obs = np.asarray(buf["obs"])
    target = np.asarray(buf["value"])
    capacity = obs.shape[0]
    filled = int(buf["filled"])
    live = np.zeros(capacity, bool)
    live[:filled] = True
    grounded = live & np.asarray(buf["mask"], bool) & np.asarray(buf["vmask"], bool)
    idx = np.flatnonzero(grounded)
    if idx.size == 0:
        print("no grounded rows in the replay window (fresh re-seeded "
              "tree?) — nothing to probe")
        return
    if idx.size > args.max_rows:
        idx = np.random.default_rng(0).choice(idx, args.max_rows,
                                              replace=False)
    preds = []
    with torch.no_grad():
        for s in range(0, idx.size, 1024):
            chunk = torch.from_numpy(obs[idx[s:s + 1024]]).to(device)
            preds.append(net(chunk)[1].float().cpu().numpy())
    v = np.concatenate(preds)
    t = target[idx[:v.size]]
    dec = t != 0  # grounded targets are +-1; 0 = tie (rare)
    agree = (np.mean(np.sign(v[dec]) == np.sign(t[dec]))
             if dec.any() else float("nan"))
    print(f"replay grounded rows: n={idx.size} of {filled} filled  "
          f"value std={v.std():.4f}  mean|v|={np.abs(v).mean():.4f}  "
          f"sign-agreement with stored outcome={agree:.3f}")
    if v.std() < 1e-3:
        print("VERDICT: COLLAPSED (constant value head)")
    elif agree > 0.75:
        print("VERDICT: healthy in-distribution (tracks self-play outcomes)")
    else:
        print("VERDICT: non-constant but weakly grounded in-distribution")


if __name__ == "__main__":
    main()
