"""Interactive demo: human against an AI (counterpart of the JAX package's
``demo.py``).

    python -m gymgo_tpu_torch.demo [--boardsize 7] [--komi 0] [--render terminal|human]
        [--ai random|net --checkpoint ck.npz --channels 64 --blocks 3] [--sgf game.sgf] [--cpu]

``--render human`` opens the pyglet window (``GoEnv.render("human")``);
``terminal`` plays in the console (moves as ``row,col``, ``p`` to pass, ``e``
or end of input to exit).  The board steps on ``GoEnv``'s default backend (the
native engine where it builds).  ``--ai net`` plays the one-ply Gumbel
lookahead (16 sampled moves) under the pass-to-win rule, on the CUDA card
unless ``--cpu`` is given, from a checkpoint or, without one, a net drawn at
random.  ``--sgf`` saves the game record.
"""

from __future__ import annotations

import argparse

import numpy as np

__all__ = ["build_parser", "make_net_ai", "terminal_action", "main"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m gymgo_tpu_torch.demo", description="Demo Go Environment")
    parser.add_argument("--boardsize", type=int, default=7)
    parser.add_argument("--komi", type=float, default=0)
    parser.add_argument("--render", choices=["human", "terminal"], default="terminal")
    parser.add_argument("--ai", choices=["random", "net"], default="random")
    parser.add_argument("--checkpoint", default="", help="npz checkpoint for --ai net")
    parser.add_argument("--channels", type=int, default=64)
    parser.add_argument("--blocks", type=int, default=3)
    parser.add_argument("--sgf", default="", help="save the game record here")
    parser.add_argument("--cpu", action="store_true", help="run the net on the CPU instead of the CUDA card")
    return parser


def make_net_ai(args):
    """``pick(env) -> action``: the one-ply Gumbel lookahead with the
    pass-to-win rule, from ``args.checkpoint`` or a random net."""
    import torch

    from gymgo_tpu_torch.convert import load_aznet_checkpoint
    from gymgo_tpu_torch.core.state import resolve_device
    from gymgo_tpu_torch.models.az_net import AZNetConfig, acting_copy, init_params
    from gymgo_tpu_torch.rl import gumbel_oneply, with_pass_to_win

    device = resolve_device("cpu" if args.cpu else None)
    if args.checkpoint:
        net = load_aznet_checkpoint(args.checkpoint, device=device,
                                    expect=(args.boardsize, args.channels, args.blocks))
    else:
        cfg = AZNetConfig(board_size=args.boardsize, channels=args.channels, blocks=args.blocks)
        net = acting_copy(init_params(torch.Generator(device=device).manual_seed(0), cfg))
    generator = torch.Generator(device=device).manual_seed(int(np.random.randint(1 << 30)))

    # pass_min_stones pushes the inner search off non-winning passes, so
    # when the wrapper vetoes a pass the replacement is the search's own
    # best board move rather than a uniform-random fallback
    policy = with_pass_to_win(
        lambda g, states: gumbel_oneply(
            g, states, net, num_sampled=16, komi=args.komi, pass_min_stones=1 << 20,
        ).actions,
        komi=args.komi,
    )

    def pick(env):
        states = torch.from_numpy(env.state().astype(np.int8)[None]).to(device)
        return int(policy(generator, states)[0])

    return pick


def terminal_action(env):
    env.render("terminal")
    while True:
        try:
            raw = input("move (row,col | p=pass | e=exit): ").strip().lower()
        except EOFError:  # end of input: leave the game
            return -1
        if raw in ("e", "exit"):
            return -1
        if raw in ("p", "pass", ""):
            return None
        try:
            r, c = (int(x) for x in raw.replace(" ", ",").split(",") if x != "")
            if 0 <= r < env.size and 0 <= c < env.size:
                return (r, c)
        except ValueError:
            pass
        print("could not parse move, try again")


def main(argv=None):
    from gymgo_tpu_torch.env import GoEnv

    args = build_parser().parse_args(argv)
    go_env = GoEnv(size=args.boardsize, komi=args.komi)
    go_env.reset()
    move_log = []
    ai_action = make_net_ai(args) if args.ai == "net" else (lambda env: env.uniform_random_action())

    done = False
    while not done:
        if args.render == "human":
            action = go_env.render(mode="human")
        else:
            action = terminal_action(go_env)
        if action == -1:
            break
        state, reward, done, info = go_env.step(action)
        move_log.append(action)

        if go_env.game_ended():
            break
        action = ai_action(go_env)
        state, reward, done, info = go_env.step(action)
        move_log.append(action)

    go_env.render(mode=args.render if args.render == "human" else "terminal")
    if go_env.game_ended():
        winner = go_env.winner()
        print("Result:", "black wins" if winner > 0 else ("white wins" if winner < 0 else "tie"))

    if args.sgf and move_log:
        from gymgo_tpu_torch.utils import sgf as sgf_mod

        def norm(a):
            if a is None:
                return args.boardsize ** 2
            if isinstance(a, tuple):
                return a[0] * args.boardsize + a[1]
            return int(a)

        record = sgf_mod.game_to_sgf(
            [norm(a) for a in move_log], args.boardsize, args.komi,
            result=sgf_mod.result_string(go_env.winning()) if go_env.game_ended() else None,
        )
        sgf_mod.save_sgf(args.sgf, record)
        print(f"saved SGF to {args.sgf}")


if __name__ == "__main__":
    main()
