"""How often the GTP match pass rule replaces a mover's pass by a random move.

Under ``match_pass_rule`` a ``GTPEngine`` passes only to win after the
opponent's pass; any other pass its mover chooses becomes a uniformly random
board move (``GTPEngine._apply_pass_rule``, the same rule in the JAX package
and in the port).  A net whose search often returns pass then plays many
random moves, and may lose to a random opponent for the rule's sake.

This script runs ``gtp_match``'s CLI, the port's or the JAX package's, with
the rule counted, and prints before each game's line, for each colour: its
genmoves, how many of them chose pass and were replaced, and its lead (area
less komi, from its own side) at the first replacement, at its largest and
at its last genmove.  Run from the repo's root:

  python tests/torch_pass_rule.py port --boardsize 9 --games 8 --channels 64 --blocks 3 \\
      --a net:artifacts/az9_r5_iter100_params.npz:32 --b random [--cpu]
  python tests/torch_pass_rule.py jax --boardsize 9 --games 8 ...   (the JAX package, on the CPU)

``port`` imports nothing of JAX; ``jax`` imports the JAX package's
``scripts/gtp_match.py``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def counting(engine_cls):
    """Count ``engine_cls._apply_pass_rule`` while the block runs: yields a
    list that gets, per genmove under the rule, ``(engine, replaced, lead)``:
    ``replaced`` is true where the mover's pass became a random board move,
    ``lead`` the mover's area lead less komi before the move (the port's
    ``gogame.areas`` on the CPU, for both packages)."""
    from gymgo_tpu_torch import gogame

    rule = engine_cls._apply_pass_rule
    log = []

    def counted(self, action):
        black, white = gogame.areas(self.state.astype(np.float64), device="cpu")
        lead = float(black - white - self.komi) * (-1.0 if self._turn() == 1 else 1.0) + 0.0  # no -0
        out = rule(self, action)
        log.append((self, action == self.n * self.n and out != action, lead))
        return out

    engine_cls._apply_pass_rule = counted
    try:
        yield log
    finally:
        engine_cls._apply_pass_rule = rule


def summary(log, engine) -> str:
    leads = [lead for eng, _, lead in log if eng is engine]
    replaced = [lead for eng, rep, lead in log if eng is engine and rep]
    if not leads:
        return "0 genmoves"
    first = f"{replaced[0]:g}" if replaced else "-"
    return (f"{len(leads)} genmoves, {len(replaced)} passes replaced (lead at the first {first}, "
            f"largest {max(leads):g}, last {leads[-1]:g})")


def _jax_gtp_match():
    spec = importlib.util.spec_from_file_location("jax_gtp_match", ROOT / "scripts" / "gtp_match.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("port", "jax"):
        raise SystemExit("usage: python tests/torch_pass_rule.py port|jax [gtp_match flags]")
    impl, flags = argv[0], argv[1:]
    if impl == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        match = _jax_gtp_match()
        from gymgo_tpu.utils.gtp import GTPEngine

        run = lambda: (setattr(sys, "argv", ["gtp_match.py", *flags]), match.main())  # noqa: E731
    else:
        from gymgo_tpu_torch.scripts import gtp_match as match
        from gymgo_tpu_torch.utils.gtp import GTPEngine

        run = lambda: match.main(flags)  # noqa: E731

    play_game = match.play_game

    def play_and_count(black, white, boardsize, max_moves):
        log.clear()
        out = play_game(black, white, boardsize, max_moves)
        print(f"  pass rule: black {summary(log, black)}; white {summary(log, white)}", flush=True)
        return out

    match.play_game = play_and_count
    with counting(GTPEngine) as log:
        run()


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))  # run by path: the packages live at the repo's root
    main()
