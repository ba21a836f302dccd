"""Classic-Gym-compatible single-env adapter (counterpart of
``gymgo_tpu.env.go_env``).

The reference's surface: 4-tuple ``step``, ``reset`` returning the
observation only, ``info()``, ``valid_moves``/``children``/``winner``/
``winning``, class attributes ``govars``/``gogame``, terminal rendering, and
the REAL/HEURISTIC rewards with the heuristic tie -> -size^2 quirk.  Built on
gymnasium with the pre-0.26 API shape the reference uses.
"""

from __future__ import annotations

from enum import Enum

import numpy as np

try:
    import gymnasium as _gym
    _ENV_BASE = _gym.Env
except ImportError:  # pragma: no cover - gymnasium is optional
    _gym = None
    _ENV_BASE = object

from gymgo_tpu_torch import gogame, govars
from gymgo_tpu_torch.core.state import resolve_device
from gymgo_tpu_torch.utils import render as _render

__all__ = ["RewardMethod", "GoEnv"]


class RewardMethod(Enum):
    """REAL: 0 while ongoing, then sign(black_area - white_area - komi).
    HEURISTIC: area difference each step; +/- size^2 once ended."""

    REAL = "real"
    HEURISTIC = "heuristic"


def _canonical(states: np.ndarray) -> np.ndarray:
    """Canonical form of float64 (B, 6, N, N) states on the host: where white
    is to move, swap the colour planes and flip the turn plane."""
    swapped = states[:, [1, 0, 2, 3, 4, 5]]
    swapped[:, govars.TURN_CHNL] = 1 - states[:, govars.TURN_CHNL]
    white_to_move = states[:, govars.TURN_CHNL, 0, 0] == 1
    return np.where(white_to_move[:, None, None, None], swapped, states)


class GoEnv(_ENV_BASE):
    metadata = {"render.modes": ["terminal", "human"]}
    govars = govars
    gogame = gogame

    def __init__(self, size, komi=0, reward_method="real", backend="auto", device=None):
        """``backend``: 'native' steps with the C++ host engine (microseconds
        a move); 'torch' steps through the port's ``gogame`` on ``device``
        (``cuda`` unless named; the bundle kernel on the card, but a few ms a
        move of host dispatch at batch 1); 'auto' (default) picks native when
        the engine builds on this host, else torch on ``device``.  A
        single-env step is a host-latency problem, so auto prefers native.
        ``env.backend`` records the choice.  Nothing runs on the CPU torch
        path unless ``device="cpu"`` is asked for."""
        if backend not in ("auto", "native", "torch"):
            raise ValueError(f"unknown backend {backend!r}")
        self.size = size
        self.komi = komi
        self.state_ = gogame.init_state(size)
        self.reward_method = RewardMethod(reward_method)
        self._native = None
        self.device = None
        if backend in ("auto", "native"):
            from gymgo_tpu_torch.native import NativeGoEngine, NativeUnavailable

            try:
                self._native = NativeGoEngine(size)
                backend = "native"
            except (NativeUnavailable, OSError, ValueError):
                if backend == "native":
                    raise
                backend = "torch"
        if backend == "torch":
            self.device = resolve_device(device)
        self.backend = backend
        self._fused_areas = None
        if _gym is not None:
            self.observation_space = _gym.spaces.Box(
                np.float32(0), np.float32(govars.NUM_CHNLS), shape=(govars.NUM_CHNLS, size, size))
            self.action_space = _gym.spaces.Discrete(gogame.action_size(self.state_))
        self.done = False

    def reset(self, seed=None, options=None):
        """Classic-gym reset: returns the observation only.  ``seed`` and
        ``options`` are taken for gymnasium's wrappers; a seed seeds the
        global np.random stream the reference draws from too."""
        if seed is not None:
            np.random.seed(seed)
        self.state_ = gogame.init_state(self.size)
        self.done = False
        self._fused_areas = None
        return np.copy(self.state_)

    def step(self, action):
        """Apply one move (flat int, (row, col), or None for pass).

        Returns the classic 4-tuple (observation, reward, done, info); raises
        on an invalid move and on stepping a finished game."""
        assert not self.done
        if isinstance(action, (tuple, list, np.ndarray)):
            assert 0 <= action[0] < self.size
            assert 0 <= action[1] < self.size
            action = self.size * action[0] + action[1]
        elif action is None:
            action = self.size ** 2

        if self._native is not None:
            new_state, status = self._native.next_state(self.state_, int(action))
            assert status == 0, ("Invalid move", action)
            self.state_ = new_state.astype(np.float64)
        else:
            # keep the step's areas for the reward: no second flood
            self.state_, areas = gogame._next_state_with_areas(self.state_, action, device=self.device)
            self._fused_areas = (self.state_, areas)
        self.done = gogame.game_ended(self.state_)
        return np.copy(self.state_), self.reward(), self.done, self.info()

    def game_ended(self):
        return self.done

    def turn(self):
        return gogame.turn(self.state_)

    def prev_player_passed(self):
        return gogame.prev_player_passed(self.state_)

    def valid_moves(self):
        return gogame.valid_moves(self.state_)

    def uniform_random_action(self):
        valid_move_idcs = np.argwhere(self.valid_moves()).flatten()
        return np.random.choice(valid_move_idcs)

    def info(self):
        return {
            "turn": gogame.turn(self.state_),
            "invalid_moves": gogame.invalid_moves(self.state_),
            "prev_player_passed": gogame.prev_player_passed(self.state_),
        }

    def state(self):
        return np.copy(self.state_)

    def canonical_state(self):
        if self._native is not None:
            return _canonical(self.state_[None])[0]
        return gogame.canonical_form(self.state_, device=self.device)

    def children(self, canonical=False, padded=True):
        if self._native is None:
            return gogame.children(self.state_, canonical, padded, device=self.device)
        valid = gogame.valid_moves(self.state_)
        idcs = np.nonzero(valid)[0]
        tiled = np.tile(self.state_[None].astype(np.int8), (len(idcs), 1, 1, 1))
        stepped, _ = self._native.batch_next_states(tiled, idcs)
        out = stepped.astype(np.float64)
        if canonical:
            out = _canonical(out)
        if padded:
            padded_out = np.zeros((len(valid), *self.state_.shape))
            padded_out[idcs] = out
            return padded_out
        return out

    def _areas(self):
        # the last step's areas while state_ is still the state it made
        cached = self._fused_areas
        if cached is not None and cached[0] is self.state_:
            return cached[1]
        if self._native is not None:
            return self._native.areas(self.state_)
        return gogame.areas(self.state_, device=self.device)

    def winning(self):
        black_area, white_area = self._areas()
        return np.sign(black_area - white_area - self.komi)

    def winner(self):
        if self.game_ended():
            return self.winning()
        return 0

    def reward(self):
        if self.reward_method == RewardMethod.REAL:
            return self.winner()
        if self.reward_method == RewardMethod.HEURISTIC:
            black_area, white_area = self._areas()
            komi_correction = black_area - white_area - self.komi
            if self.game_ended():
                # a tie scores -size^2 (the reference's code, not its README)
                return (1 if komi_correction > 0 else -1) * self.size ** 2
            return komi_correction
        raise Exception("Unknown Reward Method")

    def __str__(self):
        black_area, white_area = self._areas()
        return _render.board_str(
            self.state_, black_area=black_area, white_area=white_area, done=bool(gogame.game_ended(self.state_)),
            passed=bool(gogame.prev_player_passed(self.state_)), turn=gogame.turn(self.state_))

    def close(self):
        if hasattr(self, "window"):  # pragma: no cover - GUI only
            self.window.close()

    def render(self, mode="terminal"):
        if mode == "terminal":
            print(self.__str__())
        elif mode == "human":
            import pyglet  # noqa: F401 - raises ImportError where pyglet is absent, as in the JAX package

            raise NotImplementedError("the pyglet window (gymgo_tpu.utils.gui) is not ported yet")
        else:
            raise ValueError(f"unknown render mode {mode!r}")
