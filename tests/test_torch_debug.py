"""gymgo_tpu_torch.core.debug against gymgo_tpu.core.debug: ``checked_step``
raises with JAX's checkify message where JAX reports an error, and returns
exactly what ``step_states`` returns elsewhere; ``enable_nan_debugging``
turns on autograd's anomaly detection."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.core import debug as jdebug
from gymgo_tpu_torch.core import debug as tdebug
from gymgo_tpu_torch.core.step import step_states
from torch_boards import crafted_state, midgame_states

N = 5


def _batches():
    """(states, actions) batches: legal moves and passes; an occupied point;
    an out-of-range action; a finished game; both faults at once."""
    states = midgame_states(N, 6, 10, 3)
    legal = np.array([int(np.flatnonzero(s[3].reshape(-1) == 0)[0]) for s in states], np.int32)
    occupied = legal.copy()
    occupied[2] = int(np.flatnonzero(states[2, :2].reshape(2, -1).any(0))[0])
    out_of_range = legal.copy()
    out_of_range[4] = N * N + 3
    finished = states.copy()
    finished[1] = crafted_state(N, black=[(0, 0)], white=[(4, 4)], prev_passed=True, done=True)
    passes = np.full(len(states), N * N, np.int32)
    return {
        "legal": (states, legal),
        "passes": (states, passes),
        "occupied": (states, occupied),
        "out_of_range": (states, out_of_range),
        "finished": (finished, legal),
        "finished_and_occupied": (finished, occupied),
    }


@pytest.mark.parametrize("case", list(_batches()))
def test_checked_step_matches_jax(case):
    states, actions = _batches()[case]
    err, (jnew, jinfo) = jdebug.checked_step(jnp.asarray(states), jnp.asarray(actions))
    message = err.get()
    ts, ta = torch.from_numpy(states), torch.from_numpy(actions)
    if message is None:
        got, info = tdebug.checked_step(ts, ta)
        want, winfo = step_states(ts, ta)
        assert torch.equal(got, want)
        for g, w in zip(info, winfo):
            assert torch.equal(g, w)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jnew))
        assert case in ("legal", "passes")
    else:
        with pytest.raises(RuntimeError) as raised:
            tdebug.checked_step(ts, ta)
        assert str(raised.value) in message
        assert case not in ("legal", "passes")


def test_enable_nan_debugging():
    before = torch.is_anomaly_enabled()
    try:
        tdebug.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
        x = torch.zeros(2, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1.0).sum().backward()
    finally:
        torch.autograd.set_detect_anomaly(before)
