"""gymgo_tpu_torch.utils.metrics against gymgo_tpu.utils.metrics: the same
action streams stepped by both packages' ``BatchGoEnv``, the counters equal
after every step (the scripted cases of tests/test_aux.py and random streams
with captures, invalid actions and finished games)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.config import EnvConfig as JEnvConfig
from gymgo_tpu.env import BatchGoEnv as JBatchGoEnv
from gymgo_tpu.utils import metrics as jmetrics
from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.env import BatchGoEnv
from gymgo_tpu_torch.utils import metrics as tmetrics


def _run(n, b, auto_reset, streams, reward="real", komi=0.0):
    kw = dict(board_size=n, batch_size=b, auto_reset=auto_reset, reward_method=reward, komi=komi)
    jenv, tenv = JBatchGoEnv(JEnvConfig(**kw)), BatchGoEnv(EnvConfig(**kw), device="cpu")
    js, ts = jenv.reset(), tenv.reset()
    jm, tm = jmetrics.init_metrics(), tmetrics.init_metrics(device="cpu")
    for acts in streams:
        acts = np.asarray(acts, np.int32)
        js, jres = jenv.step(js, jnp.asarray(acts))
        ts, tres = tenv.step(ts, torch.from_numpy(acts))
        jm, tm = jmetrics.update_metrics(jm, jres), tmetrics.update_metrics(tm, tres)
        for name, got, want in zip(tmetrics.RolloutMetrics._fields, tm, jm):
            assert got.dtype == torch.int32 and got.shape == () and int(got) == int(want), name
    assert tmetrics.format_metrics(tm) == jmetrics.format_metrics(jm)
    return tm


def test_metrics_counters():
    p = 25
    m = _run(5, 3, True, ([p, 0, 1], [p, 5, 6], [0, 7, 8]))
    assert (int(m.env_steps), int(m.games_finished), int(m.ties)) == (9, 1, 1)
    assert int(m.black_wins) == int(m.white_wins) == int(m.invalid_actions) == 0
    assert "games=1" in tmetrics.format_metrics(m)


def test_metrics_no_double_count_frozen():
    m = _run(5, 1, False, [[25]] * 4)  # finishes at step 2, frozen after
    assert int(m.games_finished) == 1 and int(m.env_steps) == 4


@pytest.mark.parametrize("n,b,auto_reset,reward", [(5, 16, True, "real"), (5, 8, False, "heuristic"),
                                                   (9, 12, True, "heuristic")])
def test_random_streams_match(n, b, auto_reset, reward):
    """Uniform-random moves, a tenth of them on an occupied point (invalid)
    and a pass-heavy tail, so games end, stones are captured and invalid
    actions are counted."""
    rng = np.random.default_rng(n * b)
    kw = dict(board_size=n, batch_size=b, auto_reset=auto_reset, reward_method=reward)
    env = BatchGoEnv(EnvConfig(**kw), device="cpu")
    states = env.reset()
    streams = []
    for t in range(12 * n):
        invd = states[:, 3].reshape(b, -1).numpy()
        acts = np.empty(b, np.int32)
        for i in range(b):
            legal, illegal = np.flatnonzero(invd[i] == 0), np.flatnonzero(invd[i])
            if illegal.size and rng.random() < 0.1:
                acts[i] = rng.choice(illegal)
            elif rng.random() < (0.05 if t < 8 * n else 0.5):
                acts[i] = n * n
            else:
                acts[i] = rng.choice(legal) if legal.size else n * n
        streams.append(acts)
        states, _ = env.step(states, torch.from_numpy(acts))
    m = _run(n, b, auto_reset, streams, reward)
    assert int(m.games_finished) > 0 and int(m.stones_captured) > 0 and int(m.invalid_actions) > 0


def test_counters_stay_on_the_device():
    m = tmetrics.init_metrics(device="cpu")
    assert all(x.device.type == "cpu" and x.dtype == torch.int32 for x in m)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmetrics.init_metrics()
