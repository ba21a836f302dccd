"""When the step runs as the hand kernels of ``ops.env_step`` (on the card)
and when it keeps the op-by-op PyTorch code: the CPU, the minmax route (boards
over 22x22) and every ``GYMGO_ABLATE`` token take the plain step, which no
launcher is asked for; the wrappers refuse what the kernels do not take
before they reach a launcher.  The kernels themselves run on the card only
(``tests/test_torch_cuda_env_step.py``)."""

import types

import numpy as np
import pytest
import torch

from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core import flood as tflood
from gymgo_tpu_torch.core import step as tstep
from gymgo_tpu_torch.core.state import batch_init_state
from gymgo_tpu_torch.env.batch_env import rollout
from gymgo_tpu_torch.ops import env_step


def _boards(n):
    """A stand-in for a CUDA tensor of 4 boards (``fused_step`` reads only
    its device type and shape)."""
    return types.SimpleNamespace(is_cuda=True, shape=(4, 6, n, n))


@pytest.fixture
def no_launch(monkeypatch):
    """Every launcher of ``ops.env_step`` raises."""
    def refuse(*_args, **_kw):
        raise AssertionError("an env_step kernel was launched")

    for lib in env_step.KERNELS:
        monkeypatch.setattr(lib, "launch", refuse)


@pytest.fixture
def minmax_route(monkeypatch):
    """The size rule sends every board to the minmax route."""
    monkeypatch.setattr(tflood, "bundle_fits", lambda n: False)


@pytest.fixture
def ablated():
    previous = tstep.set_ablate(())
    yield tstep.set_ablate
    tstep.set_ablate(previous)


@pytest.mark.parametrize("n", [1, 5, 9, 19, 22])
def test_the_card_takes_the_kernels_on_the_bundle_route(n):
    assert tstep.fused_step(_boards(n))


def test_cpu_tensors_take_the_plain_step(no_launch):
    states = batch_init_state(4, 9, device="cpu")
    assert tstep.fused_step(_boards(9)) and not tstep.fused_step(states)
    cfg = EnvConfig(board_size=9, batch_size=4, auto_reset=True)
    r = rollout(torch.Generator().manual_seed(0), states, 12, cfg)
    new, info = tstep.step_states(r.final_states, torch.zeros(4, dtype=torch.int32))
    ps, _ = tstep.step_planes(tstep.seed_planes(new), torch.full((4,), 81, dtype=torch.int32))
    want, want_info = tstep.step_states_plain(r.final_states, torch.zeros(4, dtype=torch.int32))
    assert torch.equal(new, want) and all(torch.equal(x, y) for x, y in zip(info, want_info))
    assert ps.done.shape == (4,)


@pytest.mark.parametrize("n", [7, 9])
def test_the_minmax_route_takes_the_plain_step(n, minmax_route, no_launch):
    assert not tstep.fused_step(_boards(n))
    cfg = EnvConfig(board_size=n, batch_size=3, auto_reset=True)
    rollout(torch.Generator().manual_seed(1), batch_init_state(3, n, device="cpu"), 6, cfg)


@pytest.mark.parametrize("n", [23, 25, 64])
def test_boards_over_the_bundle_word_take_the_plain_step(n, no_launch):
    assert n * n > tflood.MAX_BUNDLE_CELLS and not tflood.bundle_fits(n)
    assert not tstep.fused_step(_boards(n))
    if n == 23:  # the plain step floods boards this size on the minmax route
        tstep.step_states(batch_init_state(2, n, device="cpu"), torch.tensor([0, n * n], dtype=torch.int32))


@pytest.mark.parametrize("token", tstep.ABLATE_TOKENS)
def test_every_ablation_takes_the_plain_step(token, ablated, no_launch):
    ablated({token})
    assert not tstep.fused_step(_boards(9))
    cfg = EnvConfig(board_size=5, batch_size=3, auto_reset=True)
    rollout(torch.Generator().manual_seed(2), batch_init_state(3, 5, device="cpu"), 4, cfg)
    ablated(())
    assert tstep.fused_step(_boards(9))


def _planes(b=3, n=9):
    z = torch.zeros((b, n, n), dtype=torch.bool)
    flags = torch.zeros((b,), dtype=torch.bool)
    return z, z.clone(), z.clone(), flags, flags.clone(), flags.clone()


def test_the_wrappers_refuse_a_wrong_dtype(no_launch):
    black, white, invd, wtm, passed, done = _planes()
    acts = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        env_step.rules(black, white, invd, wtm, passed, done, acts.float(), atari=black.to(torch.int16))
    with pytest.raises(TypeError, match="int16"):
        env_step.rules(black, white, invd, wtm, passed, done, acts, atari=black.to(torch.int32))
    with pytest.raises(TypeError):
        env_step.sample(black.int(), white, invd, wtm, passed, done, reset=True)
    with pytest.raises(TypeError):
        env_step.split(torch.zeros((3, 6, 9, 9), dtype=torch.float32))
    word = torch.zeros((3, 9, 9), dtype=torch.int32)
    with pytest.raises(TypeError):
        env_step.score(black, white, word.to(torch.int64), word[:, 0, 0], invd)
    with pytest.raises(TypeError, match="float32"):
        env_step.score(black, white, word, word[:, 0, 0].contiguous(), invd, reward=word[:, 0, 0].double(),
                       reward_method="real")


def test_the_wrappers_refuse_a_non_contiguous_input(no_launch):
    black, white, invd, wtm, passed, done = _planes()
    with pytest.raises(ValueError, match="contiguous"):
        env_step.sample(black.transpose(1, 2), white, invd, wtm, passed, done, reset=True)
    with pytest.raises(ValueError, match="contiguous within a board"):
        env_step.rules(black.transpose(1, 2), white, invd, wtm, passed, done, torch.zeros(3, dtype=torch.int32),
                       atari=black.to(torch.int16))
    with pytest.raises(ValueError, match="contiguous"):
        env_step.split(torch.zeros((3, 9, 9, 6), dtype=torch.int8).permute(0, 3, 1, 2))
    states = torch.zeros((3, 6, 9, 9), dtype=torch.int8)
    with pytest.raises(ValueError, match="stride"):  # planes of states beside a plane of their own
        env_step.rules(states[:, 0], white, states[:, 3], states[:, 2, 0, 0], states[:, 4, 0, 0],
                       states[:, 5, 0, 0], torch.zeros(3, dtype=torch.int32), atari=black.to(torch.int16))


def test_the_wrappers_refuse_a_board_over_the_bundle_word(no_launch):
    black, white, invd, wtm, passed, done = _planes(n=23)
    with pytest.raises(ValueError, match="511"):
        env_step.sample(black, white, invd, wtm, passed, done, reset=True)
    with pytest.raises(ValueError, match="511"):
        env_step.split(torch.zeros((2, 6, 23, 23), dtype=torch.int8))
    with pytest.raises(ValueError, match="511"):
        env_step.rules(black, white, invd, wtm, passed, done, torch.zeros(3, dtype=torch.int32),
                       atari=black.to(torch.int16))


def test_the_wrappers_refuse_cpu_tensors_and_inconsistent_arguments(no_launch):
    black, white, invd, wtm, passed, done = _planes()
    acts = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        env_step.sample(black, white, invd, wtm, passed, done, reset=True)
    with pytest.raises(ValueError, match="CUDA"):
        env_step.split(torch.zeros((3, 6, 9, 9), dtype=torch.int8))
    with pytest.raises(ValueError, match="either"):  # captures from the atari plane or the word, not both
        env_step.rules(black, white, invd, wtm, passed, done, acts, atari=black.to(torch.int16),
                       word=torch.zeros((3, 9, 9), dtype=torch.int32))
    with pytest.raises(ValueError, match="together"):
        env_step.sample(black, white, invd, wtm, passed, done, reset=False, words=acts.long())
    with pytest.raises(ValueError, match="shape"):
        env_step.rules(black, white, invd, wtm, passed, done, torch.zeros((4,), dtype=torch.int32),
                       atari=black.to(torch.int16))
    word = torch.zeros((3, 9, 9), dtype=torch.int32)
    with pytest.raises(ValueError, match="reward method"):
        env_step.score(black, white, word, word[:, 0, 0].contiguous(), invd, reward=torch.zeros(3),
                       reward_method="win")
    board = tstep.PlanesState(black, white, invd, wtm, passed, done, atari=black.to(torch.int16))
    with pytest.raises(ValueError, match="CUDA"):
        env_step.fused(board, actions=acts)
    with pytest.raises(ValueError, match="atari"):  # the fused step is the carried path's
        env_step.fused(board._replace(atari=None), actions=acts)
    with pytest.raises(ValueError, match="either"):  # the sampler's words or the actions, not both
        env_step.fused(board, words=acts.long(), actions=acts)
    with pytest.raises(ValueError, match="reward method"):
        env_step.fused(board, actions=acts, reward=torch.zeros(3), reward_method="win")


def test_the_plain_step_is_the_op_by_op_step_on_the_cpu():
    rng = np.random.default_rng(3)
    states = rollout(torch.Generator().manual_seed(3), batch_init_state(16, 7, device="cpu"), 30,
                     EnvConfig(board_size=7, batch_size=16)).final_states
    acts = torch.from_numpy(rng.integers(-1, 51, 16).astype(np.int64))
    got, got_info = tstep.step_states(states, acts)
    want, want_info = tstep.step_states_plain(states, acts)
    assert torch.equal(got, want) and all(torch.equal(x, y) for x, y in zip(got_info, want_info))
    ps = tstep.seed_planes(states)
    got_ps, got_info = tstep.step_planes(ps, acts)
    want_ps, want_info = tstep.step_planes_plain(ps, acts)
    assert all(torch.equal(x, y) for x, y in zip(got_ps, want_ps))
    assert all(torch.equal(x, y) for x, y in zip(got_info, want_info))
