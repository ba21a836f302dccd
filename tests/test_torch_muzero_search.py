"""Gumbel MuZero in the port: ``run_gumbel_mcts`` over a ``MuZeroNet``
against the plain reference search (``tests/muzero_reference.py``: one root
at a time, a dict tree) on the same Gumbel noise, on the CPU at a small size,
and the front ends that run it through their existing calls."""

import numpy as np
import pytest
import torch

import muzero_reference as ref
from gymgo_tpu_torch.core.actions import batch_valid_moves
from gymgo_tpu_torch.models import muzero_net
from gymgo_tpu_torch.models.muzero_net import MuZeroNetConfig
from gymgo_tpu_torch.rl.gumbel_mcts import LearnedMCTSResult, make_gumbel_mcts_policy, run_gumbel_mcts
from torch_boards import crafted_state, midgame_states

N = 9


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def net_and_weights(seed=0):
    g = torch.Generator().manual_seed(seed)
    net = muzero_net.init_params(g, MuZeroNetConfig(N, 32, 2, value_hidden=32, dtype=torch.float32)).eval()
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() == 1:
                p.copy_(torch.randn(p.shape, generator=g) * 0.3 + (1.0 if "norm" in name and "weight" in name else 0))
            elif name == "value_out.weight":
                p.mul_(8)  # values spread over (-1, 1), so the backed-up q moves the choices
    return net, {name: p.detach().clone() for name, p in net.named_parameters()}


def noise(b, seed):
    return torch.from_numpy(np.random.default_rng(seed).gumbel(size=(b, N * N + 1)).astype(np.float32))


def check_against_reference(res, w, states, gumbel, sims, considered):
    assert isinstance(res, LearnedMCTSResult)
    legal = batch_valid_moves(states) > 0
    for i in range(len(states)):
        want = ref.search(w, states[i], legal[i], gumbel[i], sims, considered)
        assert int(res.actions[i]) == want["action"]
        assert res.root_visits[i].tolist() == want["visits"]
        assert res.sampled_actions[i].tolist() == want["candidates"]
        nodes = want["nodes"]
        assert res.node_parent[i].tolist() == [nd["parent"] for nd in nodes]
        assert res.node_action[i].tolist() == [nd["action"] for nd in nodes]
        np.testing.assert_allclose(res.node_value[i].numpy(), [nd["value"] for nd in nodes], rtol=0, atol=1e-5)
        np.testing.assert_allclose(res.node_logits[i].numpy(), [nd["logits"] for nd in nodes], rtol=0, atol=1e-4)
        np.testing.assert_allclose(res.improved_policy[i].numpy(), want["policy"], rtol=0, atol=1e-5)
        assert abs(float(res.root_value[i]) - want["root_value"]) < 1e-5


@pytest.mark.parametrize("seed", [0, 1])
def test_the_learned_search_equals_the_plain_reference_search(seed):
    net, w = net_and_weights(seed)
    states = torch.from_numpy(midgame_states(N, 4, 24 + seed, seed))
    gumbel = noise(4, seed)
    res = run_gumbel_mcts(None, states, net, num_simulations=12, max_considered=4, gumbel=gumbel)
    check_against_reference(res, w, states, gumbel, 12, 4)
    assert (res.node_parent[:, 1:] >= 1).any()  # the trees grew below the root


def test_the_search_hands_back_the_stored_states_of_the_boards_asked_for():
    """``latent_rows`` returns those boards' store: the root's ``h``, every
    other slot ``g`` of its parent's slot and its action, and ``f`` of each
    slot the node's value and logits."""
    from gymgo_tpu_torch.core.transform import batch_canonical_form

    net, _ = net_and_weights(4)
    states = torch.from_numpy(midgame_states(N, 4, 20, 4))
    res = run_gumbel_mcts(None, states, net, num_simulations=8, max_considered=4, gumbel=noise(4, 4),
                          latent_rows=torch.tensor([2, 0]))
    assert res.node_latents.shape == (2, 9, 32, N, N)
    with torch.no_grad():
        for k, row in enumerate((2, 0)):
            lat = res.node_latents[k]
            torch.testing.assert_close(lat[:1], net.represent(batch_canonical_form(states[row:row + 1])),
                                       rtol=0, atol=1e-5)
            parent, action = res.node_parent[row].long(), res.node_action[row].long()
            torch.testing.assert_close(lat[1:], net.dynamics(lat[parent[1:]], action[1:]), rtol=0, atol=1e-5)
            logits, value = net.predict(lat)
            torch.testing.assert_close(value, res.node_value[row], rtol=0, atol=1e-5)
            torch.testing.assert_close(logits, res.node_logits[row], rtol=0, atol=1e-4)
    assert run_gumbel_mcts(None, states, net, num_simulations=8, max_considered=4).node_latents is None


def test_latent_rows_is_refused_for_the_exact_simulator():
    from gymgo_tpu_torch.models.az_net import AZNetConfig, init_params

    net = init_params(torch.Generator().manual_seed(0), AZNetConfig(N, 8, 1, dtype=torch.float32))
    states = torch.from_numpy(midgame_states(N, 2, 6, 0))
    with pytest.raises(ValueError, match="latent_rows"):
        run_gumbel_mcts(None, states, net, num_simulations=4, max_considered=2, latent_rows=torch.tensor([0]))


def test_below_the_root_no_move_is_masked_and_no_node_is_terminal():
    """Roots whose previous move was a pass, on boards full but for the
    first row: a pass from the root would end the game, and every other row
    is occupied.  The noise puts the pass first, so it takes half the
    visits; below it the search expands on (no terminal node) and plays
    occupied points (no mask), as the reference does."""
    net, w = net_and_weights(2)
    rng = np.random.default_rng(5)
    boards = []
    for k in range(3):
        cells = [(r, c) for r in range(1, N) for c in range(N)]
        order = rng.permutation(len(cells))
        black = [cells[j] for j in order[::2]]
        white = [cells[j] for j in order[1::2]]
        boards.append(crafted_state(N, black, white, white_to_move=bool(k % 2), prev_passed=True))
    states = torch.from_numpy(np.stack(boards))
    gumbel = noise(3, 7)
    gumbel[:, N * N] = 30.0
    res = run_gumbel_mcts(None, states, net, num_simulations=16, max_considered=2, gumbel=gumbel)
    check_against_reference(res, w, states, gumbel, 16, 2)
    legal = batch_valid_moves(states) > 0
    for i in range(3):
        parent, action = res.node_parent[i], res.node_action[i]
        (pass_slot,) = torch.nonzero((parent == 0) & (action == N * N))[:, 0].tolist()
        assert (parent == pass_slot).any()  # the node after the game-ending pass is expanded on
        below = action[parent > 0]
        assert (~legal[i][below]).any()  # points the root's rules forbid are played below it


def test_gtp_genmove_and_the_policy_adapter_run_a_learned_model():
    from gymgo_tpu_torch.utils import gtp

    net, _ = net_and_weights(3)
    engine = gtp.GTPEngine(N, komi=7.5, genmove_fn=gtp.GumbelMover(net, simulations=8, komi=7.5, seed=1),
                           backend="torch", device="cpu")
    for colour in "bwb":
        reply, err, _ = engine.handle(f"genmove {colour}")
        assert not err and reply.startswith("= ")
    assert len(engine.history) == 3  # three legal moves were played
    policy = make_gumbel_mcts_policy(net, num_simulations=6, max_considered=4)
    states = torch.from_numpy(midgame_states(N, 5, 10, 4))
    actions = policy(torch.Generator().manual_seed(0), states)
    legal = batch_valid_moves(states) > 0
    assert actions.shape == (5,) and legal[torch.arange(5), actions.long()].all()
