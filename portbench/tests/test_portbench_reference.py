"""The benchmark's plain reference: the Go rules on known small games, the
rules and the float32 network against the port on the CPU."""

import numpy as np
import pytest
import torch

from portbench.reference import aznet, go, judge


def boards(*rows_per_board, white_to_move=False):
    """Boards from rows of ``.``, ``B``, ``W``; invalid moves worked out."""
    grid = np.array([[list(r) for r in rows] for rows in rows_per_board])
    black, white = grid == "B", grid == "W"
    s = len(grid)
    wtm = np.full(s, white_to_move)
    return go.Boards(black, white, go.forbidden(black, white, wtm), wtm, np.zeros(s, bool), np.zeros(s, bool))


def at(n, r, c):
    return r * n + c


def test_a_move_captures_a_group_without_liberties():
    b = boards([".BB..", "BWW..", ".BB..", ".....", "....."])
    b, out = go.step(b, [at(5, 1, 3)], 0.0, go.HEURISTIC)
    assert out.captured.tolist() == [2]
    assert not b.white.any()
    assert b.white_to_move.tolist() == [True]
    assert not out.invalid[0]


def test_simple_ko_forbids_the_immediate_retake_for_one_move():
    b = boards([".BW..", "BW.W.", ".BW..", ".....", "....."])
    b, out = go.step(b, [at(5, 1, 2)], 0.0, go.HEURISTIC)
    assert out.captured.tolist() == [1]
    assert b.invd[0, 1, 1] and not b.black[0, 1, 1] and not b.white[0, 1, 1]
    b2, out2 = go.step(b, [at(5, 1, 1)], 0.0, go.HEURISTIC)
    assert out2.invalid.tolist() == [True]
    assert (b2.to_states() == b.to_states()).all()
    b3, _ = go.step(b, [at(5, 4, 4)], 0.0, go.HEURISTIC)
    b3, _ = go.step(b3, [at(5, 4, 0)], 0.0, go.HEURISTIC)
    assert not b3.invd[0, 1, 1]


def test_a_capture_of_two_stones_leaves_no_ko():
    b = boards([".BB..", "BWW..", ".BB..", ".....", "....."])
    b, out = go.step(b, [at(5, 1, 3)], 0.0, go.HEURISTIC)
    assert out.captured.tolist() == [2]
    assert (b.invd == go.forbidden(b.black, b.white, b.white_to_move)).all()


def test_suicide_is_forbidden_unless_it_captures():
    # white to move: (4, 4) has no liberty and captures nothing; (1, 0) has none but takes (0, 0)
    b = boards(["BW...", ".W...", "B....", "....B", "...B."], white_to_move=True)
    assert b.invd[0, 4, 4]
    assert not b.invd[0, 1, 0] and not b.invd[0, 2, 2]
    b, out = go.step(b, [at(5, 1, 0)], 0.0, go.HEURISTIC)
    assert out.captured.tolist() == [1] and not out.invalid[0]
    b = boards(["W.W..", ".W...", ".....", ".....", "....."])
    assert b.invd[0, 0, 1]


def test_area_score_counts_stones_and_regions_of_one_colour():
    b = boards([".B.W.", "BB.WW", "...W.", "BBBW.", "...W."])
    black, white = go.areas(b.black, b.white)
    # the corner (0, 0) is black's; (0, 4) and the right column's three white's; the
    # middle region and row 4's first three cells touch both
    assert black.tolist() == [6 + 1]
    assert white.tolist() == [6 + 1 + 3]
    r = go.reward(black, white, np.array([False]), 0.5, go.HEURISTIC, 5)
    assert r.tolist() == [pytest.approx(-3.5)]
    assert go.reward(black, white, np.array([True]), 0.5, go.HEURISTIC, 5).tolist() == [-25.0]


def test_two_passes_end_the_game_and_auto_reset_restarts_it():
    b = boards([".B...", ".....", ".....", ".....", "....W"])
    b, o1 = go.step(b, [25], 0.0, go.HEURISTIC)
    b, o2 = go.step(b, [25], 0.0, go.HEURISTIC)
    assert o1.done.tolist() == [False] and o2.done.tolist() == [True]
    frozen, o3 = go.step(b, [0], 0.0, go.HEURISTIC)
    assert o3.invalid.tolist() == [False] and (frozen.to_states() == b.to_states()).all()
    fresh = go.reset_done(b)
    assert not fresh.black.any() and not fresh.done.any() and not fresh.white_to_move.any()


def test_handed_over_states_that_no_game_reaches_are_found():
    b = boards([".BW..", "BW.W.", ".BW..", ".....", "....."])
    b, _ = go.step(b, [at(5, 1, 2)], 0.0, go.HEURISTIC)
    assert not go.handed_over_faults(b).any()
    wrong = go.Boards(b.black, b.white, b.invd.copy(), b.white_to_move, b.passed, b.done)
    wrong.invd[0, 4, 4] = True  # a second forbidden empty cell that is no ko point
    assert go.handed_over_faults(wrong).all()
    missing = go.Boards(b.black, b.white, go.forbidden(b.black, b.white, b.white_to_move), b.white_to_move,
                        b.passed, b.done)
    assert not go.handed_over_faults(missing).any()  # the ko point may be dropped by a pass


@pytest.mark.parametrize("n,batch,steps", [(5, 16, 120), (9, 16, 160), (19, 8, 120)])
def test_the_rules_replay_the_ports_random_games(n, batch, steps):
    from gymgo_tpu_torch.config import EnvConfig
    from gymgo_tpu_torch.core.state import batch_init_state
    from gymgo_tpu_torch.env.batch_env import rollout

    cfg = EnvConfig(board_size=n, komi=0.5, reward_method="heuristic", batch_size=batch, auto_reset=True)
    r = rollout(torch.Generator().manual_seed(n), batch_init_state(batch, n, device="cpu"), steps, cfg)
    window = {"start": np.zeros((batch, 6, n, n), np.int8), "actions": r.actions.numpy(),
              "rewards": r.rewards.numpy(), "dones": r.dones.numpy(), "invalid": r.invalid.numpy(),
              "final": r.final_states.numpy(), "from_empty": True}
    readings = judge.env_windows([window], 0.5, "heuristic")
    assert readings["mismatches"] == 0
    assert readings["rank_bias"] < 0.05
    window["final"] = window["final"].copy()
    window["final"][0, 0, 0, 0] ^= 1
    assert judge.env_windows([window], 0.5, "heuristic")["mismatches"] == 1


def test_the_float32_network_is_the_ports_in_float32():
    from portbench.lib import weights

    cfg = {"board_size": 7, "channels": 16, "blocks": 2, "policy_channels": 2, "value_channels": 1,
           "value_hidden": 16, "dtype": "float32"}
    net, w = weights.program_net(cfg, 123, torch.device("cpu"))
    states = torch.zeros((4, 6, 7, 7), dtype=torch.int8)
    states[:, 0, 2, 3] = 1
    states[1:, 1, 4, 4] = 1
    states[2:, 2] = 1  # white to move
    from gymgo_tpu_torch.core.transform import batch_canonical_form

    logits, value = net(batch_canonical_form(states))
    ref_logits, ref_value = aznet.forward(w, states)
    torch.testing.assert_close(ref_logits, logits, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ref_value, value, rtol=1e-5, atol=1e-5)
    low_logits, _ = aznet.forward(w, states, fp8=True)
    assert (low_logits - ref_logits).abs().max() > 1e-3
