"""gymgo_tpu_torch.utils.sgf against gymgo_tpu.utils.sgf: exported strings
equal, parsed records equal field for field, replayed states (float64) equal
bit for bit, and every ``SGFError`` raised with the same message, on the
records of ``tests/test_aux.py``: setup stones, handicap, FF[3] names,
compressed points, variations, collections and the rejections."""

import os

import jax
import numpy as np
import pytest
import torch

from gymgo_tpu.config import EnvConfig as JEnvConfig
from gymgo_tpu.core.state import batch_init_state as jbatch_init_state
from gymgo_tpu.env.batch_env import rollout as jrollout
from gymgo_tpu.utils import sgf as jsgf
from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core.state import batch_init_state
from gymgo_tpu_torch.env.batch_env import rollout
from gymgo_tpu_torch.native import NativeGoEngine
from gymgo_tpu_torch.utils import sgf as tsgf

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _fixture(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return f.read()


RECORDS = [
    "(;GM[1]SZ[5]KM[6.5];B[aa](;W[bb];B[cc])(;W[dd]))",
    "(;SZ[5];B[];W[tt])",
    "(;SZ[5]C[tricky \\] bracket];B[ab])",
    "(;SZ[5]\n ;B[aa]\n ;W[ba]\n)",
    "(;SZ[9]HA[2]KM[0.5]AB[gc][cg];W[ee];B[dd])",
    "(;GaMe[1]SiZe[5]KoMi[1];B[aa];White[ba])",
    "(;SZ[9]AB[aa:bb];W[ee])",
    "(;SZ[9]AB[aa:bb]AW[ee][ff];B[cc];W[dd])",
    "(;SZ[5];W[aa];B[bb])",
    "(;SZ[5];B[aa](;W[ba];B[ca])(;W[bb]))",
    "(;SZ[5];B[aa](;W[ba];B[ca]))",
    "(;SZ[7]KM[x]HA[y];B[dd];W[];B[])",
    "(;SZ[19]AW[dd][pp]HA[0];B[qq])",
    _fixture("handicap_kgs_style.sgf"),
]

REJECTED = [
    "(;SZ[5];B[aa];AB[cc]W[bb])",  # mid-game setup stones
    "(;SZ[5]AE[aa];B[bb])",  # setup erasure
    "(;SZ[19:13];B[aa])",  # rectangular board
    "(;SZ[21];B[aa])",  # beyond 19x19
    "(;SZ[x];B[aa])",  # unparseable size
    "(;SZ[5]AB[aa]AW[aa];W[bb])",  # AB/AW overlap
    "not an sgf",
    "(;SZ[5];B[aa]) ;W[bb]",  # trailing content
    "(;SZ[5];B[aaa])",  # bad coordinate
    "(;SZ[5];B[ff])",  # outside the board
    "(;SZ[5]AB[];B[aa])",  # setup stone on a pass coordinate
    "(;SZ[5]C[unterminated",
    "(;SZ[5];B[aa]",
    "()",
    _fixture("collection_two_games.sgf"),  # a collection through parse_sgf
]


def _same_error(fn_j, fn_t):
    with pytest.raises(jsgf.SGFError) as want:
        fn_j()
    with pytest.raises(tsgf.SGFError) as got:
        fn_t()
    assert str(got.value) == str(want.value)


def _assert_states_equal(tstates, jstates):
    assert len(tstates) == len(jstates)
    for t, j in zip(tstates, jstates):
        j = np.asarray(j)
        assert t.dtype == np.float64 == j.dtype
        np.testing.assert_array_equal(t, j)


def test_export_strings_match_jax():
    for actions, n, komi, result, names in [([0, 5, 25, 25], 5, 0.5, "B+R", {}), ([], 9, 0.0, None, {}),
                                            ([40, 81, 3, 81, 81], 9, 7.5, "W+3.5", {"black_name": "a",
                                                                                  "white_name": "b"})]:
        assert tsgf.game_to_sgf(actions, n, komi, result, **names) == jsgf.game_to_sgf(actions, n, komi, result,
                                                                                       **names)
    for sign in (1.0, -2.0, 0.0):
        assert tsgf.result_string(sign) == jsgf.result_string(sign)
    # a port rollout's records, split at auto-reset, equal JAX's from the same columns
    r = rollout(torch.Generator().manual_seed(2), batch_init_state(8, 5, device="cpu"), 160,
                EnvConfig(board_size=5, batch_size=8, auto_reset=True))
    acts, dones = r.actions.numpy(), r.dones.numpy()
    total = 0
    for env in range(8):
        got = tsgf.rollout_to_sgf_games(acts, dones, 5, komi=0.5, env_index=env)
        assert got == jsgf.rollout_to_sgf_games(acts, dones, 5, komi=0.5, env_index=env)
        total += len(got)
    assert total > 0


def test_collection_round_trip_matches_jax(tmp_path):
    games = [tsgf.game_to_sgf([0, 6, 12, 25, 25], 5, 0.5, "B+R"), tsgf.game_to_sgf([40, 41], 9, 6.5)]
    tpath, jpath = tmp_path / "t.sgf", tmp_path / "j.sgf"
    tsgf.save_sgf_collection(str(tpath), games)
    jsgf.save_sgf_collection(str(jpath), games)
    assert tpath.read_text() == jpath.read_text()
    tsgf.save_sgf(str(tpath), games[0])
    assert tpath.read_text() == games[0]
    text = _fixture("collection_two_games.sgf")
    assert tsgf.parse_sgf_collection(text) == jsgf.parse_sgf_collection(text)
    assert tsgf.parse_sgf_collection(jpath.read_text()) == jsgf.parse_sgf_collection(jpath.read_text())
    _same_error(lambda: jsgf.parse_sgf_collection("(;SZ[5];B[aa]) junk"),
                lambda: tsgf.parse_sgf_collection("(;SZ[5];B[aa]) junk"))


@pytest.mark.parametrize("index", range(len(RECORDS)))
def test_parse_and_replay_match_jax(index):
    text = RECORDS[index]
    game = tsgf.parse_sgf(text)
    assert game == jsgf.parse_sgf(text)
    tgame, tstates = tsgf.replay_sgf(text, device="cpu")
    jgame, jstates = jsgf.replay_sgf(text)
    assert tgame == jgame
    _assert_states_equal(tstates, jstates)
    # the setup position through the native engine's pass equals gogame's
    engine = NativeGoEngine(game.board_size)
    native = tsgf.setup_state(game, next_state=lambda s, a: engine.next_state(s, a)[0])
    np.testing.assert_array_equal(native, np.asarray(jsgf.setup_state(jgame)))


@pytest.mark.parametrize("index", range(len(REJECTED)))
def test_rejections_match_jax(index):
    text = REJECTED[index]
    _same_error(lambda: jsgf.parse_sgf(text), lambda: tsgf.parse_sgf(text))


def test_engine_rejections_match_jax():
    dead = "(;SZ[5]AB[aa]AW[ab][ba];B[cc])"
    _same_error(lambda: jsgf.setup_state(jsgf.parse_sgf(dead)),
                lambda: tsgf.setup_state(tsgf.parse_sgf(dead), device="cpu"))
    _same_error(lambda: jsgf.replay_sgf("(;SZ[5];B[aa];B[bb])"),
                lambda: tsgf.replay_sgf("(;SZ[5];B[aa];B[bb])", device="cpu"))
    with pytest.raises(AssertionError):  # an occupied point trips the engine's legality assert
        tsgf.replay_sgf("(;SZ[5];B[aa];W[aa])", device="cpu")
    for plane in (np.eye(5, dtype=bool), np.zeros((5, 5), bool)):
        assert tsgf._has_dead_group(plane, ~plane) == jsgf._has_dead_group(plane, ~plane)


def test_a_jax_rollout_record_replays_to_the_same_final_board():
    r = jrollout(jax.random.PRNGKey(2), jbatch_init_state(8, 5), 120, JEnvConfig(board_size=5, batch_size=8,
                                                                                  auto_reset=True))
    games = jsgf.rollout_to_sgf_games(r.actions, r.dones, 5, komi=0.5)
    assert games
    for text in games[:3]:
        tgame, tstates = tsgf.replay_sgf(text, device="cpu")
        jgame, jstates = jsgf.replay_sgf(text)
        assert tgame == jgame and tstates[-1][5].sum() == 25
        _assert_states_equal(tstates, jstates)


def test_replay_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsgf.replay_sgf("(;SZ[5];B[aa])")
    assert tsgf.parse_sgf("(;SZ[5];B[aa])").moves == [("B", 0)]  # parsing touches no device
