"""``gymgo_tpu_torch.scripts.fuzz_parity``: the port's batched ``step_states``
against its native engine over random games, on the CPU; and the soak finds a
fault put into either engine's step, naming the size, game, step and action.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gymgo_tpu_torch.core import step as tstep
from gymgo_tpu_torch.native import NativeGoEngine
from gymgo_tpu_torch.scripts import fuzz_parity

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.mark.parametrize("size,games,steps", [(5, 12, 120), (7, 8, 160)])
def test_batched_step_equals_native_over_random_games(size, games, steps):
    checked = fuzz_parity.fuzz(size, games, steps, CPU, seed=size)
    assert checked % games == 0 and checked > games * 20


def test_a_corrupted_torch_step_is_reported(monkeypatch):
    plain = tstep.step_states
    calls = []

    def corrupted(states, actions):
        new, info = plain(states, actions)
        calls.append(1)
        if len(calls) == 7:  # step 6: turn game 3's black stone plane over at one cell
            new = new.clone()
            new[3, 0, 2, 2] ^= 1
        return new, info

    monkeypatch.setattr(tstep, "step_states", corrupted)
    with pytest.raises(AssertionError, match=r"size=5 game=3 step=6 action=\d+"):
        fuzz_parity.fuzz(5, 6, 40, CPU)


def test_a_corrupted_native_step_is_reported(monkeypatch):
    plain = NativeGoEngine.next_state
    calls = []

    def corrupted(self, state, action):
        new, status = plain(self, state, action)
        calls.append(1)
        if len(calls) == 4 * 3 + 3:  # the call of step 3, game 2 (4 games, all live so early)
            new = new.copy()
            new[1, 0, 0] ^= 1
        return new, status

    monkeypatch.setattr(NativeGoEngine, "next_state", corrupted)
    with pytest.raises(AssertionError) as err:
        fuzz_parity.fuzz(7, 4, 40, CPU)
    size, game, step, action = map(int, re.findall(r"size=(\d+) game=(\d+) step=(\d+) action=(\d+)",
                                                   str(err.value))[0])
    assert (size, game, step) == (7, 2, 3) and 0 <= action <= 49


def test_cli_prints_states_checked():
    out = subprocess.run([sys.executable, "-m", "gymgo_tpu_torch.scripts.fuzz_parity", "--device", "cpu",
                          "--games", "4", "--sizes", "5", "--max-steps", "30"],
                         cwd=REPO, capture_output=True, text=True, timeout=120, check=True).stdout
    line = [l for l in out.splitlines() if l.startswith("{")][-1]
    assert '"states_checked": 120' in line and '"device": "cpu"' in line

