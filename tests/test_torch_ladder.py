"""``python -m gymgo_tpu_torch.scripts.elo_ladder --batched`` on the CPU,
supervised: with a worker killed at a chunk (``faulttol``'s injected crash)
under ``--retries 1``, the supervisor relaunches the child, which replays no
finished chunk, and the ladder equals an unbroken run's."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gymgo_tpu_torch.models.az_net import AZNetConfig, init_params
from gymgo_tpu_torch.scripts import elo_ladder
from gymgo_tpu_torch.scripts.export_params import export_params
from gymgo_tpu_torch.utils import faulttol

REPO = Path(__file__).resolve().parent.parent
N = 5


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A params artifact of the JAX package's layout: a random 5x5 8x1 net."""
    path = tmp_path_factory.mktemp("eval") / "tiny.npz"
    export_params(init_params(torch.Generator().manual_seed(1), AZNetConfig(board_size=N, channels=8, blocks=1)),
                  path)
    return path


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread here and in the subprocesses: the suite runs
    several workers on the machine's cores, and a tiny net gains nothing from
    more threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(module, args, crash_at=None, marker=None):
    env = {k: v for k, v in os.environ.items() if k not in (faulttol.CRASH_AT_ENV, faulttol.CRASH_MARKER_ENV)}
    env["OMP_NUM_THREADS"] = "1"
    if crash_at is not None:
        env.update({faulttol.CRASH_AT_ENV: crash_at, faulttol.CRASH_MARKER_ENV: str(marker)})
    r = subprocess.run([sys.executable, "-m", module, *args], env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout, r.stderr


def test_supervised_batched_ladder_through_an_injected_crash(tiny, tmp_path, capsys):
    args = ["--boardsize", str(N), "--games", "4", "--chunk", "2", "--channels", "8", "--blocks", "1", "--cpu",
            "--batched", "--gumbel-m", "4", "--player", "random", "--player", f"tiny=net:{tiny}:4"]
    marker = tmp_path / "crash.marker"
    crashed, _ = _run("gymgo_tpu_torch.scripts.elo_ladder",
                      args + ["--retries", "1", "--state-file", str(tmp_path / "crashed.jsonl")], "i0-j1-c1", marker)
    assert marker.exists()
    elo_ladder.main(args + ["--retries", "0", "--state-file", str(tmp_path / "clean.jsonl")])  # unbroken, in process
    clean = capsys.readouterr().out
    assert faulttol.load_ledger(str(tmp_path / "crashed.jsonl")) == faulttol.load_ledger(str(tmp_path / "clean.jsonl"))
    table = lambda out: out[out.rindex("| player |"):]  # the supervisor's, after the child's
    assert table(crashed) == table(clean)
