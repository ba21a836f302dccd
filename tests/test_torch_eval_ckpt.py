"""``python -m gymgo_tpu_torch.scripts.eval_ckpt`` on the CPU: with a worker
killed at a chunk (``faulttol``'s injected crash) under ``--retries 1``, the
supervisor relaunches the child and the tallies equal an unbroken run's,
chunk for chunk; the supervisors of ``eval_ckpt`` and ``elo_ladder`` import no
torch.  ``tests/test_torch_ladder.py`` does the same for the ladder."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gymgo_tpu_torch.models.az_net import AZNetConfig, init_params
from gymgo_tpu_torch.scripts import eval_ckpt
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


def test_eval_ckpt_through_an_injected_crash_equals_the_unbroken_run(tiny, tmp_path, capsys):
    args = ["--ckpt", str(tiny), "--board", str(N), "--channels", "8", "--blocks", "1", "--sims", "4",
            "--gumbel-m", "4", "--games", "8", "--chunk", "4", "--max-steps", "40", "--cpu"]
    marker = tmp_path / "crash.marker"
    crashed, log = _run("gymgo_tpu_torch.scripts.eval_ckpt",
                        args + ["--retries", "1", "--state-file", str(tmp_path / "crashed.jsonl")], "1", marker)
    assert marker.exists(), "the injected crash never fired"
    assert "injected crash at chunk 1" in log and "child died (rc=137)" in crashed
    eval_ckpt.main(args + ["--retries", "0", "--state-file", str(tmp_path / "clean.jsonl")])  # unbroken, in process
    clean = capsys.readouterr().out
    led_a = faulttol.load_ledger(str(tmp_path / "crashed.jsonl"))
    led_b = faulttol.load_ledger(str(tmp_path / "clean.jsonl"))
    assert set(led_a) == set(led_b) == {"0", "1"}
    for k in ("0", "1"):
        assert led_a[k] == led_b[k], k
    report = re.compile(r"\(gumbel-4\) vs uniform-random: (\d+)W/(\d+)L/(\d+)T, (\d+) unfinished, winrate=")
    line_a = next(l for l in crashed.splitlines() if report.search(l))
    line_b = next(l for l in clean.splitlines() if report.search(l))
    assert line_a == line_b
    assert sum(map(int, report.search(line_a).groups())) == 8


def test_the_supervisors_import_no_torch():
    code = ("import sys; import gymgo_tpu_torch.scripts.eval_ckpt, gymgo_tpu_torch.scripts.elo_ladder, "
            "gymgo_tpu_torch.utils.faulttol; print(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
