"""``python -m gymgo_tpu_torch.train`` and ``python -m
gymgo_tpu_torch.params_to_ckpt`` on the CPU: a run cut by a checkpoint and
resumed ends in the same state, bit for bit, as the unbroken run; a
re-seeded artifact resumes with value-head surgery and PUCT self-play."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gymgo_tpu_torch import convert
from gymgo_tpu_torch.train import Trainer, build_parser

_REPO = Path(__file__).resolve().parent.parent
SMALL = ["--board", "5", "--envs", "8", "--channels", "8", "--blocks", "1", "--rollout-steps", "4",
         "--train-batch", "32", "--replay-capacity", "48", "--cpu"]


def _run(module, *args):
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=_REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_resumed_run_equals_the_unbroken_run(tmp_path):
    flags = SMALL + ["--gumbel-sims", "4", "--augment", "--value-grounded-only"]
    cut, resumed, whole = tmp_path / "cut.npz", tmp_path / "resumed.npz", tmp_path / "whole.npz"
    first = _run("gymgo_tpu_torch.train", *flags, "--iters", "2", "--checkpoint", str(cut))
    second = _run("gymgo_tpu_torch.train", *flags, "--iters", "3", "--resume", str(cut), "--checkpoint",
                  str(resumed))
    third = _run("gymgo_tpu_torch.train", *flags, "--iters", "3", "--checkpoint", str(whole))
    assert "iter 0: loss=" in first and "iter 1: loss=" in first
    assert "resumed from" in second and "at iteration 2" in second
    # the print line of iteration 2, apart from the rate, is the same
    line = lambda out: next(l for l in out.splitlines() if l.startswith("iter 2:")).rsplit(" env-steps/s", 1)[0]
    assert line(second) == line(third)
    a, b = np.load(resumed), np.load(whole)
    assert a.files == b.files and len(a.files) > 40
    for name in a.files:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert int(a["iteration"]) == 3 and int(a["step"]) == 3 and int(a["buf/filled"]) == 48


def test_params_to_ckpt_then_resume_with_surgery_and_puct(tmp_path):
    tree = tmp_path / "az7.npz"
    out = _run("gymgo_tpu_torch.params_to_ckpt", "--params", "artifacts/az7_r5_iter120_params.npz", "--out",
               str(tree), "--board", "7", "--envs", "4", "--channels", "64", "--blocks", "3", "--iteration", "120",
               "--replay-capacity", "64", "--cpu")
    assert "iteration 120" in out
    data = np.load(tree)
    assert int(data["iteration"]) == 120 and int(data["buf/filled"]) == 0 and not data["opt_state/exp_avg/stem.weight"].any()
    params = convert.read_flax_npz("artifacts/az7_r5_iter120_params.npz")
    want = convert.aznet_state_dict_from_flax(params, convert.aznet_config_from_flax(params, torch.float32))
    for k, v in want.items():
        np.testing.assert_array_equal(data[f"params/{k}"], v.numpy())
        np.testing.assert_array_equal(data[f"target_params/{k}"], v.numpy())
    logs = []
    args = build_parser().parse_args([
        "--board", "7", "--envs", "4", "--channels", "64", "--blocks", "3", "--rollout-steps", "2", "--iters", "121",
        "--replay-capacity", "64", "--train-batch", "8", "--mcts-sims", "4", "--mcts-par", "2", "--mcts-reuse",
        "subtree", "--value-bootstrap", "--reinit-value-head", "--resume", str(tree), "--cpu"])
    trainer = Trainer(args, log=lambda *a, **k: logs.append(" ".join(map(str, a))))
    assert not trainer.net.value_out.weight.any() and "re-initialized" in logs[-1]
    trainer.run()
    assert trainer.iteration == 121 and trainer.train_state.step == 1 and int(trainer.buf_state.filled) == 8
    # the bootstrap of a zeroed head is 0, and so is every truncated target:
    # the last layer gets no gradient yet; the trunk moves
    assert not torch.equal(trainer.net.stem.weight.detach(), want["stem.weight"])
    with pytest.raises(ValueError, match="not 7x7 32x3"):
        from gymgo_tpu_torch.params_to_ckpt import tree_from_params
        tree_from_params("artifacts/az7_r5_iter120_params.npz", 7, 4, 32, 3, 0, device="cpu")


@pytest.mark.parametrize("mode", [["--search-k", "0"], ["--search-k", "4", "--eval-every", "1", "--eval-games", "4"]])
def test_other_selfplay_modes_and_evaluation_run(mode):
    logs = []
    args = build_parser().parse_args(SMALL + ["--iters", "1"] + mode)
    Trainer(args, log=lambda *a, **k: logs.append(" ".join(map(str, a)))).run()
    assert logs[0].startswith("iter 0: loss=")
    if "--eval-every" in mode:
        assert logs[1].startswith("  eval vs random: winrate=")


def test_the_cli_needs_a_card_without_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(build_parser().parse_args(["--board", "5"]))
