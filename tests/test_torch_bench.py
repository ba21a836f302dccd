"""The port's two benches run end to end on the CPU at a tiny size:
``bench_torch.py`` prints one JSON line with ``bench.py``'s keys, the
search bench its ``BENCHJSON`` lines and, with ``--batch-sweep``, its table;
without ``--cpu`` the rollout bench needs a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

_REPO = Path(__file__).resolve().parent.parent


def _run(*args):
    return subprocess.run([sys.executable, *args], cwd=_REPO, capture_output=True, text=True, timeout=300)


def test_bench_torch_prints_one_json_line():
    out = _run("bench_torch.py", "--cpu", "--board", "5", "--batch", "8", "--steps", "4", "--warmup-steps", "8",
               "--repeats", "2")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert {"metric", "value", "unit", "vs_baseline"} <= set(rec)
    assert rec["metric"] == "env_steps_per_sec_per_chip_5x5" and rec["unit"] == "env-steps/s/chip"
    assert len(rec["runs"]) == 2 and rec["value"] == max(rec["runs"]) > 0
    assert min(rec["runs"]) <= rec["median"] <= max(rec["runs"])
    assert rec["device"] == "cpu" and rec["nvidia_smi"] is None and rec["batch"] == 8
    assert rec["kernel_launches"] == 0  # the plain flood on the CPU


def test_bench_torch_needs_a_card_without_cpu_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run("bench_torch.py", "--board", "5", "--batch", "8", "--steps", "4", "--warmup-steps", "8")
    assert out.returncode != 0 and "CUDA" in out.stderr and out.stdout == ""


def test_mcts_bench_prints_benchjson_lines():
    out = _run("-m", "gymgo_tpu_torch.benchmarks.mcts_bench", "--cpu", "--board", "5", "--batch", "4", "--sims", "4",
               "--par", "2", "--channels", "8", "--blocks", "1", "--repeats", "1")
    assert out.returncode == 0, out.stderr[-2000:]
    recs = [json.loads(ln[len("BENCHJSON "):]) for ln in out.stdout.splitlines() if ln.startswith("BENCHJSON ")]
    assert [r["search"] for r in recs] == ["puct", "gumbel"]
    for r in recs:
        assert {"search", "batch", "sims", "ms_per_search", "decisions_per_s"} <= set(r)
        assert r["batch"] == 4 and r["sims"] == 4 and r["ms_per_search"] > 0 and r["device"] == "cpu"


def test_mcts_bench_batch_sweep_prints_its_table():
    out = _run("-m", "gymgo_tpu_torch.benchmarks.mcts_bench", "--cpu", "--board", "5", "--sims", "4", "--channels", "8",
               "--blocks", "1", "--repeats", "1", "--search", "gumbel", "--batch-sweep", "2,4")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "gumbel 5x5 4 sims (8ch x 1): batch sweep"
    rows = [ln.split("|")[1:-1] for ln in lines[3:]]
    assert [int(r[0]) for r in rows] == [2, 4] and rows[0][4].strip() == "1.00x"
    bad = _run("-m", "gymgo_tpu_torch.benchmarks.mcts_bench", "--cpu", "--batch-sweep", "2")
    assert bad.returncode != 0 and "one search" in bad.stderr
