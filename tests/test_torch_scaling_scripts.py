"""The port's scaling scripts on the CPU, as subprocesses, at 5x5: both modes
of ``scripts.scaling_proxy`` and ``scripts.multihost_bench`` on one rank and on
two gloo ranks.  Each run's JSON line holds every window's rate and the table
the script's docstring names.

Every process runs on one intra-op thread and every wait has a timeout; a
failure kills the ranks still running.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120
SMALL = ["--board", "5", "--steps", "4", "--device", "cpu"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(*argv):
    """Start ``python -m gymgo_tpu_torch.scripts.<argv>`` from the root."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return subprocess.Popen([sys.executable, "-m", *argv], cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _records(procs):
    """Each process's last JSON line (None when it prints none); fails on a
    non-zero exit, and kills whatever still runs."""
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            lines = [line for line in out.splitlines() if line.startswith("{")]
            results.append(json.loads(lines[-1]) if lines else None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


@pytest.mark.parametrize("mode", ["mesh", "procs"])
def test_scaling_proxy_prints_its_efficiency_table(mode):
    rec, = _records([_run("gymgo_tpu_torch.scripts.scaling_proxy", "--mode", mode, "--envs", "16",
                          "--warmup", "4", "--repeats", "2", *SMALL)])
    assert (rec["mode"], rec["board"], rec["total_envs"]) == (mode, 5, 16)
    for row in rec["rows"]:
        assert len(row["windows"]) == 2 and row["env_steps_per_sec"] == max(row["windows"]) > 0
    if mode == "mesh":
        assert [row["devices"] for row in rec["rows"]] == [1, 2, 4, 8]
        assert rec["rows"][0]["efficiency_vs_1dev"] == 1.0
    else:
        assert [row["processes"] for row in rec["rows"]] == [1, 2] and rec["total_devices"] == 4
        assert rec["efficiency_2proc_vs_1proc"] == rec["rows"][1]["env_steps_per_sec"] / \
            rec["rows"][0]["env_steps_per_sec"]


@pytest.mark.parametrize("ranks", [1, 2])
def test_multihost_bench_reports_every_rank_and_window(ranks):
    port = _free_port()
    dist = ["--coordinator", f"localhost:{port}", "--num-processes", str(ranks)] if ranks > 1 else []
    recs = _records([_run("gymgo_tpu_torch.scripts.multihost_bench", *dist, *(["--process-id", str(pid)]
                                                                             if ranks > 1 else []),
                          "--envs-per-host", "8", "--warmup-steps", "4", "--repeats", "3", *SMALL)
                     for pid in range(ranks)])
    rec = recs[0]
    assert recs[1:] == [None] * (ranks - 1)  # rank 0 alone prints
    assert (rec["hosts"], rec["envs"], rec["envs_per_host"], rec["device"]) == (ranks, 8 * ranks, 8, "cpu")
    assert len(rec["per_rank_env_steps_per_sec"]) == ranks
    assert all(len(windows) == 3 and min(windows) > 0 for windows in rec["per_rank_env_steps_per_sec"])
    assert len(rec["aggregate_env_steps_per_sec"]) == 3 and rec["aggregate_median"] > 0
