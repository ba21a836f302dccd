"""Two ranks on the CPU through gloo (the counterparts of
``tests/test_multiprocess.py`` and ``tests/test_fault_recovery.py``, and of
JAX's ``train_step`` on an env-sharded batch).

* ``scripts.multiproc_worker`` as 2 ranks of 4 logical shards each at 5x5,
  B = 16, 24 steps: both print the same checksums, equal to one process's
  unsharded rollout from the same seed.
* The segmented run with rank 1 killed after segment 0 and the job restarted
  from the checkpoint equals an uninterrupted segmented run.
* The data-parallel learner step (``tests/torch_dp_step.py``, 2 ranks of 24
  rows) against JAX's jitted ``train_step`` on the same 48 rows sharded over
  the 8 virtual devices, and against one port process on all 48: the masks
  differ between the halves, so a mean of per-rank losses would be wrong.
  Two AdamW steps agree within ``PARAM_ATOL`` (the learner test's 3-step
  tolerance: the gradients' sums round differently, and Adam moves each
  parameter by about the learning rate, 1e-3), and the gradients the ranks
  summed equal one process's within ``GRAD_RTOL`` of each tensor's largest.

Every worker runs on one intra-op thread and every wait has a timeout; a
failure kills the ranks still running.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.parallel import env_sharding as jenv_sharding
from gymgo_tpu.parallel import make_mesh as jmake_mesh
from gymgo_tpu.rl import learner as jlearner
from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core.state import batch_init_state
from gymgo_tpu_torch.env.batch_env import rollout
from gymgo_tpu_torch.rl import learner as tlearner
from gymgo_tpu_torch.utils.checkpoint import restore_npz, save_npz
from gymgo_tpu_torch.utils.faulttol import chunk_seed
from test_torch_learner import _batch, _state_dict
from test_torch_search import _nets

REPO = Path(__file__).resolve().parent.parent
BOARD, BATCH, STEPS, SEED, SEGMENTS = 5, 16, 24, 0, 2
TIMEOUT_S = 120
PARAM_ATOL = 2e-6
GRAD_RTOL = 1e-5
N_NET = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(argv):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return subprocess.Popen([sys.executable, *argv], cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(procs):
    """Every process's (returncode, stdout, stderr), each waited on with a
    timeout; any rank still running after a failure or a timeout is killed."""
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def _worker(pid, port, *extra):
    return _launch(["-m", "gymgo_tpu_torch.scripts.multiproc_worker", "--coordinator", f"localhost:{port}",
                    "--num-processes", "2", "--process-id", str(pid), "--local-devices", "4", "--device", "cpu",
                    "--board", str(BOARD), "--batch", str(BATCH), "--steps", str(STEPS), "--seed", str(SEED),
                    *extra])


def _line(out):
    return json.loads([l for l in out.splitlines() if l.startswith("{")][-1])


def _checksums(r):
    return {"state_checksum": int(r.final_states.sum(dtype=torch.int64)),
            "action_checksum": int(r.actions.sum(dtype=torch.int64)),
            "reward_checksum": float(r.rewards.double().sum())}


def _keys(o):
    return {k: o[k] for k in ("state_checksum", "action_checksum", "reward_checksum")}


def test_two_ranks_equal_one_process():
    port = _free_port()
    results = _finish([_worker(pid, port) for pid in (0, 1)])
    for rc, _, err in results:
        assert rc == 0, f"worker failed:\n{err[-3000:]}"
    outs = [_line(out) for _, out, _ in results]
    for o in outs:
        assert (o["process_count"], o["global_devices"], o["backend"]) == (2, 8, "gloo")
    assert _keys(outs[0]) == _keys(outs[1])
    cfg = EnvConfig(board_size=BOARD, batch_size=BATCH, auto_reset=True)
    r = rollout(torch.Generator().manual_seed(SEED), batch_init_state(BATCH, BOARD, device="cpu"), STEPS, cfg)
    assert _keys(outs[0]) == _checksums(r)


def test_kill_one_rank_and_restart_from_checkpoint(tmp_path):
    ckpt = str(tmp_path / "fault_ckpt.npz")
    seg = ["--num-segments", str(SEGMENTS), "--ckpt", ckpt]
    # phase 1: segment 0, then rank 1 dies without shutting down
    port = _free_port()
    p0 = _worker(0, port, *seg, "--start-segment", "0")
    p1 = _worker(1, port, *seg, "--start-segment", "0", "--crash-after-segment", "0")
    try:
        _, err1 = p1.communicate(timeout=TIMEOUT_S)
        assert p1.returncode == 1, f"rank 1 should crash, got {p1.returncode}:\n{err1[-2000:]}"
        assert os.path.exists(ckpt), "the checkpoint was not written before the crash"
        try:  # the survivor fails on its dead peer or waits on it: the supervisor ends it
            p0.wait(timeout=5)
        except subprocess.TimeoutExpired:
            pass
    finally:
        _finish([p0, p1])
    # phase 2: a fresh job resumes from the checkpoint
    port = _free_port()
    results = _finish([_worker(pid, port, *seg, "--start-segment", "1") for pid in (0, 1)])
    for rc, _, err in results:
        assert rc == 0, f"resumed worker failed:\n{err[-3000:]}"
    outs = [_line(out) for _, out, _ in results]
    assert _keys(outs[0]) == _keys(outs[1])
    # an uninterrupted segmented run in one process
    cfg = EnvConfig(board_size=BOARD, batch_size=BATCH, auto_reset=True)
    states = batch_init_state(BATCH, BOARD, device="cpu")
    for s in range(SEGMENTS):
        r = rollout(torch.Generator().manual_seed(chunk_seed(SEED, s)), states, STEPS // SEGMENTS, cfg)
        states = r.final_states
    assert _keys(outs[0]) == _checksums(r)


def _dp_batches():
    """Two 48-row batches whose masks differ between the halves."""
    batches = []
    for seed in (0, 1):
        obs, pi, v, _, _ = _batch(m=48, seed=seed)
        rng = np.random.default_rng(100 + seed)
        half = np.arange(48) < 24
        mask = rng.random(48) < np.where(half, 0.9, 0.3)
        vmask = mask & (rng.random(48) < np.where(half, 0.7, 0.2))
        batches.append((obs, pi, v, mask, vmask))
    return batches


def test_data_parallel_train_step_matches_jax_sharded_step(tmp_path):
    apply_fn, params, tnet = _nets(N_NET, seed=33)
    batches = _dp_batches()
    for _, _, _, mask, vmask in batches:
        assert mask[:24].sum() != mask[24:].sum() and vmask[:24].sum() != vmask[24:].sum()
    # JAX: one jitted step on the batch sharded over the 8 virtual devices
    jstate, tx = jlearner.make_train_state(params, learning_rate=1e-3)
    mesh = jmake_mesh()
    jstep = jax.jit(lambda s, b: jlearner.train_step(s, tx, apply_fn, b))
    jmetrics = []
    for batch in batches:
        sharded = tuple(jax.device_put(jnp.asarray(x), jenv_sharding(mesh, x.ndim)) for x in batch)
        jstate, jm = jstep(jstate, sharded)
        jmetrics.append({k: float(v) for k, v in jm.items()})
    want = _state_dict(jstate.params, tnet.config)
    # the port: two gloo ranks of 24 rows each
    inputs, out = tmp_path / "in.npz", tmp_path / "out.npz"
    save_npz(inputs, {"net": {k: v.detach() for k, v in tnet.state_dict().items()},
                      "batches": {str(i): dict(zip(("obs", "pi", "v", "mask", "vmask"), b))
                                  for i, b in enumerate(batches)}})
    port = _free_port()
    results = _finish([_launch([str(REPO / "tests" / "torch_dp_step.py"), "--coordinator", f"localhost:{port}",
                                "--num-processes", "2", "--process-id", str(pid), "--inputs", str(inputs),
                                "--out", str(out)]) for pid in (0, 1)])
    for rc, _, err in results:
        assert rc == 0, f"learner rank failed:\n{err[-3000:]}"
    tree = restore_npz(out)
    # the port in one process on the whole batch, step by step
    tnet.train()
    state = tlearner.make_train_state(tnet, learning_rate=1e-3)
    for i, batch in enumerate(batches):
        state, _ = tlearner.train_step(state, tuple(torch.from_numpy(np.array(x)) for x in batch))
        single = {k: v.detach().numpy() for k, v in tnet.state_dict().items()}
        for name, p in tnet.named_parameters():
            g = p.grad.numpy()
            np.testing.assert_allclose(tree["grads"][str(i)][name], g, rtol=0,
                                       atol=GRAD_RTOL * float(np.abs(g).max()), err_msg=f"step {i} grad {name}")
        got = tree["params"][str(i)]
        for name in single:
            np.testing.assert_allclose(got[name], single[name], rtol=0, atol=PARAM_ATOL, err_msg=f"step {i} {name}")
            if i == len(batches) - 1:
                np.testing.assert_allclose(got[name], want[name], rtol=0, atol=PARAM_ATOL, err_msg=name)
        for k, v in jmetrics[i].items():
            np.testing.assert_allclose(float(tree["metrics"][str(i)][k]), v, rtol=0, atol=1e-5, err_msg=k)
    start = _state_dict(params, tnet.config)
    assert max(float(np.abs(single[k] - start[k]).max()) for k in single) > 1e-3  # the parameters moved
