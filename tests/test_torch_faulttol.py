"""gymgo_tpu_torch.utils.faulttol: the cases of ``tests/test_faulttol.py`` on
the port's copy (ledger, fault injection, supervisor), the torch device
probe (True for the CPU, False without a card), and the helpers the port's
tools share: ``chunk_seed``, ``child_argv``, ``default_state_file``."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from gymgo_tpu.utils import faulttol as jfaulttol
from gymgo_tpu_torch.utils import faulttol

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_ledger_roundtrip(tmp_path):
    path = str(tmp_path / "state.jsonl")
    assert faulttol.load_ledger(path) == {}
    faulttol.append_chunk(path, "0", {"wins": 3})
    faulttol.append_chunk(path, "i1-j2-c0", {"wins": 1})
    led = faulttol.load_ledger(path)
    assert led["0"]["wins"] == 3
    assert led["i1-j2-c0"]["wins"] == 1
    assert led == jfaulttol.load_ledger(path)  # one ledger format for both packages


def test_ledger_tolerates_torn_final_line(tmp_path):
    path = str(tmp_path / "state.jsonl")
    faulttol.append_chunk(path, "0", {"wins": 3})
    with open(path, "a") as f:
        f.write('{"chunk": "1", "wi')  # crash mid-append
    led = faulttol.load_ledger(path)
    assert set(led) == {"0"}


def test_ledger_redo_overwrites(tmp_path):
    path = str(tmp_path / "state.jsonl")
    faulttol.append_chunk(path, "0", {"wins": 1})
    faulttol.append_chunk(path, "0", {"wins": 2})
    assert faulttol.load_ledger(path)["0"]["wins"] == 2


FAKE_CHILD = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    from gymgo_tpu_torch.utils import faulttol
    state = sys.argv[1]
    led = faulttol.load_ledger(state)
    for i in range(3):
        if str(i) in led:
            continue
        faulttol.append_chunk(state, str(i), {{"wins": i * 10}})
""")


def _write_child(tmp_path):
    child = tmp_path / "fake_child.py"
    child.write_text(FAKE_CHILD.format(repo=REPO))
    return str(child)


def test_supervise_recovers_from_one_crash(tmp_path, monkeypatch):
    state = str(tmp_path / "state.jsonl")
    marker = str(tmp_path / "crashed.marker")
    child = _write_child(tmp_path)
    monkeypatch.setenv(faulttol.CRASH_AT_ENV, "1")
    monkeypatch.setenv(faulttol.CRASH_MARKER_ENV, marker)
    assert (faulttol.CRASH_AT_ENV, faulttol.CRASH_MARKER_ENV) == (jfaulttol.CRASH_AT_ENV, jfaulttol.CRASH_MARKER_ENV)
    probes = []
    monkeypatch.setattr(faulttol, "wait_for_device",
                        lambda *a, **k: probes.append(1) or True)
    led = faulttol.supervise(
        [sys.executable, child, state], state,
        expected_chunks=["0", "1", "2"], max_retries=2)
    assert os.path.exists(marker), "injected crash never fired"
    assert probes == [1], "supervisor should probe exactly once"
    assert {k: v["wins"] for k, v in led.items()} == {
        "0": 0, "1": 10, "2": 20}


def test_supervise_gives_up_after_retries(tmp_path, monkeypatch):
    state = str(tmp_path / "state.jsonl")
    child = _write_child(tmp_path)
    # crash every time: marker env unset -> maybe_crash always fires
    monkeypatch.setenv(faulttol.CRASH_AT_ENV, "1")
    monkeypatch.delenv(faulttol.CRASH_MARKER_ENV, raising=False)
    monkeypatch.setattr(faulttol, "wait_for_device", lambda *a, **k: True)
    with pytest.raises(RuntimeError, match="incomplete"):
        faulttol.supervise(
            [sys.executable, child, state], state,
            expected_chunks=["0", "1", "2"], max_retries=1)
    # chunk 0 completed before every crash; never lost
    assert faulttol.load_ledger(state)["0"]["wins"] == 0


def test_supervise_aborts_when_device_stays_down(tmp_path, monkeypatch):
    state = str(tmp_path / "state.jsonl")
    child = _write_child(tmp_path)
    monkeypatch.setenv(faulttol.CRASH_AT_ENV, "1")
    monkeypatch.delenv(faulttol.CRASH_MARKER_ENV, raising=False)
    monkeypatch.setattr(faulttol, "wait_for_device", lambda *a, **k: False)
    with pytest.raises(RuntimeError, match="unreachable"):
        faulttol.supervise(
            [sys.executable, child, state], state,
            expected_chunks=["0", "1", "2"], max_retries=3)


def test_maybe_crash_ignores_other_chunks(monkeypatch):
    monkeypatch.setenv(faulttol.CRASH_AT_ENV, "7")
    faulttol.maybe_crash("3")  # must not exit


def test_probe_device_cpu():
    assert faulttol.probe_device(timeout_s=120.0, cpu=True)


def test_probe_device_without_a_card_is_false():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert not faulttol.probe_device(timeout_s=120.0)


def test_probe_device_timeout():
    # a probe that can never finish in time reports unreachable
    assert not faulttol.probe_device(timeout_s=0.001, cpu=True)


def test_wait_for_device_polls_until_the_deadline(monkeypatch):
    answers, logged = [False, False, True], []
    monkeypatch.setattr(faulttol, "probe_device", lambda *a, **k: answers.pop(0))
    assert faulttol.wait_for_device(max_wait_s=60, interval_s=0, log=lambda *a, **k: logged.append(a))
    assert answers == [] and len(logged) == 4
    monkeypatch.setattr(faulttol, "probe_device", lambda *a, **k: False)
    assert not faulttol.wait_for_device(max_wait_s=0, interval_s=0, log=lambda *a, **k: None)


def test_chunk_seed_depends_on_seed_and_key_alone():
    seeds = {faulttol.chunk_seed(s, k) for s in (0, 1, 42) for k in ("0", "1", "i0-j1-c0", "i0-j1-c1")}
    assert len(seeds) == 12 and all(0 <= s < 1 << 63 for s in seeds)
    assert faulttol.chunk_seed(42, "1") == faulttol.chunk_seed(42, "1")
    # the same value in a fresh interpreter: no hash randomization in it
    code = "from gymgo_tpu_torch.utils import faulttol; print(faulttol.chunk_seed(42, 'i0-j1-c1'))"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True)
    assert int(out.stdout) == faulttol.chunk_seed(42, "i0-j1-c1")


def test_child_argv_and_default_state_file(tmp_path, monkeypatch):
    argv = ["--ckpt", "a.npz", "--retries", "3", "--state-file=x.jsonl", "--games", "8", "--retries=1"]
    child = faulttol.child_argv("gymgo_tpu_torch.scripts.eval_ckpt", argv, "s.jsonl")
    assert child == [sys.executable, "-m", "gymgo_tpu_torch.scripts.eval_ckpt", "--ckpt", "a.npz", "--games", "8",
                     "--retries", "0", "--state-file", "s.jsonl"]
    monkeypatch.chdir(tmp_path)
    a, b = faulttol.default_state_file("evalstate", argv), faulttol.default_state_file("evalstate", argv[:2])
    assert a.startswith("logs/evalstate_") and a.endswith(".jsonl") and a != b
    assert (tmp_path / "logs").is_dir()
