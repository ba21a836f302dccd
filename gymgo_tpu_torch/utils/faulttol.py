"""Fault-tolerant chunked execution for long eval jobs (counterpart of
``gymgo_tpu.utils.faulttol``, a copy apart from the device probe and
``chunk_seed``).

A worker process can die mid-eval (a device fault, a killed job), and a
multi-hour eval must survive the crash of any one chunk.

This module provides the missing layer:

- a **chunk ledger** (JSON-lines state file): each completed chunk's
  result is appended immediately, so a crash loses at most the in-flight
  chunk.  Chunk keys are caller-chosen strings (e.g. ``"3"`` or
  ``"i0-j2-c1"``) and a chunk's generator must be seeded from the key
  string (``chunk_seed``), never carried across chunks, so a re-run
  reproduces the exact same game set.
- a **device probe** (fresh subprocess, hard timeout) that answers "is
  the backend usable right now?" without risking the caller's process.
- a **supervisor** that re-runs a child command until its ledger is
  complete, waiting for the device between attempts with bounded retries.
  It imports no torch, so a wedged device cannot hang it.

Fault injection for tests: set ``GYMGO_EVAL_CRASH_AT_CHUNK=<key>`` and
``GYMGO_EVAL_CRASH_MARKER=<path>`` in the child's environment; the first
time the child is about to record that chunk it creates the marker file
and dies with SIGKILL-style ``os._exit(137)`` instead.  Because the
marker persists, the relaunched child completes normally — simulating a
one-off worker kill.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

CRASH_AT_ENV = "GYMGO_EVAL_CRASH_AT_CHUNK"
CRASH_MARKER_ENV = "GYMGO_EVAL_CRASH_MARKER"


# ---------------------------------------------------------------- ledger

def chunk_seed(seed: int, chunk_key: str) -> int:
    """A 63-bit generator seed from ``(seed, chunk_key)`` alone, so a redone
    chunk replays the same games (the counterpart of JAX's
    ``fold_in(PRNGKey(seed), chunk)``)."""
    digest = hashlib.sha256(f"{int(seed)}:{chunk_key}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def load_ledger(path: str) -> Dict[str, dict]:
    """Read a JSONL chunk ledger -> {chunk_key: result_dict}.

    Tolerates a truncated final line (the crash may interrupt a write);
    later entries for the same key win (a redo overwrites).
    """
    out: Dict[str, dict] = {}
    if not path or not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn write from a crash mid-append
            if isinstance(rec, dict) and "chunk" in rec:
                out[str(rec["chunk"])] = rec
    return out


def append_chunk(path: str, chunk_key: str, result: dict) -> None:
    """Append one completed chunk, honoring the test fault injection."""
    maybe_crash(chunk_key)
    rec = dict(result)
    rec["chunk"] = str(chunk_key)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())


def maybe_crash(chunk_key: str) -> None:
    """Die like a killed worker if fault injection targets this chunk."""
    target = os.environ.get(CRASH_AT_ENV)
    if target is None or str(chunk_key) != target:
        return
    marker = os.environ.get(CRASH_MARKER_ENV)
    if marker:
        if os.path.exists(marker):
            return  # already crashed once; behave this time
        with open(marker, "w") as f:
            f.write("crashed\n")
    sys.stderr.write(f"[faulttol] injected crash at chunk {chunk_key}\n")
    sys.stderr.flush()
    os._exit(137)


# ---------------------------------------------------------------- probe

def probe_device(timeout_s: float = 240.0, cpu: bool = False) -> bool:
    """True iff a FRESH process can use the device within timeout_s.

    Runs in a subprocess so a wedged device hangs the probe child, not the
    supervisor.  With ``cpu`` the child only imports torch; otherwise it
    needs a CUDA card and a one-element tensor's round trip through it.
    """
    code = "import torch; "
    if not cpu:
        code += ("assert torch.cuda.device_count() > 0; "
                 "x = torch.ones(1, device='cuda'); assert float(x.cpu()[0]) == 1.0; ")
    code += "print(torch.cuda.device_count())"
    try:
        r = subprocess.run(
            [sys.executable, "-c", code],
            timeout=timeout_s,
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
        )
    except subprocess.TimeoutExpired:
        return False
    return r.returncode == 0


def wait_for_device(
    max_wait_s: float = 1200.0,
    probe_timeout_s: float = 240.0,
    interval_s: float = 60.0,
    cpu: bool = False,
    log=print,
) -> bool:
    """Poll probe_device until it succeeds or max_wait_s elapses.

    A device can need minutes after a killed job: probe gently (one probe
    and a sleep per cycle), never hammer.
    """
    deadline = time.monotonic() + max_wait_s
    attempt = 0
    while True:
        attempt += 1
        log(f"[faulttol] device probe attempt {attempt}...", flush=True)
        if probe_device(probe_timeout_s, cpu=cpu):
            log("[faulttol] device reachable", flush=True)
            return True
        if time.monotonic() >= deadline:
            log("[faulttol] device still unreachable; giving up", flush=True)
            return False
        time.sleep(interval_s)


# ------------------------------------------------------------ supervisor

def child_argv(module: str, argv: List[str], state_file: str) -> List[str]:
    """A supervised child's command line: ``python -m module`` with ``argv``
    less ``--retries`` / ``--state-file``, run bare (``--retries 0``) against
    ``state_file``."""
    child = [sys.executable, "-m", module]
    skip_next = False
    for a in argv:
        if skip_next:
            skip_next = False
            continue
        if a in ("--retries", "--state-file"):
            skip_next = True
            continue
        if a.startswith(("--retries=", "--state-file=")):
            continue
        child.append(a)
    return child + ["--retries", "0", "--state-file", state_file]


def default_state_file(prefix: str, argv: List[str]) -> str:
    """``logs/<prefix>_<hash of argv>.jsonl`` under the working directory: the
    same command line resumes the same ledger."""
    tag = hashlib.sha1(" ".join(argv).encode()).hexdigest()[:12]
    os.makedirs("logs", exist_ok=True)
    return f"logs/{prefix}_{tag}.jsonl"


def supervise(
    child_argv: List[str],
    state_file: str,
    expected_chunks: List[str],
    max_retries: int = 3,
    child_timeout_s: Optional[float] = None,
    recovery_max_wait_s: float = 1200.0,
    probe_timeout_s: float = 240.0,
    cpu_probe: bool = False,
    log=print,
) -> Dict[str, dict]:
    """Run ``child_argv`` until the ledger holds every expected chunk.

    The child is expected to read ``state_file``, skip chunks already
    recorded there, and append each chunk as it completes (the child modes
    of ``scripts.eval_ckpt`` and ``scripts.elo_ladder`` do exactly this).  On child failure —
    nonzero exit, signal death, or ``child_timeout_s`` overrun — the
    supervisor waits for the device to become reachable again, then
    relaunches.  Each relaunch costs one retry; completed chunks are
    never redone, so one flake costs one chunk's work plus a restart.

    Returns the final ledger.  Raises RuntimeError if retries run out
    with the ledger still incomplete.
    """
    want = [str(c) for c in expected_chunks]
    attempts = 0
    while True:
        ledger = load_ledger(state_file)
        missing = [c for c in want if c not in ledger]
        if not missing:
            return ledger
        if attempts > max_retries:
            raise RuntimeError(
                f"eval incomplete after {attempts} attempts; "
                f"missing chunks {missing} (ledger: {state_file})"
            )
        attempts += 1
        log(f"[faulttol] attempt {attempts}: {len(missing)} chunk(s) "
            f"to go ({missing[:6]}{'...' if len(missing) > 6 else ''})",
            flush=True)
        try:
            r = subprocess.run(child_argv, timeout=child_timeout_s)
            rc = r.returncode
        except subprocess.TimeoutExpired:
            log("[faulttol] child timed out; killing", flush=True)
            rc = -1
        if rc == 0:
            continue  # loop re-checks the ledger; exits if complete
        log(f"[faulttol] child died (rc={rc}); probing device before "
            f"relaunch", flush=True)
        if not wait_for_device(recovery_max_wait_s, probe_timeout_s,
                               cpu=cpu_probe, log=log):
            raise RuntimeError(
                "device unreachable after crash; aborting eval "
                f"(completed chunks preserved in {state_file})"
            )
