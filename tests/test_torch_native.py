"""gymgo_tpu_torch.native against gymgo_tpu.native and against the port's torch
``gogame`` on the CPU: random games at 5, 7, 9 and 19, single and batch
paths, states and areas bit for bit; the library is built under
``gymgo_tpu_torch/_build/``, and builders in several processes at once
leave one whole library."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gymgo_tpu.native import NativeGoEngine as JNativeGoEngine
from gymgo_tpu_torch import gogame as tgogame
from gymgo_tpu_torch import native as tnative
from gymgo_tpu_torch.native import NativeGoEngine, NativeUnavailable

_REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("size,seed,steps", [(5, 0, 60), (7, 1, 100), (9, 2, 120), (19, 0, 80)])
def test_random_games_match_jax_engine_and_torch_gogame(size, seed, steps):
    eng, jeng = NativeGoEngine(size), JNativeGoEngine(size)
    np.random.seed(seed)
    s = np.zeros((6, size, size), np.int8)
    for t in range(steps):
        if tgogame.game_ended(s):
            break
        a = int(tgogame.random_action(s))
        got, status = eng.next_state(s, a)
        want, jstatus = jeng.next_state(s, a)
        assert status == jstatus == 0
        assert got.dtype == np.int8 and np.array_equal(got, want), f"move {t}"
        torch_next, areas = tgogame._next_state_with_areas(s, a, device="cpu")
        assert np.array_equal(torch_next.astype(np.int8), got), f"move {t}"
        assert eng.areas(got) == jeng.areas(got) == areas
        s = got
    # an invalid move and a finished game give the same codes on both engines
    ended = s
    if not s[5].any():
        occupied = int(np.flatnonzero(s[:2].sum(0).ravel())[0])
        assert eng.next_state(s, occupied)[1] == jeng.next_state(s, occupied)[1] == 1
        ended, _ = eng.next_state(eng.next_state(s, size * size)[0], size * size)
    assert ended[5].all()
    out, status = eng.next_state(ended, 0)
    assert status == jeng.next_state(ended, 0)[1] == 2 and np.array_equal(out, ended)


@pytest.mark.parametrize("size,batch", [(5, 40), (7, 33), (9, 64), (19, 48)])
def test_batch_paths_match(size, batch):
    eng, jeng = NativeGoEngine(size), JNativeGoEngine(size)
    rng = np.random.default_rng(size)
    states = np.zeros((batch, 6, size, size), np.int8)
    for t in range(30):
        invd = states[:, 3].reshape(batch, -1)
        acts = np.array([rng.choice(np.append(np.flatnonzero(row == 0), size * size)) for row in invd])
        if t % 7 == 3:
            acts[0] = int(np.flatnonzero(invd[0])[0]) if invd[0].any() else acts[0]  # an invalid move
        out, status = eng.batch_next_states(states, acts)
        jout, jstatus = jeng.batch_next_states(states, acts)
        assert np.array_equal(out, jout) and np.array_equal(status, jstatus)
        ok = status == 0
        assert np.array_equal(out[ok], tgogame.batch_next_states(states[ok], acts[ok], device="cpu").astype(np.int8))
        states = np.where(ok[:, None, None, None], out, states)
        for i in range(0, batch, 11):
            single, st = eng.next_state(states[i], int(acts[i]))
            assert st == jeng.next_state(states[i], int(acts[i]))[1]
    ba, wa = eng.batch_areas(states)
    jba, jwa = jeng.batch_areas(states)
    tba, twa = tgogame.batch_areas(states, device="cpu")
    assert ba.dtype == np.int32 and np.array_equal(ba, jba) and np.array_equal(wa, jwa)
    assert np.array_equal(ba, tba) and np.array_equal(wa, twa)


def test_library_is_built_in_the_port_build_dir():
    NativeGoEngine(5)
    path = tnative.library_path()
    assert path.is_file() and path.parent == _REPO / "gymgo_tpu_torch" / "_build"
    # the JAX package's engine, line for line but for one comment that names where the reference lay
    ours = tnative.SOURCE.read_text().splitlines()
    theirs = (_REPO / "gymgo_tpu" / "native" / "go_engine.cc").read_text().splitlines()
    assert len(ours) == len(theirs)
    assert [i for i, (a, b) in enumerate(zip(ours, theirs)) if a != b] == [1] and ours[1].startswith("//")
    assert NativeGoEngine.max_threads() >= 1
    with pytest.raises(ValueError):
        NativeGoEngine(33)
    assert issubclass(NativeUnavailable, RuntimeError)


_BUILD_AND_STEP = """
import sys
from pathlib import Path
import numpy as np
from gymgo_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
eng = native.NativeGoEngine(5)
s, status = eng.next_state(np.zeros((6, 5, 5), np.int8), 12)
print(status, int(s[0].sum()), eng.max_threads())
"""


def test_builders_in_several_processes_leave_one_whole_library(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_STEP, str(tmp_path)], cwd=_REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env={**os.environ, "GYMGO_NATIVE_THREADS": "2"})
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-500:] for _, err in outs]
    assert [out.split() for out, _ in outs] == [["0", "1", "2"]] * 4  # GYMGO_NATIVE_THREADS=2 is read
    assert [p.name for p in tmp_path.iterdir()] == [tnative.library_path().name]
