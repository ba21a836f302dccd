"""The step of gymgo_tpu_torch on boards over 22x22 against the JAX package.

With no switch set, ``core.flood``'s size rule sends boards over 22x22 to the
minmax route.  ``step_states`` and ``step_planes``, with and without the
carried planes, at 23, 25 and 32 against JAX's step run with
``GYMGO_FLOOD=unrolled`` in a subprocess (JAX picks its route at import), on
hand-made boards (some groups stand without a liberty) and the injected
actions of test_torch_step.py: every field of the state and of ``StepInfo``,
bit for bit, step after step.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gymgo_tpu_torch.core import flood as tflood
from gymgo_tpu_torch.core import step as tstep
from test_torch_step import _random_actions
from torch_boards import states_on_boards

_REPO = Path(__file__).resolve().parent.parent
_BIG = (23, 25, 32)
_BIG_PATHS = ("step_states", "step_planes_carried", "step_planes_stateless")
_BIG_STEPS = 2
_JAX_BIG_STEPS = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from gymgo_tpu.core import flood, step
assert step.flood_bundle is flood.flood_bundle_from_parts, "not the minmax route"


@jax.jit
def run(states, actions):  # every path's steps in one compilation a board size
    plain = step.planes_from_states(states)
    starts = {"step_states": states, "step_planes_stateless": plain,
              "step_planes_carried": plain._replace(atari=step.init_atari(plain), ko_surr=step.init_ko_surr(plain))}
    res = {}
    for path, x in starts.items():
        fn = step.step_states if path == "step_states" else step.step_planes
        for t in range(actions.shape[0]):
            x, info = fn(x, actions[t])
            res[path, t] = x, info
    return res


inp, out = np.load(sys.argv[1]), {}
for n in map(int, sys.argv[3:]):
    res = run(jnp.asarray(inp[f"{n}.states"]), jnp.asarray(inp[f"{n}.actions"]))
    for (path, t), (x, info) in res.items():
        for part, tree in (("state", x), ("info", info)):
            for field, v in (tree._asdict().items() if hasattr(tree, "_asdict") else [("states", tree)]):
                if v is not None:
                    out[f"{n}.{path}.{t}.{part}.{field}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and the plain floods' many small rounds gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_big_steps(tmp_path_factory):
    """Inputs at each of ``_BIG`` (hand-made boards, ``_BIG_STEPS`` rows of
    actions) and JAX's outputs on them under ``GYMGO_FLOOD=unrolled``, from
    one subprocess."""
    tmp = tmp_path_factory.mktemp("jax_big_steps")
    inputs = {}
    for n in _BIG:
        states = states_on_boards(n, 40 + n)[::4]
        rng = np.random.default_rng(n)
        inputs[f"{n}.states"] = states
        inputs[f"{n}.actions"] = np.stack([_random_actions(rng, states) for _ in range(_BIG_STEPS)])
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, GYMGO_FLOOD="unrolled", JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    subprocess.run([sys.executable, "-c", _JAX_BIG_STEPS, str(tmp / "in.npz"), str(tmp / "out.npz"),
                    *map(str, _BIG)], cwd=_REPO, env=env, check=True, capture_output=True)
    return inputs, np.load(tmp / "out.npz")


@pytest.mark.parametrize("path", _BIG_PATHS)
@pytest.mark.parametrize("n", _BIG)
def test_steps_over_22x22_match_jax_unrolled(n, path, jax_big_steps):
    """No switch set: the size rule sends these boards to the minmax route,
    and ``step_states`` and ``step_planes``, with and without the carried
    planes, equal JAX's minmax-route step on every field, step after step."""
    assert not tflood.bundle_fits(n)
    inputs, ref = jax_big_steps
    states = torch.from_numpy(inputs[f"{n}.states"])
    x = {"step_states": lambda: states, "step_planes_carried": lambda: tstep.seed_planes(states),
         "step_planes_stateless": lambda: tstep.planes_from_states(states)}[path]()
    fn = tstep.step_states if path == "step_states" else tstep.step_planes
    for t, acts in enumerate(inputs[f"{n}.actions"]):
        x, info = fn(x, torch.from_numpy(acts))
        for part, tree in (("state", x), ("info", info)):
            for field, v in (tree._asdict().items() if hasattr(tree, "_asdict") else [("states", tree)]):
                key = f"{n}.{path}.{t}.{part}.{field}"
                if v is None:
                    assert key not in ref.files, key
                    continue
                want = ref[key]
                assert want.dtype == v.numpy().dtype, (key, want.dtype, v.dtype)
                np.testing.assert_array_equal(want, v.numpy(), err_msg=key)
    captured = sum(int(ref[f"{n}.{path}.{t}.info.num_captured"].sum()) for t in range(_BIG_STEPS))
    assert captured > 0
