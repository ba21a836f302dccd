"""Boards over 32x32 on the minmax route: the port against the JAX package.

The min/max and claim floods' plain versions (the specifications of the hand
kernels, which label these boards a block a board) against JAX's
``flood_min_max_two_colors_unrolled`` and ``flood_or_unrolled`` up to
181x181, where both packages' int16 indices stop, and against a component
labelling by scipy; the area score; and minmax-route rollouts against the
JAX package run with ``GYMGO_FLOOD=unrolled`` in a subprocess.  Inputs are
made with numpy from a seed; every output is an integer or a bool, so they
must agree bit for bit.  The kernels' own tests, which need a card, are in
test_torch_cuda.py.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.core import flood as jflood
from gymgo_tpu.core import score as jscore
from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core import flood as tflood
from gymgo_tpu_torch.core import score as tscore
from gymgo_tpu_torch.env import batch_env as tenv
from test_torch_claim_flood import _jax_claims, _oracle_claims
from test_torch_components import oracle_minmax
from test_torch_minmax import _JAX_ROLLOUT
from torch_boards import adversarial_boards, component_boards, random_boards, states_on_boards

_REPO = Path(__file__).resolve().parent.parent
_SIZES = [33, 37, 64, 181]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and the plain floods' thousands of small rounds on the long
    chains gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _boards(n, family):
    if family == "random":
        return random_boards(np.random.default_rng(300 + n), 2 if n > 64 else 8, n)
    if family == "adversarial":
        return adversarial_boards(n)
    return component_boards(n)


@functools.partial(jax.jit, static_argnums=2)
def _jax_minmax(a, b, n):
    """JAX's minmax route's flood: the seeds of liberty_classes_from_minmax
    (gymgo_tpu/core/flood.py:364-370) through flood_min_max_two_colors_unrolled."""
    big = n * n
    empty = ~(a | b)
    idx = jnp.arange(big, dtype=jnp.int32).reshape(n, n)
    seed_min = jflood.neighbor_min(jnp.where(empty, idx, big), big)
    seed_max = jflood.neighbor_max(jnp.where(empty, idx, -1), -1)
    return jflood.flood_min_max_two_colors_unrolled(seed_min, seed_max, a, b, big)


@pytest.mark.parametrize("family", ["random", "adversarial"])
@pytest.mark.parametrize("n", _SIZES)
def test_plain_floods_match_jax_over_32x32(n, family):
    # board by board: a batch floods until its slowest board is done, and at 181x181 a
    # serpentine takes ~16,000 rounds
    for a, b in zip(*_boards(n, family)):
        a, b = a[None], b[None]
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        mn, mx = tflood.minmax_flood_plain(_t(a), _t(b))
        assert mn.dtype == mx.dtype == torch.int16
        # JAX returns its int32 seeds' type, the port the kernel's int16: the same values
        for j, t in zip(_jax_minmax(ja, jb, n), (mn, mx)):
            np.testing.assert_array_equal(np.asarray(j), t.numpy().astype(np.int32))
        claims = tflood.claim_flood_plain(_t(a), _t(b))
        np.testing.assert_array_equal(np.asarray(_jax_claims(ja, jb)), claims.numpy())


@pytest.mark.parametrize("family", ["random", "adversarial", "components"])
@pytest.mark.parametrize("n", [33, 64])
def test_plain_floods_are_reductions_over_components_over_32x32(n, family):
    a, b = _boards(n, family)
    want = [np.stack(w) for w in zip(*(oracle_minmax(x, y) for x, y in zip(a, b)))]
    for g, w in zip(tflood.minmax_flood_plain(_t(a), _t(b)), want):
        np.testing.assert_array_equal(g.numpy(), w)
    want = np.stack([_oracle_claims(x, y) for x, y in zip(a, b)])
    np.testing.assert_array_equal(tflood.claim_flood_plain(_t(a), _t(b)).numpy(), want)


@pytest.mark.parametrize("n", [37, 64])
def test_areas_over_32x32_match_jax(n):
    states = states_on_boards(n, 50 + n)
    want = jax.jit(jscore.areas)(jnp.asarray(states))
    got = tscore.areas(_t(states))
    for j, t in zip(want, got):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("n,b,steps", [(37, 4, 60), (64, 2, 40)])
def test_minmax_route_rollout_over_32x32_matches_jax_unrolled(n, b, steps, tmp_path):
    out = tmp_path / f"jax_unrolled_{n}.npz"
    env = dict(os.environ, GYMGO_FLOOD="unrolled", JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-c", _JAX_ROLLOUT, str(n), str(b), str(steps), str(out)],
                   cwd=_REPO, env=env, check=True, capture_output=True)
    ref = np.load(out)
    assert (ref["rewards"] != 0).any(), "the heuristic reward reads the claimed areas every step"
    cfg = EnvConfig(board_size=n, batch_size=b, reward_method="heuristic", auto_reset=True)
    acts = iter(torch.from_numpy(ref["actions"]))
    previous = tflood.set_flood_route("unrolled")
    try:
        t = tenv.rollout(torch.Generator().manual_seed(0), torch.zeros((b, 6, n, n), dtype=torch.int8),
                         steps, cfg, policy_fn=lambda _g, _s: next(acts))
    finally:
        tflood.set_flood_route(previous)
    for field in ("actions", "rewards", "dones", "final_states"):
        np.testing.assert_array_equal(ref[field], getattr(t, field).numpy(), err_msg=field)
    assert not t.invalid.any()


def test_both_packages_stop_at_182x182():
    # 181 * 181 = 32761 fits int16, 182 * 182 = 33124 does not
    n = 182
    a = np.zeros((1, n, n), bool)
    a[0, 0, 0] = True
    seed = jnp.zeros((1, n, n), jnp.int32)
    with pytest.raises(OverflowError):
        jflood.flood_min_max_two_colors_unrolled(seed, seed, jnp.asarray(a), jnp.asarray(~a), n * n)
    with pytest.raises(RuntimeError):
        tflood.minmax_flood_plain(_t(a), _t(~a))
